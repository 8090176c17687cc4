"""The port's runtime (``repro_torch.runtime``) against the reference's
(``repro.runtime``) on the CPU.

The pure policies (``rebalance_ranges`` flat and grouped,
``StragglerPolicy``, ``RetryPolicy.delay``) give the reference's outputs
exactly. ``run_with_restarts`` over a torch step is bit-equivalent to the
uninterrupted run and to the reference's run of the same step in JAX, with
the same metrics. The classifier names torch's device-fault classes and
imports no ``jaxlib``; ``torch.OutOfMemoryError`` is not retryable, and a
test pins that decision.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.live import ArraySource, LiveBank, run_live_with_restarts
from repro_torch.runtime import (
    DeviceLostError,
    InjectedFailure,
    RetryPolicy,
    RunReport,
    StragglerPolicy,
    default_live_retryable,
    rebalance_ranges,
    remesh_state,
    run_with_restarts,
    runtime_device_errors,
)

_NOSLEEP = lambda s: None

RANGE_CASES = [
    ([(0, 97), (97, 200), (200, 311), (311, 400), (400, 500)], [1, 3]),
    ([(0, 100), (100, 200), (200, 300), (300, 400)], [1, 3]),
    ([(0, 10), (10, 20), (20, 25)], [0]),
    ([(0, 7), (7, 14), (14, 14)], [2]),  # an empty dead range
    ([(0, 5), (5, 10), (10, 15), (15, 20), (20, 24)], [4, 0, 2]),
    ([(0, 3), (3, 6), (6, 9)], [1]),  # a range narrower than the survivors
]

ELAPSED_CASES = [
    (3.0, [1.0, 1.1, 0.9, 10.0]),
    (3.0, [1.0, 1.1, 0.9]),
    (3.0, [1.0, 10.0, 2.0, 3.0]),
    (3.0, [1.0, 9.0, 2.0, 3.0]),
    (3.0, [9.001, 1.0, 2.0, 3.0]),
    (1.0, [5.0] * 3),
    (3.0, []),
    (3.0, [0.0, 0.0, 1e-6]),
    (2.0, [0.8, 1.2, 12.0, 1.0, 0.9]),
]


def test_exported_names_match_the_reference():
    import repro.runtime as ref

    import repro_torch.runtime as port

    assert sorted(port.__all__) == sorted(ref.__all__)
    for name in ref.__all__:
        assert hasattr(port, name), name


@pytest.mark.parametrize("ranges,dead", RANGE_CASES)
@pytest.mark.parametrize("grouped", [False, True])
def test_rebalance_ranges_match_the_reference(ranges, dead, grouped):
    from repro.runtime import rebalance_ranges as ref_rebalance

    want = ref_rebalance(ranges, dead, grouped=grouped)
    assert rebalance_ranges(ranges, dead, grouped=grouped) == want
    # the dead set's order and container never change the queues
    assert rebalance_ranges(ranges, set(dead), grouped=grouped) == want
    assert rebalance_ranges(ranges, iter(sorted(dead, reverse=True)), grouped=grouped) == want


def test_rebalance_ranges_all_dead_raises():
    with pytest.raises(ValueError, match="no survivors"):
        rebalance_ranges([(0, 10), (10, 20)], dead=[0, 1])
    with pytest.raises(ValueError, match="no survivors"):
        rebalance_ranges([(0, 10), (10, 20)], dead=[0, 1], grouped=True)


@pytest.mark.parametrize("factor,elapsed", ELAPSED_CASES)
def test_straggler_policy_matches_the_reference(factor, elapsed):
    from repro.runtime import StragglerPolicy as RefPolicy

    assert (StragglerPolicy(deadline_factor=factor).stragglers(elapsed)
            == RefPolicy(deadline_factor=factor).stragglers(elapsed))


@pytest.mark.parametrize("base,cap", [(0.05, 2.0), (0.1, 0.5), (0.05, 0.12), (1e-3, 1.0)])
def test_retry_policy_delay_matches_the_reference(base, cap):
    from repro.runtime import RetryPolicy as RefPolicy

    port, ref = RetryPolicy(backoff_base=base, backoff_cap=cap), RefPolicy(backoff_base=base,
                                                                          backoff_cap=cap)
    assert [port.delay(a) for a in range(12)] == [ref.delay(a) for a in range(12)]
    assert (port.max_retries, port.backoff_base, port.backoff_cap) == (
        ref.max_retries, ref.backoff_base, ref.backoff_cap)


def test_retry_policy_classification():
    pol = RetryPolicy(retryable=(OSError,), backoff_base=0.1, backoff_cap=0.5)
    assert [pol.delay(a) for a in range(4)] == [0.1, 0.2, 0.4, 0.5]
    assert pol.is_retryable(OSError("blip"))
    assert pol.is_retryable(FileNotFoundError("subclass counts"))
    assert not pol.is_retryable(ValueError("bug"))
    assert RetryPolicy().is_retryable(InjectedFailure("default"))


# ---------------------------------------------------------------------------
# run_with_restarts
# ---------------------------------------------------------------------------


def _step(state, batch):
    w = state["w"] + torch.sum(batch)
    return {"w": w, "n": state["n"] + 1}, {"w_sum": float(torch.sum(w))}


def _batches(n=10):
    return [torch.full((4,), float(i)) for i in range(n)]


def _init():
    return {"w": torch.zeros(4), "n": torch.zeros((), dtype=torch.int32)}


@pytest.mark.parametrize("ckpt_every,fail_at", [(2, [3, 7]), (4, [3, 7]), (3, [1, 2, 9]),
                                                (100, [10])])
def test_restart_bit_equivalent_with_the_same_metrics(tmp_path, ckpt_every, fail_at):
    """Crashes after a step and before its commit: the final state equals
    the uninterrupted run's bit for bit, the metrics entry for entry, and
    both equal the reference's run of the same step in JAX."""
    import jax.numpy as jnp
    from repro.runtime import run_with_restarts as ref_run

    clean, clean_report = run_with_restarts(
        _step, _init(), _batches(), ckpt_dir=str(tmp_path / "a"), ckpt_every=ckpt_every)
    crashy, report = run_with_restarts(
        _step, _init(), _batches(), ckpt_dir=str(tmp_path / "b"), ckpt_every=ckpt_every,
        fail_at=fail_at, sleep=_NOSLEEP)
    assert report.restarts == len(fail_at)
    assert isinstance(report, RunReport) and report.steps_done == 10
    assert torch.equal(clean["w"], crashy["w"]) and int(crashy["n"]) == 10
    assert crashy["w"].dtype == torch.float32 and crashy["n"].dtype == torch.int32
    assert report.metrics == clean_report.metrics and len(report.metrics) == 10

    def ref_step(state, batch):
        w = state["w"] + jnp.sum(batch)
        return {"w": w, "n": state["n"] + 1}, {"w_sum": float(jnp.sum(w))}

    ref_state, ref_report = ref_run(
        ref_step, {"w": jnp.zeros((4,)), "n": jnp.zeros((), jnp.int32)},
        [jnp.full((4,), i, jnp.float32) for i in range(10)], ckpt_dir=str(tmp_path / "r"),
        ckpt_every=ckpt_every, fail_at=fail_at, sleep=_NOSLEEP)
    np.testing.assert_array_equal(crashy["w"].numpy(), np.asarray(ref_state["w"]))
    assert report.metrics == ref_report.metrics
    assert report.restarts == ref_report.restarts


def test_run_with_restarts_retries_declared_transients(tmp_path):
    calls = {"n": 0}

    def flaky_step(state, batch):
        calls["n"] += 1
        if calls["n"] == 3:
            raise OSError("transient fs blip")
        return _step(state, batch)

    delays = []
    state, report = run_with_restarts(
        flaky_step, _init(), _batches(6), ckpt_dir=str(tmp_path / "a"), ckpt_every=2,
        retryable=(InjectedFailure, OSError), sleep=delays.append)
    assert report.restarts == 1 and delays == [0.05]
    clean, _ = run_with_restarts(_step, _init(), _batches(6), ckpt_dir=str(tmp_path / "b"),
                                 ckpt_every=2)
    assert torch.equal(state["w"], clean["w"]) and int(state["n"]) == 6


def test_run_with_restarts_programming_error_propagates(tmp_path):
    def bad_step(state, batch):
        raise ValueError("shape mismatch — a bug, not infrastructure")

    delays = []
    with pytest.raises(ValueError, match="a bug"):
        run_with_restarts(bad_step, _init(), _batches(6), ckpt_dir=str(tmp_path / "a"),
                          sleep=delays.append)
    assert delays == []


def test_run_with_restarts_backoff_capped_exponential(tmp_path):
    delays = []
    _, report = run_with_restarts(
        _step, _init(), _batches(), ckpt_dir=str(tmp_path / "a"), ckpt_every=100,
        fail_at=[2, 4, 6, 8], backoff_base=0.05, backoff_cap=0.12, sleep=delays.append)
    assert report.restarts == 4
    assert delays == [0.05, 0.1, 0.12, 0.12]


def test_run_with_restarts_places_the_restored_state(tmp_path):
    """``device=`` is the restore target's placement (the reference's
    ``shardings=``); the resumed state lives there with its dtypes."""
    seen = []

    def step(state, batch):
        seen.append(state["w"].device)
        return _step(state, batch)

    state, report = run_with_restarts(step, _init(), _batches(4), ckpt_dir=str(tmp_path / "a"),
                                      ckpt_every=1, fail_at=[2], device="cpu", sleep=_NOSLEEP)
    assert report.restarts == 1 and all(d.type == "cpu" for d in seen)
    assert state["n"].dtype == torch.int32 and int(state["n"]) == 4


def test_remesh_state_restores_onto_the_named_device(tmp_path):
    tree = {"a": torch.arange(6.0).reshape(2, 3), "b": [torch.ones(2, dtype=torch.int32)]}
    ckpt.save(str(tmp_path / "c"), tree, meta={"step": 1})
    target = {"a": torch.zeros(2, 3), "b": [torch.zeros(2, dtype=torch.int32)]}
    calls = []

    def sharding_fn(t, mesh):
        calls.append(mesh)
        return torch.device("cpu")

    out = remesh_state(str(tmp_path / "c"), target, "new-mesh", sharding_fn)
    assert calls == ["new-mesh"]
    assert torch.equal(out["a"], tree["a"]) and torch.equal(out["b"][0], tree["b"][0])
    assert out["b"][0].dtype == torch.int32


# ---------------------------------------------------------------------------
# device-error classification and the OOM decision
# ---------------------------------------------------------------------------


def test_runtime_device_errors_name_torchs_classes():
    errs = runtime_device_errors()
    assert torch.AcceleratorError in errs and torch.cuda.CudaError in errs
    assert len(set(errs)) == len(errs)
    retryable = default_live_retryable()
    assert retryable[:2] == (InjectedFailure, DeviceLostError)
    assert set(errs) <= set(retryable)
    assert issubclass(DeviceLostError, RuntimeError) and issubclass(InjectedFailure, RuntimeError)
    pol = RetryPolicy(retryable=retryable)
    assert pol.is_retryable(torch.AcceleratorError("CUDA error: an illegal memory access"))
    assert pol.is_retryable(DeviceLostError("shard 3 gone"))
    assert not pol.is_retryable(ValueError("a bug"))
    assert not pol.is_retryable(RuntimeError("a launch the card refused"))


def test_runtime_imports_no_jax():
    """The port's runtime and live loop import nothing of JAX (a fresh
    interpreter: this test process has JAX loaded for the references)."""
    code = ("import sys; import repro_torch.runtime, repro_torch.live; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'));"
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env={**os.environ, "PYTHONPATH": "src"})
    assert out.returncode == 0, out.stdout + out.stderr


def test_out_of_memory_is_not_retryable():
    """The decision, pinned: an allocation that failed at given sizes fails
    again at the same sizes after a resume, so torch.OutOfMemoryError is not
    a device fault to restart for."""
    assert issubclass(torch.OutOfMemoryError, RuntimeError)
    assert not issubclass(torch.OutOfMemoryError, torch.AcceleratorError)
    oom = torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
    assert not RetryPolicy(retryable=default_live_retryable()).is_retryable(oom)
    assert torch.OutOfMemoryError not in runtime_device_errors()


def _live(ckpt_dir, source):
    return LiveBank(source, np.asarray([1.0, 4.0], np.float32), ckpt_dir=str(ckpt_dir),
                    n_sub_banks=2, rotate_every=3, swap_every=2, sleep=_NOSLEEP, device="cpu")


def _live_stream():
    rng = np.random.default_rng(5)
    X = rng.normal(size=(6 * 16, 4)).astype(np.float32)
    y = np.sign(rng.normal(size=X.shape[0]) + X[:, 0]).astype(np.float32)
    y[y == 0] = 1.0
    return X, y


@pytest.mark.parametrize("exc,restarts", [
    (torch.AcceleratorError("CUDA error: unspecified launch failure"), 1),
    (DeviceLostError("device lost"), 1),
    (torch.OutOfMemoryError("CUDA out of memory"), None),
])
def test_live_restarts_classify_device_errors(tmp_path, exc, restarts):
    """A fetch that dies once with a device fault burns one restart under
    run_live_with_restarts' default policy and ends bit-identical to the
    clean run; an out-of-memory error propagates with no restart."""
    X, y = _live_stream()
    clean = _live(tmp_path / "a", ArraySource(X, y, 16))
    ref_stats = clean.run()
    inner, state = ArraySource(X, y, 16), {"raised": False}

    def dying_source(i):
        if i == 3 and not state["raised"]:
            state["raised"] = True
            raise exc
        return inner(i)

    crashy = _live(tmp_path / "b", dying_source)
    if restarts is None:
        with pytest.raises(torch.OutOfMemoryError):
            run_live_with_restarts(crashy, sleep=_NOSLEEP)
        assert crashy.stats.restarts == 0
        return
    stats = run_live_with_restarts(crashy, sleep=_NOSLEEP)
    # the fetch policy does not retry device faults in place: they escalate
    # to a restart from the durable checkpoint
    assert stats.restarts == restarts and stats.retries == 0
    assert stats.durable() == ref_stats.durable()
    for a, b in zip(crashy.serving_bank(), clean.serving_bank()):
        assert torch.equal(a, b)
