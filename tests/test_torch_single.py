"""B4 and the single-model path of the port against the JAX reference.

The same seeded numpy inputs go through the reference (``repro.kernels.
streamsvm_fit`` with its Pallas kernel in interpret mode, the row-at-a-time
oracle ``repro.kernels.ref.streamsvm_scan_ref``, and ``repro.core``) and
through the port on the CPU, which runs B4's plain version. Tolerances:
rtol 2e-4 / atol 2e-5 on ``w`` (f32 sums in another order), rtol 1e-4 on
``r``, rtol 1e-3 / atol 1e-6 on ``xi2``; core-vector counts ``m`` exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fit as jfit
from repro.core import fit_ball as jfit_ball
from repro.core import fit_c_grid as jfit_c_grid
from repro.core import fit_chunked as jfit_chunked
from repro.core import fit_ovr as jfit_ovr
from repro.core import init_ball as jinit_ball
from repro.core.meb import Ball as JBall
from repro.core.qp import solve_meb_ball_points as jsolve
from repro.data import chunk_stream
from repro.kernels import streamsvm_fit as jstreamsvm_fit
from repro.kernels.ref import streamsvm_scan_ref
from repro_torch.convert import ball_from_numpy, ball_to_numpy
from repro_torch.core import (
    StreamCheckpoint,
    fit,
    fit_ball,
    fit_c_grid,
    fit_chunked,
    fit_ovr,
    init_ball,
    solve_meb_ball_points,
)
from repro_torch.kernels import streamsvm_fit
from repro_torch.kernels.streamsvm_scan import streamsvm_scan, streamsvm_scan_plain

CPU = torch.device("cpu")


def _data(n, d, seed, sign0=0.0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = np.sign(rng.normal(size=n)).astype(np.float32)
    if sign0:
        y[rng.random(n) < sign0] = 0.0
        y[0] = 1.0
    return X, y


def _assert_ball_close(port, ref):
    w, r, xi2, m = ball_to_numpy(port)
    rw, rr, rxi2, rm = (np.asarray(a) for a in ref)
    np.testing.assert_allclose(w, rw, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(r, rr, rtol=1e-4)
    np.testing.assert_allclose(xi2, rxi2, rtol=1e-3, atol=1e-6)
    np.testing.assert_array_equal(m, rm)


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("n,d,block_n", [
    (64, 16, 32),
    (500, 100, 128),
    (1000, 300, 256),
    (257, 129, 64),  # unaligned
])
def test_streamsvm_fit_matches_jax_kernel_and_oracle(n, d, block_n):
    rng = np.random.default_rng(n + d)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = np.sign(rng.normal(size=n)).astype(np.float32)
    port = streamsvm_fit(_t(X), _t(y), 7.0, block_n=block_n)
    _assert_ball_close(port, jstreamsvm_fit(jnp.asarray(X), jnp.asarray(y), 7.0, block_n=block_n))
    ref = streamsvm_scan_ref(
        jnp.asarray(X[1:]), jnp.asarray(y[1:]), jnp.asarray(y[0] * X[0]), 0.0, 1.0 / 7.0,
        1.0 / 7.0, 1,
    )
    _assert_ball_close(port, ref)


def test_streamsvm_fit_continues_from_a_ball():
    X, y = _data(512, 64, seed=5)
    half = streamsvm_fit(_t(X[:256]), _t(y[:256]), 5.0, block_n=64)
    rest = streamsvm_fit(_t(X[256:]), _t(y[256:]), 5.0, half, block_n=64)
    jhalf = jstreamsvm_fit(jnp.asarray(X[:256]), jnp.asarray(y[:256]), 5.0, block_n=64)
    jrest = jstreamsvm_fit(jnp.asarray(X[256:]), jnp.asarray(y[256:]), 5.0, jhalf, block_n=64)
    _assert_ball_close(rest, jrest)
    full = streamsvm_fit(_t(X), _t(y), 5.0, block_n=64)
    np.testing.assert_array_equal(rest.m.numpy(), full.m.numpy())


def test_sign0_rows_are_inert_and_a_zero_row_is_a_point():
    X, y = _data(300, 24, seed=9, sign0=0.1)
    X[40] = 0.0
    port = streamsvm_fit(_t(X), _t(y), 2.0, block_n=64)
    ref = streamsvm_scan_ref(
        jnp.asarray(X[1:]), jnp.asarray(y[1:]), jnp.asarray(y[0] * X[0]), 0.0, 0.5, 0.5, 1
    )
    _assert_ball_close(port, ref)
    keep = y != 0
    keep[0] = True
    without = streamsvm_fit(_t(X[keep]), _t(y[keep]), 2.0, block_n=64)
    np.testing.assert_array_equal(port.m.numpy(), without.m.numpy())
    torch.testing.assert_close(port.w, without.w, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("variant", ["exact", "paper-listing"])
def test_fit_and_fit_ball_match_repro_core(variant):
    X, y = _data(777, 90, seed=0)
    _assert_ball_close(fit(_t(X), _t(y), 3.0, variant=variant),
                       jfit(jnp.asarray(X), jnp.asarray(y), 3.0, variant=variant))
    start = init_ball(_t(X[0]), _t(y[0]), 3.0, variant=variant)
    jstart = jinit_ball(jnp.asarray(X[0]), jnp.asarray(y[0]), 3.0, variant=variant)
    _assert_ball_close(start, jstart)
    mid = fit_ball(start, _t(X[1:400]), _t(y[1:400]), 3.0, variant=variant)
    jmid = jfit_ball(jstart, jnp.asarray(X[1:400]), jnp.asarray(y[1:400]), 3.0, variant=variant)
    _assert_ball_close(mid, jmid)
    end = fit_ball(mid, _t(X[400:]), _t(y[400:]), 3.0, variant=variant)
    _assert_ball_close(end, jfit_ball(jmid, jnp.asarray(X[400:]), jnp.asarray(y[400:]), 3.0,
                                      variant=variant))


def test_fit_ball_takes_a_zero_label_row_as_the_zero_point():
    """The reference's fit_ball scans every row as the point y x, so y = 0 is
    the zero point, not an inert row."""
    X, y = _data(200, 6, seed=3)
    y[[20, 21, 22]] = 0.0
    start = init_ball(_t(X[0]), _t(y[0]), 0.5)
    jstart = jinit_ball(jnp.asarray(X[0]), jnp.asarray(y[0]), 0.5)
    _assert_ball_close(fit_ball(start, _t(X[1:]), _t(y[1:]), 0.5),
                       jfit_ball(jstart, jnp.asarray(X[1:]), jnp.asarray(y[1:]), 0.5))


@pytest.mark.parametrize("n_valid", [4, 2, 0])
def test_qp_solver_matches_its_jax_twin(n_valid):
    rng = np.random.default_rng(n_valid)
    L, d = 6, 20
    pts = rng.normal(size=(L, d)).astype(np.float32)
    valid = np.arange(L) < n_valid
    w = rng.normal(size=d).astype(np.float32)
    port = solve_meb_ball_points(ball_from_numpy((w, 0.7, 0.1, 5), device="cpu"), _t(pts),
                                 _t(valid), 0.1)
    ref = jsolve(JBall(jnp.asarray(w), jnp.float32(0.7), jnp.float32(0.1), jnp.int32(5)),
                 jnp.asarray(pts), jnp.asarray(valid), 0.1)
    _assert_ball_close(port, ref)


@pytest.mark.parametrize("lookahead", [1, 6])
def test_fit_chunked_matches_repro_core(lookahead):
    X, y = _data(1000, 20, seed=lookahead)
    port = fit_chunked(chunk_stream(X, y, 300), 4.0, lookahead=lookahead, device="cpu")
    ref = jfit_chunked(chunk_stream(X, y, 300), 4.0, lookahead=lookahead)
    assert port.position == ref.position == 1000
    _assert_ball_close(port.ball, ref.ball)


@pytest.mark.parametrize("lookahead", [1, 4])
def test_fit_chunked_checkpoints_and_resumes(lookahead):
    X, y = _data(900, 12, seed=8)
    seen = []
    full = fit_chunked(chunk_stream(X, y, 300), 2.0, lookahead=lookahead, device="cpu",
                       checkpoint_every=300, checkpoint_cb=seen.append)
    assert [c.position for c in seen] == [300, 600, 900]
    resumed = fit_chunked(chunk_stream(X, y, 300, start=300), 2.0, lookahead=lookahead,
                          resume=StreamCheckpoint(seen[0].ball, seen[0].position))
    assert resumed.position == 900
    for a, b in zip(full.ball, resumed.ball):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="empty stream"):
        fit_chunked(iter(()), 2.0, device="cpu")


@pytest.mark.parametrize("lookahead", [1, 5])
def test_fit_ovr_scan_engine_matches_repro(lookahead):
    rng = np.random.default_rng(31)
    proto = rng.normal(size=(4, 10)) * 3
    labels = rng.integers(0, 4, size=300)
    X = (rng.normal(size=(300, 10)) + proto[labels]).astype(np.float32)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    port = fit_ovr(_t(X), _t(labels), 4, 10.0, lookahead=lookahead, engine="scan")
    ref = jfit_ovr(jnp.asarray(X), jnp.asarray(labels), 4, 10.0, lookahead=lookahead,
                   engine="scan")
    _assert_ball_close(port, ref)


def test_fit_c_grid_scan_engine_matches_repro_and_the_bank():
    X, y = _data(400, 16, seed=12)
    grid = np.asarray([0.5, 5.0, 50.0], np.float32)
    port = fit_c_grid(_t(X), _t(y), _t(grid), engine="scan")
    _assert_ball_close(port, jfit_c_grid(jnp.asarray(X), jnp.asarray(y), jnp.asarray(grid),
                                         engine="scan"))
    bank = fit_c_grid(_t(X), _t(y), _t(grid))  # the pallas engine, kernel B1
    torch.testing.assert_close(port.w, bank.w, rtol=2e-4, atol=2e-5)
    assert torch.equal(port.m, bank.m)


def test_kernel_wrapper_runs_plain_version_on_cpu():
    """On a CPU tensor the B4 wrapper is the plain version and counts no launch."""
    X, y = _data(128, 8, seed=4)
    args = (_t(X[1:]), _t(y[1:]), _t(y[0] * X[0]), 0.0, 0.25, 0.25, 1, 0.25)
    before = streamsvm_scan.launches
    a = streamsvm_scan(*args, n_valid=127, block_n=127)
    b = streamsvm_scan_plain(*args, n_valid=127, block_n=127)
    assert streamsvm_scan.launches == before
    for x, z in zip(a, b):
        assert torch.equal(x, z)


def test_bad_arguments_raise():
    X, y = _data(20, 4, seed=1)
    with pytest.raises(ValueError, match="y must be"):
        streamsvm_fit(_t(X), _t(y[:10]), 1.0)
    with pytest.raises(ValueError, match="variant"):
        fit(_t(X), _t(y), 1.0, variant="nope")
    with pytest.raises(ValueError, match="engine"):
        fit_ovr(_t(X), _t(np.zeros(20, np.int64)), 2, 1.0, engine="nope")
    with pytest.raises(ValueError, match="multiple of block_n"):
        streamsvm_scan_plain(_t(X), _t(y), _t(X[0]), 0.0, 1.0, 1.0, 1, 1.0, n_valid=20,
                             block_n=8)


def test_without_cuda_a_call_without_device_cpu_raises():
    """device=None means CUDA; on a machine without it a numpy call raises."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device works here")
    X, y = _data(20, 4, seed=1)
    with pytest.raises((AssertionError, RuntimeError)):
        fit(X, y, 1.0)
    assert fit(_t(X), _t(y), 1.0).w.device == CPU  # CPU tensors: CPU


@pytest.mark.parametrize("n,d,c,seed", [
    (20, 1, 0.1, 11),
    (57, 3, 1.0, 202),
    (120, 8, 10.0, 3033),
    (200, 16, 100.0, 4044),
    (199, 5, 10.0, 5055),
])
def test_fit_explicit_is_the_references_and_fit_matches_it(n, d, c, seed):
    """core.oracle.fit_explicit (the float64 augmented-space simulator,
    copied) gives the reference copy's numbers, and the port's fit (B4's
    plain version here) reproduces it as the reference's fit does."""
    from repro.core.oracle import fit_explicit as jfit_explicit
    from repro_torch.core.oracle import fit_explicit

    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = np.sign(rng.normal(size=n) + X[:, 0]).astype(np.float32)
    y[y == 0] = 1
    for variant in ("exact", "paper-listing"):
        ref, want = fit_explicit(X, y, c, variant=variant), jfit_explicit(X, y, c, variant=variant)
        for key in ("w", "r", "xi2", "m", "sigma"):
            np.testing.assert_array_equal(ref[key], want[key])
    ref = fit_explicit(X, y, c, variant="exact")
    ball = fit(X, y, c, device="cpu")
    np.testing.assert_allclose(ball.w.numpy(), ref["w"], rtol=2e-4, atol=2e-5)
    assert abs(float(ball.r) - ref["r"]) < 1e-3 * max(1.0, ref["r"])
    assert abs(float(ball.xi2) - ref["xi2"]) < 1e-3 * max(1.0, ref["xi2"])
    assert int(ball.m) == ref["m"]
