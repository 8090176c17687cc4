"""B1 in the port: ops.streamsvm_fit_many against the JAX reference.

The same seeded numpy inputs go through ``repro.kernels.ops.
streamsvm_fit_many`` (Pallas in interpret mode), the row-at-a-time oracle
``repro.kernels.ref.streamsvm_scan_many_ref`` and the port on the CPU,
which runs B1's plain version. Floats agree within the repo's engine
tolerance (f32 sums are reordered); core-vector counts ``m`` exactly.
Within the port, the bank's tiling must not change a bit.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.ref import streamsvm_scan_many_ref
from repro_torch.convert import ball_from_numpy, ball_to_numpy
from repro_torch.core import fit_bank
from repro_torch.kernels import ops
from repro_torch.kernels.streamsvm_scan import (
    SCAN_SMEM,
    SMALL_BANK_MAX_LIVE,
    SMEM_PER_BLOCK,
    resident_smem,
    scan_plan,
    small_smem,
    streamsvm_scan_lookahead_many,
    streamsvm_scan_lookahead_many_plain,
    streamsvm_scan_many,
    streamsvm_scan_many_plain,
)

CPU = torch.device("cpu")


def _bank_data(b, n, d, seed, sign0=0.0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    Y = np.sign(rng.normal(size=(b, n))).astype(np.float32)
    if sign0:
        Y[rng.random((b, n)) < sign0] = 0.0
        Y[:, 0] = np.where(Y[:, 0] == 0, 1.0, Y[:, 0])  # row 0 seeds every model
    cs = np.exp(rng.uniform(-1, 4, size=b)).astype(np.float32)
    return X, Y, cs


def _assert_bank_close(port, ref):
    w, r, xi2, m = ball_to_numpy(port)
    rw, rr, rxi2, rm = (np.asarray(a) for a in ref)
    np.testing.assert_allclose(w, rw, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(r, rr, rtol=1e-4)
    np.testing.assert_allclose(xi2, rxi2, rtol=1e-3, atol=1e-6)
    np.testing.assert_array_equal(m, rm)


def _port_fit(X, Y, cs, balls=None, **kw):
    return ops.streamsvm_fit_many(X, Y, cs, balls, device="cpu", **kw)


@pytest.mark.parametrize("b,n,d,block_n,b_tile,sign0", [
    (13, 300, 20, 64, 8, 0.0),     # ragged B (padded lanes), ragged N
    (24, 200, 40, 256, 8, 0.1),    # N < block_n, sign-0 rows
    (8, 257, 33, 64, None, 0.05),  # one tile, odd D
])
def test_fit_many_matches_jax_engine(b, n, d, block_n, b_tile, sign0):
    X, Y, cs = _bank_data(b, n, d, seed=b * n + d, sign0=sign0)
    ref = jops.streamsvm_fit_many(
        jnp.asarray(X), jnp.asarray(Y), jnp.asarray(cs), block_n=block_n, b_tile=b_tile
    )
    port = _port_fit(X, Y, cs, block_n=block_n, b_tile=b_tile)
    _assert_bank_close(port, ref)


@pytest.mark.parametrize("b,n,d,block_n,variant", [
    (5, 130, 7, 32, "exact"),
    (11, 400, 24, 128, "exact"),
    (9, 250, 16, 64, "paper-listing"),
])
def test_fit_many_matches_row_oracle(b, n, d, block_n, variant):
    X, Y, cs = _bank_data(b, n, d, seed=7 * b + n, sign0=0.03)
    c_inv = 1.0 / cs
    gain = c_inv if variant == "exact" else np.ones_like(c_inv)
    ref = streamsvm_scan_many_ref(
        jnp.asarray(X[1:]), jnp.asarray(Y[:, 1:]), jnp.asarray(Y[:, :1] * X[:1]),
        0.0, jnp.asarray(gain), jnp.asarray(c_inv), 1, gain=jnp.asarray(gain),
    )
    port = _port_fit(X, Y, cs, block_n=block_n, b_tile=8, variant=variant)
    _assert_bank_close(port, ref)


def test_paper_listing_matches_jax_engine():
    X, Y, cs = _bank_data(6, 180, 12, seed=3)
    ref = jops.streamsvm_fit_many(
        jnp.asarray(X), jnp.asarray(Y), jnp.asarray(cs), variant="paper-listing", block_n=64
    )
    _assert_bank_close(_port_fit(X, Y, cs, variant="paper-listing", block_n=64), ref)


def test_continue_from_balls_matches_jax_engine():
    X, Y, cs = _bank_data(10, 400, 18, seed=11, sign0=0.05)
    first = jops.streamsvm_fit_many(jnp.asarray(X[:150]), jnp.asarray(Y[:, :150]),
                                    jnp.asarray(cs), block_n=64, b_tile=8)
    ref = jops.streamsvm_fit_many(jnp.asarray(X[150:]), jnp.asarray(Y[:, 150:]),
                                  jnp.asarray(cs), first, block_n=64, b_tile=8)
    start = ball_from_numpy(first, device="cpu")
    port = _port_fit(X[150:], Y[:, 150:], cs, start, block_n=64, b_tile=8)
    _assert_bank_close(port, ref)


@pytest.mark.parametrize("with_balls", [False, True])
def test_empty_stream_returns_seed_state(with_balls):
    X, Y, cs = _bank_data(4, 1 if not with_balls else 5, 6, seed=2)
    if with_balls:
        start = _port_fit(X, Y, cs, block_n=32)
        out = _port_fit(X[:0], Y[:, :0], cs, start)
        for a, b in zip(out, start):
            assert torch.equal(a, b)
        return
    out = _port_fit(X, Y, cs)
    ref = jops.streamsvm_fit_many(jnp.asarray(X), jnp.asarray(Y), jnp.asarray(cs))
    _assert_bank_close(out, ref)
    assert out.m.dtype == torch.int32


def test_bf16_stream_matches_jax_engine():
    X, Y, cs = _bank_data(12, 300, 24, seed=5)
    ref = jops.streamsvm_fit_many(jnp.asarray(X), jnp.asarray(Y), jnp.asarray(cs),
                                  block_n=64, b_tile=8, stream_dtype="bf16")
    port = _port_fit(X, Y, cs, block_n=64, b_tile=8, stream_dtype="bf16")
    assert port.w.dtype == torch.float32
    _assert_bank_close(port, ref)


@pytest.mark.parametrize("b,n,d,block_n", [(40, 300, 20, 64), (13, 257, 9, 128)])
def test_b_tile_does_not_change_a_bit(b, n, d, block_n):
    X, Y, cs = _bank_data(b, n, d, seed=b + n, sign0=0.05)
    fits = [_port_fit(X, Y, cs, block_n=block_n, b_tile=bt) for bt in (8, 16, 64)]
    for other in fits[1:]:
        for a, c in zip(fits[0], other):
            assert torch.equal(a, c)


def test_sign0_rows_are_inert():
    """A row whose sign is 0 for a model changes nothing for that model."""
    X, Y, cs = _bank_data(6, 200, 10, seed=9)
    Yz = Y.copy()
    Yz[:, 50:90] = 0.0
    with_rows = _port_fit(X, Yz, cs, block_n=64)
    keep = np.r_[0:50, 90:200]
    without = _port_fit(X[keep], Y[:, keep], cs, block_n=64)
    for a, b in zip(with_rows, without):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-5)


def test_kernel_wrapper_runs_plain_version_on_cpu():
    """On a CPU tensor the wrapper is the plain version and counts no launch."""
    X, Y, cs = _bank_data(8, 128, 8, seed=4)
    t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt)
    args = (t(X[1:]), t(Y[:, 1:]), t(Y[:, :1] * X[:1]), t(np.zeros(8)), t(1 / cs),
            t(1 / cs), t(np.ones(8), torch.int32), t(1 / cs))
    before = streamsvm_scan_many.launches
    a = streamsvm_scan_many(*args, n_valid=127, block_n=127)
    b = streamsvm_scan_many_plain(*args, n_valid=127, block_n=127)
    assert streamsvm_scan_many.launches == before
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("kw,what", [
    pytest.param(dict(variant="lookahead", mesh=object()), "DeviceMesh", id="kw0-A10"),
    (dict(variant="lookahead-paper", lookahead=3, bank_resident="hbm"), None),
    (dict(bank_resident="hbm"), None),
    pytest.param(dict(mesh=object()), "DeviceMesh", id="kw3-A10"),
])
def test_unported_options_raise(kw, what):
    """mesh= takes a torch.distributed DeviceMesh (A10, ported) and raises
    TypeError on anything else; bank_resident="hbm" (B6, the ring) runs and
    gives the bits of "vmem"."""
    X, Y, cs = _bank_data(4, 20, 4, seed=1)
    if what is not None:
        with pytest.raises(TypeError, match=what):
            fit_bank(X, Y, cs, device="cpu", **kw)
        return
    hbm = fit_bank(X, Y, cs, device="cpu", **kw)
    vmem = fit_bank(X, Y, cs, device="cpu", **dict(kw, bank_resident="vmem"))
    for a, b in zip(hbm, vmem):
        assert torch.equal(a, b)


def test_bad_arguments_raise():
    X, Y, cs = _bank_data(4, 20, 4, seed=1)
    with pytest.raises(ValueError, match="variant"):
        _port_fit(X, Y, cs, variant="nope")
    with pytest.raises(ValueError, match="Y must be"):
        _port_fit(X, Y[:, :10], cs)
    with pytest.raises(ValueError, match="stream_dtype"):
        _port_fit(X, Y, cs, stream_dtype="fp8")


def test_without_cuda_a_call_without_device_cpu_raises():
    """device=None means CUDA; on a machine without it the call raises."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device works here")
    X, Y, cs = _bank_data(4, 20, 4, seed=1)
    with pytest.raises((AssertionError, RuntimeError)):
        fit_bank(X, Y, cs)
    out = fit_bank(torch.from_numpy(X), torch.from_numpy(Y), cs)  # CPU tensors: CPU
    assert out.w.device == CPU


# ---------------------------------------------------------------------------
# B1's and B3's layouts on the card (scan_plan) and their byte models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bp,d,lookahead_max,n_live,want", [
    (640, 784, None, None, ("resident", 8, 80, None)),      # phase 3's chunk
    (1536, 4096, None, None, ("resident", 8, 192, None)),   # 7b's launch
    (1536, 8192, None, None, ("resident", 4, 384, None)),   # 8 models' tiles do not fit
    (8, 12_288, None, None, ("chunked", 8, 1, None)),        # no tile fits
    (8, 784, 10, 1, ("small", 1, 1, "smem")),                # Fig 3's launch
    (8, 784, 50, 1, ("small", 1, 1, "smem")),                # Fig 3 at L = 50 (157 KB window)
    (8, 4096, 50, 1, ("small", 1, 1, "device")),             # the window does not fit
    (640, 784, 10, 600, ("resident", 8, 80, "device")),      # 4b's bank
    (1536, 4096, 10, 1536, ("resident", 8, 192, "device")),  # 7b's Algorithm 2
    (136, 784, 10, 132, ("small", 1, 132, "smem")),          # the switch, small side
    (136, 784, 10, 133, ("resident", 8, 17, "device")),      # ... and the bank side
    (144, 12_288, 3, 140, ("chunked", 8, 18, "device")),     # past both
    (8, 60_000, 2, 1, ("chunked", 8, 1, "device")),          # not even one row fits
])
def test_scan_plan_picks_the_layout(bp, d, lookahead_max, n_live, want):
    plan = scan_plan(bp, d, lookahead_max=lookahead_max, n_live=n_live)
    assert (plan["layout"], plan["models_per_cta"], plan["ctas"], plan["window"]) == want
    assert sum(plan["smem"].values()) <= SMEM_PER_BLOCK


_FLOOR = sum(SCAN_SMEM.values())  # the chunked kernels: 25,888 B whatever B and D


@pytest.mark.parametrize("bp,d,lookahead_max,n_live,budget,want", [
    # B1 at phase 3's chunk: 8 models (64,032 B), 4 (50,960 B), chunked.
    (640, 784, None, None, 64_032, ("resident", 8, None)),
    (640, 784, None, None, 64_031, ("resident", 4, None)),
    (640, 784, None, None, 50_960, ("resident", 4, None)),
    (640, 784, None, None, 50_959, ("chunked", 8, None)),
    (640, 784, None, None, _FLOOR, ("chunked", 8, None)),
    (640, 784, None, None, 1_000, ("chunked", 8, None)),  # below the floor: ops refuses
    # B3 at 4b's bank: 8 models (65,024 B), 4, chunked.
    (640, 784, 10, 600, 65_024, ("resident", 8, "device")),
    (640, 784, 10, 600, 65_023, ("resident", 4, "device")),
    (640, 784, 10, 600, 40_000, ("chunked", 8, "device")),
    # B3 at Fig 3's launch: the window in shared memory (72,704 B), in
    # device memory (41,344 B), then the chunked kernel.
    (8, 784, 10, 1, 72_704, ("small", 1, "smem")),
    (8, 784, 10, 1, 72_703, ("small", 1, "device")),
    (8, 784, 10, 1, 41_344, ("small", 1, "device")),
    (8, 784, 10, 1, 41_343, ("chunked", 8, "device")),
    # A budget past the card's limit is capped at it.
    (1536, 8192, None, None, 10**9, ("resident", 4, None)),
])
def test_scan_plan_holds_the_layout_to_the_budget(bp, d, lookahead_max, n_live, budget, want):
    """Each layout is taken only where it fits ``smem_budget`` (8 models per
    CTA, then 4, then the chunked kernels; B3's small layout first, its
    window in shared memory where that fits), as ring_plan holds the
    ring's owned slots to it."""
    plan = scan_plan(bp, d, lookahead_max=lookahead_max, n_live=n_live, smem_budget=budget)
    assert (plan["layout"], plan["models_per_cta"], plan["window"]) == want
    assert sum(plan["smem"].values()) <= max(min(budget, SMEM_PER_BLOCK), _FLOOR)


@pytest.mark.parametrize("kw", [dict(n_live=0), dict(n_live=9)])
def test_scan_plan_refuses_bad_arguments(kw):
    with pytest.raises(ValueError, match="n_live"):
        scan_plan(8, 64, lookahead_max=4, **kw)


def test_byte_models_of_each_layout():
    """Each term as the kernels lay out their dynamic shared memory: two
    (32, 128 + one 16-byte copy) stream chunks staged raw, w rows rounded
    up to 8 floats."""
    assert resident_smem(784, 8, lookahead=False) == {
        "stream_chunks": 2 * 32 * 132 * 4, "bank_tile": 8 * 784 * 4, "block_gram": 4_096,
        "h_alpha": 8 * 32 * 4, "row_state": 8 * 4}
    assert sum(resident_smem(784, 8, lookahead=False).values()) == 64_032
    assert resident_smem(784, 8, lookahead=True)["row_state"] == 8 * 32 * 4
    assert resident_smem(20, 4, lookahead=False, dtype=torch.bfloat16) == {
        "stream_chunks": 2 * 32 * 136 * 2, "bank_tile": 4 * 24 * 4, "block_gram": 4_096,
        "h_alpha": 4 * 32 * 4, "row_state": 4 * 4}
    assert sum(resident_smem(4096, 8, lookahead=False).values()) == 170_016
    assert small_smem(784, 10, window_in_smem=True) == {
        "stream_chunks": 33_792, "w_row": 3_136, "block_gram": 4_096,
        "row_state": (32 + 16 + 32) * 4, "window": 10 * 784 * 4}
    assert small_smem(784, 10, window_in_smem=False)["window"] == 0
    assert sum(small_smem(784, 50, window_in_smem=True).values()) == 198_144
    assert scan_plan(8, 64, smem_budget=_FLOOR)["smem"] == SCAN_SMEM


@pytest.mark.parametrize("b", [1, 8, 600, 1536])
@pytest.mark.parametrize("d", [784, 4096, 8192])
@pytest.mark.parametrize("lookahead_max", [None, 10])
def test_auto_resolves_to_vmem_at_the_default_budget(b, d, lookahead_max):
    """Every layout fits the card, so "auto" stays "vmem" at the default
    budget whatever B and D, as before the resident layout; the byte model
    is the plan of the padded bank with b live models."""
    model = lambda res: ops.engine_vmem_bytes(b, d, lookahead_max=lookahead_max,
                                              bank_resident=res)
    res, by = ops.resolve_bank_resident("auto", model, vmem_budget=ops.DEFAULT_VMEM_BUDGET_BYTES,
                                        what="t", shapes="s")
    assert res == "vmem"
    assert by == scan_plan(-(-b // 8) * 8, d, lookahead_max=lookahead_max, n_live=b)["smem"]
    small = lookahead_max is not None and b <= SMALL_BANK_MAX_LIVE
    assert scan_plan(-(-b // 8) * 8, d, lookahead_max=lookahead_max,
                     n_live=b)["layout"] == ("small" if small else "resident")


@pytest.mark.parametrize("budget", [None, 60_000, _FLOOR])
def test_any_budget_runs_the_plain_version_on_the_cpu(budget):
    """On a CPU tensor the budget and the live count change nothing: the
    wrapper is the plain version."""
    X, Y, cs = _bank_data(13, 200, 12, seed=6, sign0=0.05)
    bp = 16
    Yp = np.zeros((bp, 200), np.float32)
    Yp[:13] = Y
    live = np.arange(bp) < 13
    c_inv = np.where(live, 1 / np.pad(cs, (0, 3), constant_values=1.0), 1.0)
    t = lambda a, dt=torch.float32: torch.as_tensor(np.ascontiguousarray(a), dtype=dt)
    args = (t(X[1:]), t(Yp[:, 1:]), t(Yp[:, :1] * X[:1]), t(np.where(live, 0.0, np.inf)),
            t(c_inv), t(c_inv), t(np.ones(bp), torch.int32), t(c_inv))
    L = torch.tensor([3] * 13 + [1] * 3, dtype=torch.int32)
    kw = dict(lookahead=L, lookahead_max=3, n_valid=199, block_n=199)
    got = streamsvm_scan_lookahead_many(*args, **kw, n_live=13, smem_budget=budget)
    for a, c in zip(got, streamsvm_scan_lookahead_many_plain(*args, **kw)):
        assert torch.equal(a, c)
    got = streamsvm_scan_many(*args, n_valid=199, block_n=199, smem_budget=budget)
    for a, c in zip(got, streamsvm_scan_many_plain(*args, n_valid=199, block_n=199)):
        assert torch.equal(a, c)


@pytest.mark.parametrize("budget", [_FLOOR, 40_000, 50_000, 64_031])
@pytest.mark.parametrize("lookahead_max", [None, 10])
def test_vmem_runs_under_every_budget_the_chunked_kernels_fit(budget, lookahead_max):
    """A budget between the chunked kernels' 25,888 B and the resident
    tile's bytes: the byte model is the smaller layout's, so a forced "vmem"
    passes the preflight and "auto" stays "vmem", as before the resident
    layout; one byte under the floor, "auto" takes the ring and a forced
    "vmem" is refused."""
    model = lambda res, by=budget: ops.engine_vmem_bytes(
        600, 784, lookahead_max=lookahead_max, bank_resident=res, smem_budget=by)
    for policy in ("vmem", "auto"):
        res, by = ops.resolve_bank_resident(policy, model, vmem_budget=budget, what="t",
                                            shapes="s")
        assert res == "vmem" and sum(by.values()) <= budget
    under = lambda res: model(res, _FLOOR - 1)
    res, _ = ops.resolve_bank_resident("auto", under, vmem_budget=_FLOOR - 1, what="t",
                                       shapes="s")
    assert res == "hbm"
    with pytest.raises(ValueError, match="exceeding the budget"):
        ops.resolve_bank_resident("vmem", under, vmem_budget=_FLOOR - 1, what="t", shapes="s")


@pytest.mark.parametrize("variant", ["exact", "lookahead"])
def test_fit_at_a_squeezed_budget_stays_on_the_vmem_path(variant):
    """ops.streamsvm_fit_many under a budget between the floor and the
    resident tile runs "vmem" (forced and "auto") and gives the default
    budget's bits."""
    X, Y, cs = _bank_data(20, 300, 784, seed=8)
    kw = dict(device="cpu", block_n=64, variant=variant,
              **({"lookahead": 3} if variant == "lookahead" else {}))
    ref = ops.streamsvm_fit_many(X, Y, cs, **kw)
    for res in ("vmem", "auto"):
        got = ops.streamsvm_fit_many(X, Y, cs, bank_resident=res, vmem_budget_bytes=40_000, **kw)
        for a, c in zip(got, ref):
            assert torch.equal(a, c)
