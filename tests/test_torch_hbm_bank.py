"""B6 in the port: bank_resident="hbm" (the ring), its policy and preflight.

The same seeded numpy inputs go through ``repro.kernels.ops`` with
``bank_resident="hbm"`` (Pallas in interpret mode) and the port on the CPU,
where "hbm" runs the ring's plain versions (``*_ring_plain``): the stream
in blocks, the bank tiles cycled through the ring, each tile's state carried
between its visits. Port against reference: floats within the engine
tolerance (rtol 2e-4 / atol 2e-5 on weights: f32 sums in another order),
``m`` exactly, served ids exactly where the margins are separated by more
than 1e-5 max|score|. Port against port: "hbm" equals "vmem" bit for bit
(``torch.equal``) in every ring regime, end to end through fit_bank,
fit_chunked_many, fit_ovr, fit_c_grid, fit_lookahead and BankServer.

The byte models return the shared memory per CTA of the kernel a call
would launch; the policy (auto, forced, preflight, budget) is the
reference's, held to the card's numbers here.
"""
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import fit_bank as jfit_bank
from repro.core import fit_ovr as jfit_ovr
from repro.core import ovr_signs as jovr_signs
from repro.kernels import ops as jops
from repro.kernels.ref import streamsvm_scan_many_ref
from repro_torch.convert import ball_to_numpy
from repro_torch.core import (
    fit_bank,
    fit_c_grid,
    fit_chunked_many,
    fit_kernel_bank,
    fit_lookahead,
    fit_ovr,
    ovr_signs,
)
from repro_torch.kernels import ops
from repro_torch.kernels.predict import (
    NEG_MASK,
    PREDICT_SMEM,
    predict_bank_plain,
    predict_bank_ring,
    predict_bank_ring_plain,
)
from repro_torch.kernels.streamsvm_scan import (
    RING_LEAN_DC,
    RING_SLOTS,
    SCAN_SMEM,
    SMEM_PER_BLOCK,
    resident_smem,
    ring_plan,
    ring_smem,
    streamsvm_scan_lookahead_many_plain,
    streamsvm_scan_lookahead_many_ring_plain,
    streamsvm_scan_many_plain,
    streamsvm_scan_many_ring,
    streamsvm_scan_many_ring_plain,
)
from repro_torch.serve import BankServer


def _bank_data(b, n, d, seed, sign0=0.03):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    Y = np.sign(rng.normal(size=(b, n))).astype(np.float32)
    Y[rng.random((b, n)) < sign0] = 0.0
    Y[:, 0] = np.where(Y[:, 0] == 0, 1.0, Y[:, 0])  # row 0 seeds every model
    cs = np.exp(rng.uniform(-1, 4, size=b)).astype(np.float32)
    return X, Y, cs


def _port(X, Y, cs, balls=None, **kw):
    return ops.streamsvm_fit_many(X, Y, cs, balls, device="cpu", **kw)


def _jax(X, Y, cs, **kw):
    return jops.streamsvm_fit_many(jnp.asarray(X), jnp.asarray(Y), jnp.asarray(cs), **kw)


def _assert_close_to_ref(port, ref):
    w, r, xi2, m = ball_to_numpy(port)
    np.testing.assert_allclose(w, np.asarray(ref.w), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(r, np.asarray(ref.r), rtol=1e-4)
    np.testing.assert_allclose(xi2, np.asarray(ref.xi2), rtol=1e-3, atol=1e-6)
    np.testing.assert_array_equal(m, np.asarray(ref.m))


def _assert_equal(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# hbm: the port against the reference's hbm, and bit for bit against vmem
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,n,d,block_n,b_tile", [
    (8, 300, 20, 64, 8),       # J=1: nothing cycles
    (16, 300, 20, 64, 8),      # J=2: each tile keeps a slot
    (24, 384, 24, 128, 8),     # J=3: odd tile count cycling through 2 slots
    (64, 300, 20, 64, 8),      # J=8: even, steady-state ring over 5 blocks
    (11, 257, 33, 64, 8),      # ragged B and N (padded inert lanes)
    (13, 300, 20, 64, 3),      # b_tile not a multiple of 8 (rounded up)
    (40, 128, 40, 256, 8),     # a single block: the prefetch chain only
])
def test_hbm_matches_reference_and_vmem(b, n, d, block_n, b_tile):
    X, Y, cs = _bank_data(b, n, d, seed=b * n + d)
    kw = dict(block_n=block_n, b_tile=b_tile)
    hbm = _port(X, Y, cs, bank_resident="hbm", **kw)
    _assert_close_to_ref(hbm, _jax(X, Y, cs, bank_resident="hbm", **kw))
    _assert_equal(hbm, _port(X, Y, cs, bank_resident="vmem", **kw))


@pytest.mark.parametrize("lookahead", [2, 5, (3, 1, 7, 2) * 6])
def test_hbm_lookahead_matches_reference_and_vmem(lookahead):
    """Algorithm 2 through the ring: per-model L, windows carried across
    blocks and tiles, the partial windows flushed after the last row."""
    X, Y, cs = _bank_data(24, 333, 20, seed=7)
    kw = dict(variant="lookahead", lookahead=lookahead, block_n=64, b_tile=8)
    hbm = _port(X, Y, cs, bank_resident="hbm", **kw)
    _assert_close_to_ref(hbm, _jax(X, Y, cs, bank_resident="hbm", **kw))
    _assert_equal(hbm, _port(X, Y, cs, bank_resident="vmem", **kw))


def test_hbm_bf16_stream_matches_reference_and_vmem():
    X, Y, cs = _bank_data(24, 300, 24, seed=11)
    kw = dict(block_n=64, b_tile=8, stream_dtype="bf16")
    hbm = _port(X, Y, cs, bank_resident="hbm", **kw)
    _assert_close_to_ref(hbm, _jax(X, Y, cs, bank_resident="hbm", **kw))
    _assert_equal(hbm, _port(X, Y, cs, bank_resident="vmem", **kw))


def test_hbm_matches_bank_oracle():
    """The ring against the row-at-a-time oracle, not only against itself."""
    X, Y, cs = _bank_data(32, 400, 24, seed=17, sign0=0.0)
    bank = _port(X, Y, cs, block_n=128, b_tile=8, bank_resident="hbm")
    c_inv = 1.0 / cs
    w, r, xi2, m = streamsvm_scan_many_ref(
        jnp.asarray(X[1:]), jnp.asarray(Y[:, 1:]), jnp.asarray(Y[:, :1] * X[:1]), 0.0,
        jnp.asarray(c_inv), jnp.asarray(c_inv), 1, gain=jnp.asarray(c_inv),
    )
    np.testing.assert_allclose(bank.w.numpy(), np.asarray(w), rtol=2e-4, atol=2e-5)
    np.testing.assert_array_equal(bank.m.numpy(), np.asarray(m))


def test_hbm_continue_from_bank_and_wrappers():
    """fit_bank continuing from a bank, fit_ovr and fit_c_grid route the
    residency through unchanged."""
    rng = np.random.default_rng(3)
    X = rng.normal(size=(220, 16)).astype(np.float32)
    labels = rng.integers(0, 6, size=220)
    o_h = fit_ovr(X, labels, 6, 10.0, b_tile=8, bank_resident="hbm", device="cpu")
    _assert_close_to_ref(o_h, jfit_ovr(jnp.asarray(X), jnp.asarray(labels), 6, 10.0, b_tile=8,
                                       bank_resident="hbm"))
    _assert_equal(o_h, fit_ovr(X, labels, 6, 10.0, b_tile=8, bank_resident="vmem", device="cpu"))
    y = np.where(labels < 3, 1.0, -1.0).astype(np.float32)
    g_h = fit_c_grid(X, y, (0.5, 5.0, 50.0), b_tile=8, bank_resident="hbm", device="cpu")
    _assert_equal(g_h, fit_c_grid(X, y, (0.5, 5.0, 50.0), b_tile=8, bank_resident="vmem",
                                  device="cpu"))
    ys = ovr_signs(labels, 6, device="cpu").numpy()
    out = {}
    for res in ("hbm", "vmem"):
        half = fit_bank(X[:100], ys[:, :100], 10.0, b_tile=8, bank_resident=res, device="cpu")
        out[res] = fit_bank(X[100:], ys[:, 100:], 10.0, half, b_tile=8, bank_resident=res)
    _assert_equal(out["hbm"], out["vmem"])
    jys = jovr_signs(jnp.asarray(labels), 6)
    jhalf = jfit_bank(jnp.asarray(X[:100]), jys[:, :100], 10.0, b_tile=8, bank_resident="hbm")
    jcont = jfit_bank(jnp.asarray(X[100:]), jys[:, 100:], 10.0, jhalf, b_tile=8,
                      bank_resident="hbm")
    _assert_close_to_ref(out["hbm"], jcont)


def test_hbm_end_to_end_fit_chunked_lookahead_and_server():
    """fit_chunked_many, fit_lookahead and BankServer with "hbm" give the
    bits of "vmem"."""
    X, Y, cs = _bank_data(12, 400, 16, seed=5)
    chunks = [(X[lo : lo + 128], Y[:, lo : lo + 128]) for lo in range(0, 400, 128)]
    runs = {res: fit_chunked_many(chunks, cs, b_tile=8, bank_resident=res, device="cpu")
            for res in ("hbm", "vmem")}
    _assert_equal(runs["hbm"].ball, runs["vmem"].ball)
    la = {res: fit_lookahead(torch.from_numpy(X), torch.from_numpy(Y[0]), 2.0, 4,
                             bank_resident=res) for res in ("hbm", "vmem")}
    _assert_equal(la["hbm"], la["vmem"])
    Q = np.random.default_rng(6).normal(size=(70, 16)).astype(np.float32)
    for kw in (dict(epilogue="ovr", n_classes=4), dict(epilogue="topk", k=3), {}):
        served = [BankServer(runs["vmem"].ball, q_block=32, bank_resident=res, **kw).score(Q)
                  for res in ("hbm", "vmem")]
        for a, b in zip(*(s if isinstance(s, tuple) else (s,) for s in served)):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# The ring's plain versions against B1's / B3's, bit for bit
# ---------------------------------------------------------------------------


def _padded(b, n, d, seed):
    X, Y, cs = _bank_data(b, n, d, seed)
    t = torch.from_numpy
    return (t(X[1:]), t(Y[:, 1:]), t(Y[:, :1] * X[:1]), torch.zeros(b), t(1 / cs), t(1 / cs),
            torch.ones(b, dtype=torch.int32), t(1 / cs))


@pytest.mark.parametrize("ring_tile,n_ctas", [(8, 1), (8, 2), (8, 3), (16, 1), (16, 2), (48, 1)])
def test_ring_plain_equals_b1_plain(ring_tile, n_ctas):
    args = _padded(48, 321, 19, seed=ring_tile + n_ctas)
    kw = dict(n_valid=300, block_n=64)
    _assert_equal(streamsvm_scan_many_ring_plain(*args, ring_tile=ring_tile, n_ctas=n_ctas, **kw),
                  streamsvm_scan_many_plain(*args, **kw))


@pytest.mark.parametrize("ring_tile,n_ctas", [(8, 1), (8, 4), (16, 2), (32, 1)])
def test_ring_plain_equals_b3_plain(ring_tile, n_ctas):
    args = _padded(32, 257, 17, seed=3 * ring_tile + n_ctas)
    L = torch.tensor([(1, 2, 5, 3)[i % 4] for i in range(32)], dtype=torch.int32)
    kw = dict(lookahead=L, lookahead_max=5, n_valid=250, block_n=64)
    got = streamsvm_scan_lookahead_many_ring_plain(*args, ring_tile=ring_tile, n_ctas=n_ctas, **kw)
    _assert_equal(got, streamsvm_scan_lookahead_many_plain(*args, **kw))


def test_ring_wrapper_runs_plain_version_on_cpu():
    args = _padded(16, 129, 8, seed=4)
    before = streamsvm_scan_many_ring.launches
    got = streamsvm_scan_many_ring(*args, n_valid=128, block_n=128, n_ctas=2)
    assert streamsvm_scan_many_ring.launches == before
    _assert_equal(got, streamsvm_scan_many_plain(*args, n_valid=128, block_n=128))
    with pytest.raises(ValueError, match="ring_tile"):
        streamsvm_scan_many_ring_plain(*args, n_valid=128, block_n=128, ring_tile=12)
    with pytest.raises(ValueError, match="n_ctas"):
        streamsvm_scan_many_ring_plain(*args, n_valid=128, block_n=128, n_ctas=3)


@pytest.mark.parametrize("epilogue,kw", [
    ("scores", {}), ("ovr", {"nc_pad": 8, "b_tile": 16}), ("ovr", {"nc_pad": 8, "b_tile": 48}),
    ("topk", {"k": 5, "b_tile": 8}), ("topk", {"k": 5, "b_tile": 48}),
])
def test_predict_ring_plain_equals_b2_plain(epilogue, kw):
    rng = np.random.default_rng(9)
    Q = torch.from_numpy(rng.normal(size=(64, 12)).astype(np.float32))
    W = torch.from_numpy(rng.normal(size=(48, 12)).astype(np.float32))
    W[5] = W[9]  # a tie: the lower lane wins in both
    bias = torch.zeros(48)
    bias[-3:] = NEG_MASK
    got = predict_bank_ring_plain(Q, W, bias, epilogue=epilogue, q_block=32, **kw)
    want = predict_bank_plain(Q, W, bias, epilogue=epilogue, q_block=32, **kw)
    _assert_equal(got if isinstance(got, tuple) else (got,),
                  want if isinstance(want, tuple) else (want,))
    before = predict_bank_ring.launches
    predict_bank_ring(Q, W, bias, epilogue=epilogue, q_block=32, **kw)
    assert predict_bank_ring.launches == before


def _predict_data(q, b, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(q, d)).astype(np.float32),
            rng.normal(size=(b, d)).astype(np.float32))


def _separated(scores, k):
    """(Q, k) mask of the sorted positions whose value is more than 1e-5
    max|score| from both neighbours."""
    s = np.sort(scores, axis=-1)[..., ::-1]
    tol = 1e-5 * np.abs(scores).max()
    gaps = s[..., :-1] - s[..., 1:]
    inf = np.full(gaps[..., :1].shape, np.inf)
    return np.minimum(np.concatenate([inf, gaps], -1), np.concatenate([gaps, inf], -1))[..., :k] > tol


@pytest.mark.parametrize("epilogue,kw", [
    ("scores", {}), ("ovr", {"n_classes": 6}), ("topk", {"k": 4}),
])
def test_predict_hbm_matches_reference_and_vmem(epilogue, kw):
    X, W = _predict_data(50, 24, 20, seed=3)
    common = dict(epilogue=epilogue, q_block=32, b_tile=12 if epilogue == "ovr" else 8, **kw)
    port = ops.predict_bank(X, W, bank_resident="hbm", device="cpu", **common)
    ref = jops.predict_bank(jnp.asarray(X), jnp.asarray(W), bank_resident="hbm", **common)
    vmem = ops.predict_bank(X, W, bank_resident="vmem", device="cpu", **common)
    port = port if isinstance(port, tuple) else (port,)
    _assert_equal(port, vmem if isinstance(vmem, tuple) else (vmem,))
    ref = tuple(np.asarray(r) for r in (ref if isinstance(ref, tuple) else (ref,)))
    scores = X @ W.T
    if epilogue == "scores":
        np.testing.assert_allclose(port[0].numpy(), ref[0], rtol=2e-4, atol=2e-5)
        return
    if epilogue == "ovr":
        ids, vals = port[0].numpy(), port[1].numpy()
        sep = _separated(scores.reshape(50, -1, 6), 1)[..., 0]
        rids, rvals = ref
    else:
        vals, ids = port[0].numpy(), port[1].numpy()
        sep = _separated(scores, 4)
        rvals, rids = ref
    np.testing.assert_array_equal(ids[sep], rids[sep])
    np.testing.assert_allclose(vals, rvals, rtol=2e-4, atol=2e-5)


# ---------------------------------------------------------------------------
# The policy: auto at the budget boundary, the budget, the byte models
# ---------------------------------------------------------------------------


def test_auto_routes_at_budget_boundary():
    """auto is vmem exactly at the vmem path's smallest layout (the chunked
    kernels, SCAN_SMEM) and hbm one byte under, where the ring (its lean
    32-column layout) still fits. The byte model is evaluated at the budget,
    as streamsvm_fit_many evaluates it."""
    model = lambda budget: lambda res: ops.engine_vmem_bytes(
        64, 64, block_n=128, b_tile=8, bank_resident=res, smem_budget=budget)
    total = sum(SCAN_SMEM.values())
    res, by = ops.resolve_bank_resident("auto", model(total), vmem_budget=total, what="t",
                                        shapes="s")
    assert res == "vmem" and by == model(total)("vmem") == SCAN_SMEM
    res, by = ops.resolve_bank_resident("auto", model(total - 1), vmem_budget=total - 1,
                                        what="t", shapes="s")
    assert res == "hbm" and by == model(total - 1)("hbm")


def test_auto_routed_to_hbm_by_a_squeezed_budget_is_bit_exact():
    X, Y, cs = _bank_data(24, 300, 20, seed=23)
    vmem = _port(X, Y, cs, block_n=64, b_tile=8, bank_resident="vmem")
    squeeze = sum(SCAN_SMEM.values()) - 1  # under the vmem path's smallest layout
    model = lambda res: ops.engine_vmem_bytes(24, 20, block_n=64, b_tile=8, bank_resident=res,
                                              smem_budget=squeeze)
    assert sum(model("vmem").values()) > squeeze  # no vmem layout fits
    assert sum(model("hbm").values()) <= squeeze  # hbm fits where vmem does not
    auto = _port(X, Y, cs, block_n=64, b_tile=8, bank_resident="auto",
                 vmem_budget_bytes=squeeze)
    _assert_equal(auto, vmem)
    # The serving twin: a budget under B2's bytes routes predict to the ring.
    Xq = X[:40]
    base = ops.predict_bank(Xq, vmem.w, q_block=64, device="cpu")
    pmodel = lambda res: ops.predict_vmem_bytes(24, 20, q_block=64, bank_resident=res)
    psqueeze = sum(pmodel("vmem").values()) - 1
    assert sum(pmodel("hbm").values()) <= psqueeze
    before = predict_bank_ring.launches
    got = ops.predict_bank(Xq, vmem.w, q_block=64, vmem_budget_bytes=psqueeze, device="cpu")
    assert torch.equal(got, base)
    assert predict_bank_ring.launches == before  # the CPU runs the plain version


@pytest.mark.parametrize("lookahead", [None, 3])
def test_auto_squeezed_at_a_real_width_cycles_chunks(lookahead):
    """At D = 784 the owned whole rows do not fit a budget just under the
    vmem path's smallest layout (the chunked kernels, 25,888 B), but the
    ring's lean layout, cycling 32-column chunks, does: "auto" lands on
    "hbm" in that layout, bit-equal to "vmem"."""
    b, d = 16, 784
    X, Y, cs = _bank_data(b, 200, d, seed=31)
    la = {} if lookahead is None else dict(variant="lookahead", lookahead=lookahead)
    model = lambda res, budget=None: ops.engine_vmem_bytes(
        b, d, block_n=64, lookahead_max=lookahead, bank_resident=res, smem_budget=budget)
    squeeze = sum(SCAN_SMEM.values()) - 1
    assert sum(model("vmem", squeeze).values()) > squeeze  # no vmem layout fits
    assert sum(model("hbm").values()) > squeeze  # owned slots at the card's limit
    cycling = model("hbm", squeeze)
    assert cycling["bank"] == RING_SLOTS * 8 * RING_LEAN_DC * 4 and sum(cycling.values()) <= squeeze
    res, by = ops.resolve_bank_resident(
        "auto", lambda r: model(r, squeeze), vmem_budget=squeeze, what="t", shapes="s")
    assert (res, by) == ("hbm", cycling)
    vmem = _port(X, Y, cs, block_n=64, bank_resident="vmem", **la)
    auto = _port(X, Y, cs, block_n=64, vmem_budget_bytes=squeeze, **la)
    _assert_equal(auto, vmem)


@pytest.mark.parametrize("lookahead", [False, True])
@pytest.mark.parametrize("b", [600, 1_536])
def test_ring_plan_fits_every_budget_down_to_the_lean_bound(b, lookahead):
    """At D = 784, ring_plan gives a layout that fits every budget from
    16,640 + 1,216 jmax bytes (1,024 more with the window masks: 18,880 B at
    one tile per CTA with lookahead) to the card's limit: owned where the
    whole rows fit, else cycling 128-column chunks, else the lean 32-column
    layout, whose bytes stay within that bound at any number of tiles per
    CTA."""
    bound = lambda jmax: 16_640 + jmax * 1_216 + (1_024 if lookahead else 0)
    bp = -(-b // 64) * 64
    jmax = ring_plan(bp, 784, lookahead=lookahead)["jmax"]
    assert jmax == (1 if b == 600 else 2)
    seen = set()
    for budget in range(bound(jmax), SMEM_PER_BLOCK + 1):
        plan = ring_plan(bp, 784, lookahead=lookahead, smem_budget=budget)
        assert sum(plan["smem"].values()) <= budget
        seen.add(plan["layout"])
    assert seen == {"owned", "cycling", "lean"}
    for j in range(1, 200):
        assert sum(ring_smem(784, j, "lean", lookahead=lookahead).values()) <= bound(j)


def test_hbm_without_a_tile_keeps_the_whole_bank_on_the_card():
    """With b_tile=None, "hbm" and an "auto" squeezed past vmem train with
    the bank in one tile: the card's ring unit is a lane group, so the
    derived tile stays None (the TPU derives a smaller slab)."""
    X, Y, cs = _bank_data(64, 256, 64, seed=29)
    ref = _port(X, Y, cs, block_n=64, bank_resident="vmem")
    model = lambda res, bt, budget=None: ops.engine_vmem_bytes(
        64, 64, block_n=64, b_tile=bt, bank_resident=res, smem_budget=budget)
    under = sum(SCAN_SMEM.values()) - 1  # below every vmem layout
    squeeze = sum(model("hbm", 8, under).values()) + 1
    assert sum(model("vmem", None, squeeze).values()) > squeeze
    assert ops.derive_hbm_b_tile(64, lambda bt: model("hbm", bt, squeeze),
                                 vmem_budget=squeeze) is None
    for residency in ("auto", "hbm"):
        got = _port(X, Y, cs, block_n=64, bank_resident=residency, vmem_budget_bytes=squeeze)
        _assert_equal(got, ref)
    base = ops.predict_bank(X[:40], ref.w, q_block=64, device="cpu")
    got = ops.predict_bank(X[:40], ref.w, q_block=64, bank_resident="hbm", device="cpu",
                           vmem_budget_bytes=sum(ops.predict_vmem_bytes(
                               64, 64, bank_resident="hbm").values()))
    assert torch.equal(got, base)


def test_derive_hbm_b_tile():
    """The reference's policy: None when the whole bank fits, else the
    largest power-of-two tile under the budget, else 8."""
    model = lambda bt: {"ring": 2 * (512 if bt is None else bt) * 100}
    assert ops.derive_hbm_b_tile(512, model, vmem_budget=10**6) is None
    assert ops.derive_hbm_b_tile(512, model, vmem_budget=2 * 64 * 100) == 64
    assert ops.derive_hbm_b_tile(512, model, vmem_budget=2 * 100 * 100) == 64
    assert ops.derive_hbm_b_tile(40, model, vmem_budget=2 * 256 * 100) == 32
    assert ops.derive_hbm_b_tile(512, model, vmem_budget=10) == 8


def test_vmem_budget_resolution_order():
    """Explicit override > REPRO_VMEM_BUDGET_BYTES > the default, the
    H100's per-block opt-in limit."""
    assert ops.DEFAULT_VMEM_BUDGET_BYTES == 232_448
    assert ops.vmem_budget_bytes(123) == 123
    old = os.environ.get("REPRO_VMEM_BUDGET_BYTES")
    try:
        os.environ["REPRO_VMEM_BUDGET_BYTES"] = "456"
        assert ops.vmem_budget_bytes() == 456
        assert ops.vmem_budget_bytes(123) == 123
        del os.environ["REPRO_VMEM_BUDGET_BYTES"]
        assert ops.vmem_budget_bytes() == ops.DEFAULT_VMEM_BUDGET_BYTES
    finally:
        if old is not None:
            os.environ["REPRO_VMEM_BUDGET_BYTES"] = old
        else:
            os.environ.pop("REPRO_VMEM_BUDGET_BYTES", None)


def test_byte_models_follow_the_card_layouts():
    """B1/B3/B2 keep no whole-bank scratch: their bytes are constant in B
    (so auto is vmem at the default budget for every B). The ring's bytes
    are constant in B at a fixed number of tiles per CTA, grow with it, and
    with D only while each tile owns a whole-row slot."""
    vm = [sum(ops.engine_vmem_bytes(b, 784, bank_resident="vmem").values())
          for b in (8, 600, 100_000)]
    assert vm == [sum(resident_smem(784, 8, lookahead=False).values())] * 3 == [64_032] * 3
    assert sum(ops.engine_vmem_bytes(8, 784, lookahead_max=10).values()) == 72_704
    for la in (None, 10):  # under a budget below every tile: the chunked kernels
        assert sum(ops.engine_vmem_bytes(600, 784, lookahead_max=la,
                                         smem_budget=25_888).values()) == 25_888
    h = lambda b, d=128, **kw: sum(ops.engine_vmem_bytes(b, d, b_tile=8, bank_resident="hbm",
                                                         **kw).values())
    assert h(64) == h(512) == h(1056)  # one tile per CTA (132 SMs)
    assert h(2 * 1056) > h(1056)  # two tiles per CTA
    assert h(64, d=4096) > h(64, d=2048) > h(64, d=784) > h(64, d=128)  # owned: whole rows
    assert h(1584, d=4096) < h(1056, d=4096)  # two whole tiles do not fit: chunks cycle
    assert h(1584, d=4096) == h(2112, d=4096)  # two tiles a CTA either way
    assert h(64, lookahead_max=10) == h(64) + 1_024  # the flush masks; windows in HBM
    res, _ = ops.resolve_bank_resident(
        "auto", lambda r: ops.engine_vmem_bytes(10**6, 4096, bank_resident=r),
        vmem_budget=ops.DEFAULT_VMEM_BUDGET_BYTES, what="t", shapes="s")
    assert res == "vmem"
    p = [sum(ops.predict_vmem_bytes(b, 128, b_tile=8).values()) for b in (64, 4096)]
    assert p[0] == p[1] == sum(PREDICT_SMEM.values()) == 46_096
    assert sum(ops.predict_vmem_bytes(64, 128, epilogue="topk", k=5).values()) == 46_096 + 1_280
    assert sum(ops.predict_vmem_bytes(64, 128, bank_resident="hbm").values()) == 46_080


def test_forced_vmem_beyond_budget_raises_with_breakdown():
    X, Y, cs = _bank_data(16, 128, 64, seed=1)
    with pytest.raises(ValueError) as ei:
        _port(X, Y, cs, block_n=128, b_tile=8, bank_resident="vmem", vmem_budget_bytes=10_000)
    msg = str(ei.value)
    assert "breakdown" in msg and "bank_resident='vmem'" in msg
    assert "B=16" in msg and "D=64" in msg and "10000" in msg
    assert "hbm" in msg  # the way out


def test_no_residency_fits_raises():
    X, Y, cs = _bank_data(16, 128, 64, seed=2)
    for res in ("hbm", "auto"):
        with pytest.raises(ValueError, match="shrink"):
            _port(X, Y, cs, block_n=128, b_tile=8, bank_resident=res, vmem_budget_bytes=1_000)
    with pytest.raises(ValueError, match="shrink"):
        ops.predict_bank(X, np.ones((16, 64), np.float32), bank_resident="hbm", device="cpu",
                         vmem_budget_bytes=1_000)


def test_unknown_residency_raises():
    X, Y, cs = _bank_data(8, 64, 16, seed=3)
    with pytest.raises(ValueError, match="bank_resident"):
        _port(X, Y, cs, bank_resident="sram")
    with pytest.raises(ValueError, match="bank_resident"):
        ops.predict_bank(X, Y[:, :16], bank_resident="sram", device="cpu")
    with pytest.raises(ValueError, match="bank_resident"):
        BankServer(torch.zeros(4, 3), bank_resident="sram")


def test_fit_kernel_bank_budget_preflight():
    """The kernel bank's preflight holds B5's tiles and R1's staged layout
    (2 models per CTA at S = 8: two 32-row blocks of 20 words a row, the
    slot state, the barriers) to the budget on every call, each launch on
    its own."""
    by = ops.kernel_engine_vmem_bytes(3, 10, coreset_size=8)
    assert by == {"gram_tiles": 46_080, "row_recursion": 5_408}
    rng = np.random.default_rng(1)
    X = rng.normal(size=(40, 10)).astype(np.float32)
    Y = np.sign(rng.normal(size=(3, 40))).astype(np.float32)
    Y[:, 0] = 1.0
    kw = dict(coreset_size=8, block_n=16, device="cpu")
    with pytest.raises(ValueError) as ei:
        fit_kernel_bank(X, Y, 1.0, vmem_budget_bytes=46_079, **kw)
    assert "breakdown" in str(ei.value) and "46079" in str(ei.value)
    default = fit_kernel_bank(X, Y, 1.0, **kw)
    at_limit = fit_kernel_bank(X, Y, 1.0, vmem_budget_bytes=46_080, **kw)
    _assert_equal(default, at_limit)
