"""The port's CUDA kernels (B1-B6, R1, M1, P1, P2) against their plain versions, on the card;
and the LLM zoo (smoke configs: serving, training, Zamba2's SSD, the launcher) on the card
against the CPU.

Marked ``gpu``: each test needs a CUDA card and skips without one. Whether
there is a card is decided inside the fixture, so every pytest worker
collects the same tests. On the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances are the repo's engine tolerance (f32 sums in another order);
core-vector counts and ids are exact, and the bank's tiling changes no bit.
B6, the ring (bank_resident="hbm"), equals B1 / B3 / B2 bit for bit at every
number of tiles per CTA; B2 and the serving ring give the same bits whatever
their tile, cluster or launch, with exact ties to the lowest lane.
B5 equals its plain version bit for bit (both one fmaf chain per element),
linear B5 equals B2's scores on the same operands, and the RBF diagonal is
exactly 1; R1's slots and counts are exact at every core-set size, wherever
its slots live. Top-k serves any k <= B, in both kernels.
P1 (the perceptron) and P2 (Pegasos) make their plain versions' decisions
row for row (a parting only where certified as an f32 tie), with w within
the engine tolerance, in every layout and at widths from 2 to 65,536.
This file imports no JAX: the machine with the card has none.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import fit, fit_kernel_bank, fit_lookahead
from repro_torch.core.meb import _pair_gram
from repro_torch.kernels import ops
from repro_torch.kernels.gram import gram_fused, gram_plain, row_norms, row_norms_plain
from repro_torch.core.kernel_bank import _fit_kernel_bank
from repro_torch.kernels.kernel_bank import (
    kernel_bank_rows,
    kernel_bank_rows_plain,
    rows_layouts,
    rows_plan,
    staged_smem,
)
from repro_torch.kernels import _build
from repro_torch.kernels import kernel_bank as kb_mod
from repro_torch.kernels import streamsvm_scan as scan_mod
from repro_torch.kernels.predict import (
    TOPK_SMEM_MAX_K,
    predict_bank_fused,
    predict_bank_plain,
    predict_bank_ring,
    predict_bank_ring_plain,
)
from repro_torch.kernels.streamsvm_scan import (
    SCAN_SMEM,
    resident_smem,
    ring_plan,
    scan_plan,
    small_smem,
    streamsvm_scan,
    streamsvm_scan_lookahead_many,
    streamsvm_scan_lookahead_many_ring,
    streamsvm_scan_many,
    streamsvm_scan_lookahead_many_plain,
    streamsvm_scan_many_plain,
    streamsvm_scan_many_ring,
    streamsvm_scan_many_ring_plain,
)

from test_torch_multiball import _start, edge_stream  # M1's state and edge stream (no JAX)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _bank_data(b, n, d, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    Y = np.sign(rng.normal(size=(b, n))).astype(np.float32)
    Y[rng.random((b, n)) < 0.03] = 0.0
    Y[:, 0] = 1.0
    cs = np.exp(rng.uniform(-1, 4, size=b)).astype(np.float32)
    return X, Y, cs


@pytest.mark.parametrize("b,n,d,stream_dtype", [
    (13, 300, 20, None),
    (64, 1000, 784, None),
    (40, 700, 130, "bf16"),
])
def test_fit_many_kernel_matches_plain(cuda, b, n, d, stream_dtype):
    X, Y, cs = _bank_data(b, n, d, seed=b + n)
    before = streamsvm_scan_many.launches
    got = ops.streamsvm_fit_many(X, Y, cs, device=cuda, b_tile=8, stream_dtype=stream_dtype)
    assert streamsvm_scan_many.launches == before + 1
    want = ops.streamsvm_fit_many(X, Y, cs, device="cpu", b_tile=8, stream_dtype=stream_dtype)
    torch.testing.assert_close(got.w.cpu(), want.w, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(got.r.cpu(), want.r, rtol=1e-4, atol=0.0)
    torch.testing.assert_close(got.xi2.cpu(), want.xi2, rtol=1e-3, atol=1e-6)
    assert torch.equal(got.m.cpu(), want.m)


def test_kernel_b_tile_does_not_change_a_bit(cuda):
    X, Y, cs = _bank_data(61, 500, 50, seed=3)
    fits = [ops.streamsvm_fit_many(X, Y, cs, device=cuda, b_tile=bt) for bt in (8, 16, 64)]
    for other in fits[1:]:
        for a, c in zip(fits[0], other):
            assert torch.equal(a, c)


def test_scan_kernel_matches_plain_on_the_card(cuda):
    X, Y, cs = _bank_data(16, 512, 64, seed=8)
    t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=cuda)
    args = (t(X[1:]), t(Y[:, 1:]), t(Y[:, :1] * X[:1]), t(np.zeros(16)), t(1 / cs),
            t(1 / cs), t(np.ones(16), torch.int32), t(1 / cs))
    got = streamsvm_scan_many(*args, n_valid=500, block_n=511)
    want = streamsvm_scan_many_plain(*args, n_valid=500, block_n=511)
    torch.testing.assert_close(got[0], want[0], rtol=2e-4, atol=2e-5)
    assert torch.equal(got[3], want[3])


@pytest.mark.parametrize("epilogue,kw", [
    ("scores", {}), ("ovr", {"nc_pad": 24, "b_tile": 48}), ("topk", {"k": 7}),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_predict_kernel_matches_plain(cuda, epilogue, kw, dtype):
    rng = np.random.default_rng(2)
    Q = torch.as_tensor(rng.normal(size=(256, 100)).astype(np.float32), device=cuda).to(dtype)
    W = torch.as_tensor(rng.normal(size=(96, 100)).astype(np.float32), device=cuda)
    bias = torch.zeros(96, device=cuda)
    bias[-5:] = -3.0e38
    before = predict_bank_fused.launches
    got = predict_bank_fused(Q, W, bias, epilogue=epilogue, q_block=128, **kw)
    assert predict_bank_fused.launches == before + 1
    want = predict_bank_plain(Q, W, bias, epilogue=epilogue, q_block=128, **kw)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        if w.dtype == torch.int32:
            assert torch.equal(g, w)  # random normal scores: no near-ties here
        else:
            # f32 dot products over D: the reordering error grows with |score|
            atol = 2e-5 * max(1.0, w.abs().max().item())
            torch.testing.assert_close(g, w, rtol=2e-4, atol=atol)


def _assert_ball_close(got, want):
    got = [x.cpu() for x in got]
    torch.testing.assert_close(got[0], want.w, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(got[1], want.r, rtol=1e-4, atol=0.0)
    torch.testing.assert_close(got[2], want.xi2, rtol=1e-3, atol=1e-6)
    assert torch.equal(got[3], want.m)


@pytest.mark.parametrize("n,d", [(1000, 784), (777, 90), (300, 20), (300, 4096), (100, 65_536),
                                 (300, 1000), (300, 1001)])
def test_single_kernel_matches_plain(cuda, n, d):
    """B4: ragged N, a zero feature row, sign-0 rows, and a continuation;
    whole 32-row blocks staged where two fit (D <= 784 here), else 256-column
    chunks; the w row in shared memory, or in device memory where it does
    not fit (D = 65,536)."""
    plan = scan_mod.single_plan(d)
    assert (plan["w_in_smem"], plan["chunk"] >= d) == (d < 65_536, d <= 784)
    # (D = 1000 and 1001: a partial last chunk, with and without bulk copies.)
    rng = np.random.default_rng(n)
    X = rng.normal(size=(n, d)).astype(np.float32)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    X[n // 3] = 0.0  # a zero feature row is a real point
    y = np.sign(rng.normal(size=n)).astype(np.float32)
    y[rng.random(n) < 0.05] = 0.0
    y[0] = 1.0
    before = streamsvm_scan.launches
    got = ops.streamsvm_fit(X[: n // 2], y[: n // 2], 3.0, device=cuda, block_n=64)
    want = ops.streamsvm_fit(X[: n // 2], y[: n // 2], 3.0, device="cpu", block_n=64)
    _assert_ball_close(got, want)
    got = ops.streamsvm_fit(X[n // 2 :], y[n // 2 :], 3.0, got, block_n=64)
    want = ops.streamsvm_fit(X[n // 2 :], y[n // 2 :], 3.0, want, block_n=64)
    assert streamsvm_scan.launches == before + 2
    _assert_ball_close(got, want)


@pytest.mark.parametrize("d", [784, 1000])
def test_single_kernel_rows_past_n_in_a_block(cuda, d):
    """B4 with block_n = 50: N is not a multiple of the kernel's 32-row
    block, so the last block's rows past N are zeroed in shared memory
    (whole blocks at D = 784, 256-column chunks at D = 1000)."""
    rng = np.random.default_rng(d)
    X = rng.normal(size=(437, d)).astype(np.float32)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    y = np.sign(rng.normal(size=437)).astype(np.float32)
    y[0] = 1.0
    got = ops.streamsvm_fit(X, y, 3.0, device=cuda, block_n=50)
    want = ops.streamsvm_fit(X, y, 3.0, device="cpu", block_n=50)
    _assert_ball_close(got, want)


@pytest.mark.parametrize("variant", ["exact", "paper-listing"])
def test_fit_on_the_card_matches_the_cpu(cuda, variant):
    rng = np.random.default_rng(4)
    X = rng.normal(size=(600, 50)).astype(np.float32)
    y = np.sign(rng.normal(size=600)).astype(np.float32)
    _assert_ball_close(fit(X, y, 5.0, variant=variant, device=cuda),
                       fit(X, y, 5.0, variant=variant, device="cpu"))


@pytest.mark.parametrize("b,n,d,stream_dtype,ls", [
    (13, 300, 20, None, (1, 2, 3, 16, 5, 8, 1, 1, 4, 16, 2, 7, 9)),
    (24, 700, 130, "bf16", 6),
    (40, 1000, 784, None, 10),
])
def test_lookahead_kernel_matches_plain(cuda, b, n, d, stream_dtype, ls):
    """B3: per-model L (1 to 16), ragged B and N, sign-0 rows, bf16, and a
    continuation from the balls."""
    X, Y, cs = _bank_data(b, n, d, seed=b * n)
    kw = dict(variant="lookahead", lookahead=ls, b_tile=8, stream_dtype=stream_dtype, block_n=64)
    before = streamsvm_scan_lookahead_many.launches
    half = n // 2
    got = ops.streamsvm_fit_many(X[:half], Y[:, :half], cs, device=cuda, **kw)
    want = ops.streamsvm_fit_many(X[:half], Y[:, :half], cs, device="cpu", **kw)
    _assert_ball_close(got, want)
    got = ops.streamsvm_fit_many(X[half:], Y[:, half:], cs, got, **kw)
    want = ops.streamsvm_fit_many(X[half:], Y[:, half:], cs, want, **kw)
    assert streamsvm_scan_lookahead_many.launches == before + 2
    _assert_ball_close(got, want)


def test_lookahead_kernel_b_tile_does_not_change_a_bit(cuda):
    X, Y, cs = _bank_data(61, 500, 50, seed=5)
    fits = [
        ops.streamsvm_fit_many(X, Y, cs, device=cuda, b_tile=bt, variant="lookahead-paper",
                               lookahead=4)
        for bt in (8, 16, 64)
    ]
    for other in fits[1:]:
        for a, c in zip(fits[0], other):
            assert torch.equal(a, c)


def test_fit_lookahead_on_the_card_matches_the_cpu(cuda):
    rng = np.random.default_rng(21)
    X = rng.normal(size=(400, 14)).astype(np.float32)
    y = np.sign(rng.normal(size=400)).astype(np.float32)
    _assert_ball_close(fit_lookahead(X, y, 10.0, 8, device=cuda),
                       fit_lookahead(X, y, 10.0, 8, device="cpu"))


@pytest.mark.parametrize("m,n,d", [(256, 1000, 784), (37, 130, 33), (65, 63, 7), (1, 5, 1)])
@pytest.mark.parametrize("epilogue", ["linear", "rbf"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gram_kernel_matches_plain(cuda, m, n, d, epilogue, dtype):
    rng = np.random.default_rng(m + n + d)
    A = torch.as_tensor(rng.normal(size=(m, d)).astype(np.float32), device=cuda).to(dtype)
    B = torch.as_tensor(rng.normal(size=(n, d)).astype(np.float32), device=cuda)
    an, bn = row_norms(A), row_norms(B)
    assert torch.equal(an, row_norms_plain(A)) and torch.equal(bn, row_norms_plain(B))
    before = gram_fused.launches
    got = gram_fused(A, B, an, bn, 0.05, epilogue=epilogue)
    assert gram_fused.launches == before + 1
    want = gram_plain(A, B, an, bn, 0.05, epilogue=epilogue)
    assert torch.equal(got, want), (got - want).abs().max().item()


@pytest.mark.parametrize("m,n,d", [(256, 38_400, 784), (300, 1000, 785), (1000, 640, 33)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gram_linear_equals_b2_scores(cuda, m, n, d, dtype):
    """One product body: linear B5 and B2's scores give the same bits on the
    same operands, at the K_cs shape (large tile) and at small launches."""
    rng = np.random.default_rng(m + d)
    A = torch.as_tensor(rng.normal(size=(m, d)).astype(np.float32), device=cuda).to(dtype)
    B = torch.as_tensor(rng.normal(size=(n, d)).astype(np.float32), device=cuda)
    z = torch.zeros(m, device=cuda)
    got = gram_fused(A, B, z, torch.zeros(n, device=cuda), epilogue="linear")
    want = predict_bank_fused(A, B, torch.zeros(n, device=cuda), epilogue="scores", q_block=m)
    assert torch.equal(got, want)


@pytest.mark.parametrize("n,d", [(60_000, 784), (131, 33), (1, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_norms_kernel_matches_plain(cuda, n, d, dtype):
    rng = np.random.default_rng(n + d)
    X = torch.as_tensor(rng.normal(size=(n, d)).astype(np.float32), device=cuda).to(dtype)
    before = row_norms.launches
    got = row_norms(X)
    assert row_norms.launches == before + 1
    assert torch.equal(got, row_norms_plain(X))
    K = gram_fused(X[:256], X[:256], got[:256], got[:256], 3.0, epilogue="rbf")
    assert torch.equal(torch.diagonal(K), torch.ones(min(n, 256), device=cuda))


def test_gram_kernel_chunks_are_bit_exact(cuda):
    rng = np.random.default_rng(1)
    A = torch.as_tensor(rng.normal(size=(256, 784)).astype(np.float32), device=cuda)
    B = torch.as_tensor(rng.normal(size=(640, 784)).astype(np.float32), device=cuda)
    an, bn = row_norms(A), row_norms(B)
    whole = gram_fused(A, B, an, bn, 0.01, epilogue="rbf")
    parts = torch.cat([gram_fused(A, B[lo:lo + 100], an, bn[lo:lo + 100], 0.01, epilogue="rbf")
                       for lo in range(0, 640, 100)], dim=1)
    assert torch.equal(whole, parts)
    assert torch.equal(gram_fused(A[7:90], B, an[7:90], bn, 0.01, epilogue="rbf"), whole[7:90])
    K = gram_fused(A, A, an, an, 0.01, epilogue="rbf")
    assert torch.equal(torch.diagonal(K), torch.ones(256, device=cuda))


def _tile_inputs(cuda, b, s, bn, d, seed, farthest):
    """The second tile's inputs: a bank state from a fit over the first tile,
    and the tile's Gram blocks, as fit_kernel_bank builds them. One earlier
    tile leaves the balls small enough that every case absorbs rows here."""
    rng = np.random.default_rng(seed)
    n0 = bn
    X = rng.normal(size=(n0 + bn, d)).astype(np.float32)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    Y = np.sign(rng.normal(size=(b, n0 + bn))).astype(np.float32)
    Y[Y == 0] = 1.0
    Y[rng.random((b, n0 + bn)) < 0.1] = 0.0
    Y[:, 0] = 1.0
    cs = np.exp(rng.uniform(-1, 3, size=b)).astype(np.float32)
    ev = "farthest-point" if farthest else "smallest-coef"
    kb = fit_kernel_bank(X[:n0], Y[:, :n0], cs, coreset_size=s, eviction=ev, block_n=bn,
                         device=cuda)
    Xd = torch.as_tensor(X, device=cuda)
    xt = Xd[n0:]
    xc = kb.points.to(cuda)
    k_cs = gram_fused(xt, xc.reshape(b * s, d), row_norms(xt), row_norms(xc.reshape(b * s, d)),
                      1.0, epilogue="rbf").reshape(bn, b, s)
    k_tt = gram_fused(xt, xt, row_norms(xt), row_norms(xt), 1.0, epilogue="rbf")
    kbb = _pair_gram(xc, xc, "rbf", 1.0).contiguous() if farthest else None
    state = [t.to(cuda) for t in (kb.idx, kb.coef, kb.q, kb.r, kb.xi2, kb.m)]
    c_inv = 1.0 / torch.as_tensor(cs, device=cuda)
    y = torch.as_tensor(Y[:, n0:], device=cuda).contiguous()
    return k_cs, k_tt, y, state, c_inv, kbb, n0


@pytest.mark.parametrize("farthest", [False, True])
@pytest.mark.parametrize("b,s,bn,d", [
    (600, 64, 256, 784), (600, 12, 256, 784), (13, 8, 32, 20), (5, 100, 64, 9),
])
def test_rows_kernel_matches_plain(cuda, farthest, b, s, bn, d):
    k_cs, k_tt, y, state, c_inv, kbb, n0 = _tile_inputs(cuda, b, s, bn, d, b + s, farthest)
    got = [t.clone() for t in state]
    want = [t.clone() for t in state]
    kbb_g = kbb.clone() if farthest else None
    kbb_w = kbb.clone() if farthest else None
    before = kernel_bank_rows.launches
    kernel_bank_rows(k_cs, k_tt, y, *got, c_inv, c_inv, base=n0, n_valid=bn - 3, kbb=kbb_g)
    assert kernel_bank_rows.launches == before + 1
    kernel_bank_rows_plain(k_cs, k_tt, y, *want, c_inv, c_inv, base=n0, n_valid=bn - 3, kbb=kbb_w)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[5], want[5])  # idx, m
    for g, w in zip(got[1:5], want[1:5]):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)
    absorbed = int((got[5] - state[5]).sum())
    filled = int((got[0] >= 0).sum() - (state[0] >= 0).sum())
    assert absorbed > 0  # the tile moved the state
    if s <= 12:
        assert absorbed - filled > 0  # and, at small S, evicted


@pytest.mark.parametrize("farthest", [False, True])
@pytest.mark.parametrize("b,s,bn,d", [
    (600, 129, 256, 784), (40, 256, 256, 30), (9, 300, 64, 12), (5, 1100, 32, 8),
])
def test_rows_kernel_beyond_128_slots_matches_plain(cuda, farthest, b, s, bn, d):
    """S past the 4-register slots: 8 registers a lane (S <= 256), then the
    slots in the wrapper's device scratch (S = 300, 1,100); bit for bit with
    the plain version."""
    k_cs, k_tt, y, state, c_inv, kbb, n0 = _tile_inputs(cuda, b, s, bn, d, b + s, farthest)
    got, want = [t.clone() for t in state], [t.clone() for t in state]
    kbb_g = kbb.clone() if farthest else None
    kbb_w = kbb.clone() if farthest else None
    kernel_bank_rows(k_cs, k_tt, y, *got, c_inv, c_inv, base=n0, n_valid=bn, kbb=kbb_g)
    kernel_bank_rows_plain(k_cs, k_tt, y, *want, c_inv, c_inv, base=n0, n_valid=bn, kbb=kbb_w)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if farthest:
        assert torch.equal(kbb_g, kbb_w)
    assert int((got[5] - state[5]).sum()) > 0


def test_rows_kernel_slots_in_device_memory(cuda):
    """S = 9,000 pads to 16,384 slots, all in the wrapper's device scratch
    (6 words a slot, 1.2 MiB for three models)."""
    from repro_torch.kernels import kernel_bank as kb_mod

    b, s, bn = 3, 9000, 16
    rng = np.random.default_rng(3)
    k_cs = torch.as_tensor(rng.uniform(0.1, 1.0, size=(bn, b, s)).astype(np.float32), device=cuda)
    x = rng.normal(size=(bn, 4)).astype(np.float32)
    k_tt = torch.as_tensor(np.exp(-((x[:, None] - x[None]) ** 2).sum(-1)), device=cuda)
    y = torch.as_tensor(np.sign(rng.normal(size=(b, bn))).astype(np.float32), device=cuda)
    idx = torch.full((b, s), -1, dtype=torch.int32, device=cuda)
    idx[:, :4000] = torch.arange(4000, device=cuda, dtype=torch.int32)
    coef = torch.where(idx >= 0, torch.as_tensor(rng.normal(size=(b, s)).astype(np.float32),
                                                 device=cuda) * 1e-3, 0.0)
    state = [idx, coef, torch.full((b,), 0.5, device=cuda), torch.full((b,), 0.2, device=cuda),
             torch.full((b,), 0.1, device=cuda), torch.full((b,), 4000, dtype=torch.int32,
                                                           device=cuda)]
    c_inv = torch.full((b,), 0.5, device=cuda)
    assert kb_mod._lib().kernel_bank_rows_scratch_bytes(b, s) == b * 6 * 16_384 * 4
    got, want = [t.clone() for t in state], [t.clone() for t in state]
    before = kernel_bank_rows.launches
    kernel_bank_rows(k_cs, k_tt, y, *got, c_inv, c_inv, base=5000, n_valid=bn)
    assert kernel_bank_rows.launches == before + 1
    kernel_bank_rows_plain(k_cs, k_tt, y, *want, c_inv, c_inv, base=5000, n_valid=bn)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int((got[5] - state[5]).sum()) > 0


def _run_rows(fn, inp, kbb, **kw):
    """One R1 call on copies of the state (and kbb); returns them."""
    k_cs, k_tt, y, state, c_inv, base, n_valid = inp
    st = [t.clone() for t in state]
    kb = None if kbb is None else kbb.clone()
    fn(k_cs, k_tt, y, *st, c_inv, c_inv, base=base, n_valid=n_valid, kbb=kb, **kw)
    return st, kb


def _rows_plan_spy(monkeypatch):
    """The plans R1's wrapper takes, recorded as it launches."""
    seen, real = [], kb_mod.rows_plan

    def spy(*args, **kw):
        seen.append(real(*args, **kw))
        return seen[-1]

    monkeypatch.setattr(kb_mod, "rows_plan", spy)
    return seen


def _assert_layouts_equal_plain(monkeypatch, inp, kbb, b, s):
    """Every layout R1 can launch at (B, S), forced in turn, against the
    plain version bit for bit: idx, coef, q, r, xi2, m and kbb. Returns the
    plain version's state and the layouts."""
    want, kb_w = _run_rows(kernel_bank_rows_plain, inp, kbb)
    layouts = rows_layouts(b, s, farthest=kbb is not None)
    seen = _rows_plan_spy(monkeypatch)
    for plan in layouts:
        before = kernel_bank_rows.launches
        got, kb_g = _run_rows(kernel_bank_rows, inp, kbb, smem_budget=sum(plan["smem"].values()))
        assert kernel_bank_rows.launches == before + 1
        assert seen[-1] == plan
        torch.cuda.synchronize()
        for leaf, g, w in zip(("idx", "coef", "q", "r", "xi2", "m"), got, want):
            assert torch.equal(g, w), (plan["layout"], leaf)
        if kbb is not None:
            assert torch.equal(kb_g, kb_w), (plan["layout"], "kbb")
    return want, [p["layout"] for p in layouts]


@pytest.mark.parametrize("farthest", [False, True])
@pytest.mark.parametrize("s", [1, 16, 64, 129, 256, 300])
def test_rows_every_layout_matches_plain_and_parent(cuda, monkeypatch, farthest, s):
    """Each layout ``rows_layouts`` offers (staged where it fits the card,
    and the first port's registers or wide layout), forced by a budget of
    its own bytes, equals the plain version, and so the parent's layout,
    bit for bit on a tile of real RBF blocks whose valid rows (77 of 100)
    are not a multiple of 32, for a bank of 9 models (the last staged CTA
    of 2 holds one)."""
    b, bn = 9, 100
    k_cs, k_tt, y, state, c_inv, kbb, n0 = _tile_inputs(cuda, b, s, bn, 12, 40 + s, farthest)
    want, names = _assert_layouts_equal_plain(
        monkeypatch, (k_cs, k_tt, y, state, c_inv, n0, 77), kbb, b, s)
    assert int((want[5] - state[5]).sum()) > 0
    assert names[-1] == ("wide" if s > 256 else "registers")
    # The staged layout wherever S pads to 256 or less and fits: all but
    # farthest-point's 256 x 256 slab.
    assert ("staged" in names) == (s <= 129 or not farthest and s <= 256)


_SPIKES = (0, 31, 32, 33, 63, 64, 76)  # a block's first and last rows, consecutive rows


def _synthetic_tile(cuda, case, b, s, bn, n_valid, seed):
    """R1's inputs built to put the updates where a case wants them (no
    kernel need be positive definite for the recursion). Every 7th row from
    row 1 is inert. "none": a radius no row reaches. "spikes": each model
    updates on the spike rows (_SPIKES) it keeps live, whose K_cs values
    grow 4x a spike. "every": fresh models whose rows' k(x, x) grow 2.5x a
    row, so every live row updates (the seed first), evicting all along.
    "seeding": fresh models whose first 3 + 9 b rows are inert. Returns the
    inputs and each model's expected absorbs (-1: not fixed)."""
    rng = np.random.default_rng(seed)
    k_cs = rng.uniform(0.0, 0.02, size=(bn, b, s)).astype(np.float32)
    k_tt = rng.uniform(0.0, 0.02, size=(bn, bn)).astype(np.float32)
    k_tt = (k_tt + k_tt.T) / 2
    np.fill_diagonal(k_tt, 1.0)
    y = np.ones((b, bn), np.float32)
    y[:, 1::7] = 0.0
    idx = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    coef = np.full((b, s), 0.1, np.float32)
    q, r, xi2 = (np.full(b, v, np.float32) for v in (1.0, 50.0, 0.1))
    m = np.full(b, s, np.int32)
    want = np.full(b, -1)
    if case == "none":
        r[:] = 1e6
        want[:] = 0
    elif case == "spikes":
        y[:, list(_SPIKES)] = 1.0
        for bi in range(b):
            for k, i in enumerate(_SPIKES):
                k_cs[i, bi, :] = -1000.0 * 4.0 ** k
                if (bi + i) % 5 == 4:
                    y[bi, i] = 0.0  # a spike on an inert row changes nothing
            want[bi] = sum(1 for i in _SPIKES if i < n_valid and y[bi, i] != 0)
    else:
        idx[:] = -1
        coef[:] = 0.0
        q[:] = r[:] = xi2[:] = 0.0
        m[:] = 0
        if case == "every":
            k_tt = np.zeros((bn, bn), np.float32)
            np.fill_diagonal(k_tt, 2.5 ** np.minimum(np.arange(bn), 90.0))
            k_cs[:] = 0.0
            want[:] = (y[:, :n_valid] != 0).sum(1)
        else:
            for bi in range(b):
                y[bi, : 3 + 9 * bi] = 0.0
    t = lambda a: torch.as_tensor(a, device=cuda)
    state = [t(idx), t(coef), t(q), t(r), t(xi2), t(m)]
    return (t(k_cs), t(k_tt), t(y), state, torch.full((b,), 0.5, device=cuda), 500, n_valid), want


@pytest.mark.parametrize("farthest", [False, True])
@pytest.mark.parametrize("n_valid", [100, 77])
@pytest.mark.parametrize("s", [4, 16])
@pytest.mark.parametrize("case", ["none", "spikes", "every", "seeding"])
def test_rows_layouts_at_block_boundaries(cuda, monkeypatch, case, s, n_valid, farthest):
    """Every layout against the plain version bit for bit where the updates
    fall on a block's first and last rows, on consecutive rows, on every
    live row (a tile that seeds and evicts all along), on no row, after
    inert leading rows, with inert (sign 0) rows throughout and spikes on
    inert rows, over 100 or 77 valid rows."""
    b = 6
    inp, want = _synthetic_tile(cuda, case, b, s, 100, n_valid, 7 + s)
    kbb = None
    if farthest:
        kbb = torch.as_tensor(np.random.default_rng(s).uniform(0, 1, size=(b, s, s)).astype(
            np.float32), device=cuda)
    got, _ = _assert_layouts_equal_plain(monkeypatch, inp, kbb, b, s)
    absorbed = (got[5] - inp[3][5]).cpu().numpy()
    if case in ("none", "every") or (case == "spikes" and s >= 8):
        np.testing.assert_array_equal(absorbed, want)
    else:
        assert (absorbed > 0).all()


@pytest.mark.parametrize("eviction", ["smallest-coef", "farthest-point"])
def test_rows_layouts_over_an_evicting_pass(cuda, monkeypatch, eviction):
    """S = 4 over 6 tiles: the buffers fill in the first tile and evict in
    every later one. The pass through each R1 layout, reached through the
    budget (staged, then the registers layout), equals the plain path bit
    for bit, one launch a tile."""
    X, Y, cs = _bank_data(10, 6 * 64 - 5, 12, 11)
    Xd, Yd, csd = (torch.as_tensor(a, device=cuda) for a in (X, Y, cs))
    kw = dict(kernel="rbf", coreset_size=4, eviction=eviction, variant="exact", block_n=64,
              s_tile=None, stream_dtype=None)
    want = _fit_kernel_bank(Xd, Yd, csd, 1.0, plain=True, **kw)
    far = eviction == "farthest-point"
    names = []
    spy = _rows_plan_spy(monkeypatch)
    for plan in rows_layouts(10, 4, farthest=far):
        budget = sum(plan["smem"].values())
        before = kernel_bank_rows.launches
        got = _fit_kernel_bank(Xd, Yd, csd, 1.0, smem_budget=budget, **kw)
        assert kernel_bank_rows.launches == before + 6
        assert spy[-6:] == [plan] * 6
        names.append(plan["layout"])
        for leaf in got._fields:
            assert torch.equal(getattr(got, leaf), getattr(want, leaf)), (names[-1], leaf)
    assert names == ["staged", "registers"]
    assert int(want.m.sum()) > int((want.idx >= 0).sum())  # evictions ran


@pytest.mark.parametrize("eviction", ["smallest-coef", "farthest-point"])
@pytest.mark.parametrize("s", [129, 256])
def test_fit_kernel_bank_beyond_128_slots_matches_the_plain_path(cuda, eviction, s):
    """fit_kernel_bank(coreset_size > 128) runs on the card through B5 and
    R1 and equals the plain path's bank bit for bit, evicting."""
    rng = np.random.default_rng(s)
    b, n, d = 30, 600, 16
    X = rng.normal(size=(n, d)).astype(np.float32)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    X *= (1.01 ** np.arange(n))[:, None]  # norms grow: every model absorbs past S
    Y = np.sign(rng.normal(size=(b, n))).astype(np.float32)
    Y[Y == 0] = 1.0
    Xd = torch.as_tensor(X.astype(np.float32), device=cuda)
    Yd = torch.as_tensor(Y, device=cuda)
    csd = torch.as_tensor(np.exp(rng.uniform(-1, 3, size=b)).astype(np.float32), device=cuda)
    kw = dict(kernel="linear", coreset_size=s, eviction=eviction, variant="exact",
              block_n=128, s_tile=None, stream_dtype=None)
    before = kernel_bank_rows.launches
    got = _fit_kernel_bank(Xd, Yd, csd, 1.0, **kw)
    assert kernel_bank_rows.launches == before + 5
    want = _fit_kernel_bank(Xd, Yd, csd, 1.0, plain=True, **kw)
    for leaf in got._fields:
        assert torch.equal(getattr(got, leaf), getattr(want, leaf)), leaf
    assert int(got.m.sum()) > int((got.idx >= 0).sum())  # evictions ran


@pytest.mark.parametrize("eviction", ["smallest-coef", "farthest-point"])
@pytest.mark.parametrize("stream_dtype", [None, "bf16"])
def test_fit_kernel_bank_on_the_card_matches_the_cpu(cuda, eviction, stream_dtype):
    rng = np.random.default_rng(5)
    b, n, d = 12, 700, 40
    X = rng.normal(size=(n, d)).astype(np.float32)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    Y = np.sign(rng.normal(size=(b, n))).astype(np.float32)
    Y[Y == 0] = 1.0
    cs = np.exp(rng.uniform(-1, 3, size=b)).astype(np.float32)
    kw = dict(coreset_size=16, eviction=eviction, block_n=128, stream_dtype=stream_dtype)
    got = fit_kernel_bank(X, Y, cs, device=cuda, **kw)
    want = fit_kernel_bank(X, Y, cs, device="cpu", **kw)
    assert torch.equal(got.idx.cpu(), want.idx) and torch.equal(got.m.cpu(), want.m)
    assert torch.equal(got.points.cpu(), want.points)
    for name in ("coef", "q", "r", "xi2"):
        torch.testing.assert_close(getattr(got, name).cpu(), getattr(want, name),
                                   rtol=1e-4, atol=1e-5)
    tiled = fit_kernel_bank(X, Y, cs, device=cuda, s_tile=5, **kw)
    for a, b_ in zip(got, tiled):
        assert torch.equal(a, b_)


# ---------------------------------------------------------------------------
# B6: the ring (bank_resident="hbm")
# ---------------------------------------------------------------------------


_FLOOR = sum(SCAN_SMEM.values())  # the chunked kernels' bytes, whatever B and D


def _ring_args(cuda, bp, n, d, seed, dtype=torch.float32):
    X, Y, cs = _bank_data(bp, n + 1, d, seed)
    t = lambda a, dt=torch.float32: torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=cuda)
    return (t(X[1:]).to(dtype), t(Y[:, 1:]).to(dtype), t(Y[:, :1] * X[:1]), t(np.zeros(bp)),
            t(1 / cs), t(1 / cs), t(np.ones(bp), torch.int32), t(1 / cs))


@pytest.mark.parametrize("d", [20, 90, 784, 1500, 4096])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lookahead", [False, True])
@pytest.mark.parametrize("budget", [None, _FLOOR - 1])
def test_ring_equals_b1_b3_at_every_j(cuda, d, dtype, lookahead, budget):
    """n_ctas giving J = 1, 2, 3, 4, 5 tiles per CTA, ragged N and n_valid, in
    each layout: owned rows at J <= 2 where they fit and cycling 128-column
    chunks beyond (the card's budget), the lean 32-column layout under a
    budget below the chunked kernels' bytes. D = 90 (and 1500 in bf16)
    copies w and the stream without 16-byte copies."""
    bp, n = 32, 600
    args = _ring_args(cuda, bp, n, d, seed=d, dtype=dtype)
    kw = dict(n_valid=n - 7, block_n=n)
    if lookahead:
        kw.update(lookahead=torch.tensor([(1, 2, 3, 7)[i % 4] for i in range(bp)],
                                         dtype=torch.int32, device=cuda), lookahead_max=7)
        ref = streamsvm_scan_lookahead_many(*args, **kw)
        ring, counter = streamsvm_scan_lookahead_many_ring, streamsvm_scan_lookahead_many_ring
    else:
        ref = streamsvm_scan_many(*args, **kw)
        ring, counter = streamsvm_scan_many_ring, streamsvm_scan_many_ring
    layouts = []
    for n_ctas, j in ((4, 1), (2, 2), (1, 4)):
        plan = ring_plan(bp, d, lookahead=lookahead, n_ctas=n_ctas, dtype=dtype,
                         smem_budget=budget)
        assert plan["jmax"] == j and sum(plan["smem"].values()) <= (budget or 232_448)
        layouts.append(plan["layout"])
        before = counter.launches
        got = ring(*args, n_ctas=n_ctas, smem_budget=budget, **kw)
        assert counter.launches == before + 1
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
    assert layouts[2] == ("cycling" if budget is None else "lean")
    # J = 3 (odd) and J = 5 (cycling: a step of 4 tiles, then one of 1).
    for bj in (24, 40):
        argsj = _ring_args(cuda, bj, n, d, seed=d + bj, dtype=dtype)
        kwj = dict(kw)
        if lookahead:
            kwj["lookahead"] = torch.tensor([(1, 2, 3, 7)[i % 4] for i in range(bj)],
                                            dtype=torch.int32, device=cuda)
            refj = streamsvm_scan_lookahead_many(*argsj, **kwj)
        else:
            refj = streamsvm_scan_many(*argsj, **kwj)
        for a, b in zip(ring(*argsj, n_ctas=1, smem_budget=budget, **kwj), refj):
            assert torch.equal(a, b)


def _padded_args(cuda, b, n, d, seed, dtype=torch.float32):
    """B1's / B3's padded inputs for b live models: the bank padded to whole
    lane groups with inert lanes (r = +inf, sign 0, C = gain = 1), sign-0
    rows, ragged N. Returns (args, bp)."""
    bp = -(-b // 8) * 8
    X, Y, cs = _bank_data(b, n + 1, d, seed)
    Yp = np.zeros((bp, n + 1), np.float32)
    Yp[:b] = Y
    live = np.arange(bp) < b
    c_inv = np.where(live, 1 / np.pad(cs, (0, bp - b), constant_values=1.0), 1.0)
    W0 = Yp[:, :1] * X[:1]
    t = lambda a, dt=torch.float32: torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=cuda)
    args = (t(X[1:]).to(dtype), t(Yp[:, 1:]).to(dtype), t(W0), t(np.where(live, 0.0, np.inf)),
            t(c_inv), t(c_inv), t(np.ones(bp), torch.int32), t(c_inv))
    return args, bp


def _assert_state_close(got, want, b, keep=None):
    """The first b models' states within the engine tolerance, ``m`` equal;
    ``keep`` (a (b,) mask) leaves out the models it clears."""
    sel = slice(None) if keep is None else keep.cpu()
    got, want = [x[:b].cpu()[sel] for x in got], [x[:b].cpu()[sel] for x in want]
    torch.testing.assert_close(got[0], want[0], rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=0.0)
    torch.testing.assert_close(got[2], want[2], rtol=1e-3, atol=1e-6)
    assert torch.equal(got[3], want[3])


def _plan_spy(monkeypatch):
    """The plans the wrappers take, recorded as they launch."""
    seen, real = [], scan_mod.scan_plan

    def spy(*args, **kw):
        seen.append(real(*args, **kw))
        return seen[-1]

    monkeypatch.setattr(scan_mod, "scan_plan", spy)
    return seen


@pytest.mark.parametrize("b,d,n", [
    (1, 784, 700), (8, 784, 700), (9, 4096, 300), (600, 784, 300),
    (16, 16_384, 100),  # no tile fits: the chunked kernel
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b1_equals_the_ring_in_its_layout(cuda, monkeypatch, b, d, n, dtype):
    """B1 in the layout scan_plan picks is bit-equal to the ring and within
    the engine tolerance of its plain version: ragged N (not a multiple of
    the 32-row block), n_valid < N, sign-0 rows, padded lanes."""
    args, bp = _padded_args(cuda, b, n, d, seed=b + d, dtype=dtype)
    kw = dict(n_valid=n - 5, block_n=n)
    plan = scan_plan(bp, d, dtype=dtype)
    assert plan["layout"] == ("chunked" if d == 16_384 else "resident")
    ref = streamsvm_scan_many_ring(*args, **kw)
    before = streamsvm_scan_many.launches
    seen = _plan_spy(monkeypatch)
    got = streamsvm_scan_many(*args, **kw)
    assert streamsvm_scan_many.launches == before + 1
    assert seen == [plan]
    for a, c in zip(got, ref):
        assert torch.equal(a, c)
    _assert_state_close(got, streamsvm_scan_many_plain(*args, **kw), b)


@pytest.mark.parametrize("d,budget,want", [
    (20, None, ("resident", 8)), (130, None, ("resident", 8)), (784, None, ("resident", 8)),
    (20, 60_000, ("resident", 8)), (130, 60_000, ("resident", 8)),  # 8 models fit
    (784, 60_000, ("resident", 4)),
    (20, _FLOOR, ("chunked", 8)), (130, _FLOOR, ("chunked", 8)), (784, _FLOOR, ("chunked", 8)),
])
def test_b1_layouts_give_the_same_bits(cuda, monkeypatch, d, budget, want):
    """8 or 4 models per CTA, and the chunked kernel, each taken under the
    budget it fits, at an aligned D, at D = 130 (rows not 16-byte aligned:
    plain staging) and at D = 20."""
    args, bp = _padded_args(cuda, 13, 500, d, seed=d)
    kw = dict(n_valid=490, block_n=500)
    ref = streamsvm_scan_many_ring(*args, **kw)
    seen = _plan_spy(monkeypatch)
    got = streamsvm_scan_many(*args, **kw, smem_budget=budget)
    assert [(p["layout"], p["models_per_cta"]) for p in seen] == [want]
    for a, c in zip(got, ref):
        assert torch.equal(a, c)


def _lookahead(cuda, b, bp, ls):
    mix = (1, 2, 3, 7, 10, 50, 4, 16)
    ls = [mix[i % len(mix)] for i in range(b)] if ls == "mix" else [ls] * b
    return torch.tensor(ls + [1] * (bp - b), dtype=torch.int32, device=cuda), max(ls)


def _lookahead_parting_tie(kernel, plain, args, kw, n, model):
    """Where B3's and its plain version's push decisions for ``model``
    first part (bisecting n_valid: ``m`` counts the pushes of the rows
    before it), and the exact margin there: Algorithm 2 for the model alone
    in float64 (pushes into an L-row window, each full window flushed
    farthest-first) up to that row gives ``(row, dist, r, bound)``, with
    ``bound`` the f32 error of evaluating dist there as
    ``chip_smoke.parting_tie`` bounds it: (D + 2) u times the absolute
    terms of d^2, over 2 dist. The float64 run must agree with the plain
    version's pushes before the row."""
    m_at = lambda fn, nv: int(fn(*args, **{**kw, "n_valid": nv})[3][model])
    lo, hi = 0, n
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if m_at(kernel, mid) == m_at(plain, mid):
            lo = mid
        else:
            hi = mid
    X, Y, W0, r0, xi20, c_inv, m0, gain = (t.double().cpu() for t in args)
    L = int(kw["lookahead"][model])
    w, r, xi2 = W0[model].clone(), r0[model].clone(), xi20[model].clone()
    ci, ga, d = c_inv[model], gain[model], X.shape[1]
    window, pushes = [], 0
    for i in range(lo + 1):
        y, x = Y[model, i], X[i]
        if y == 0:
            continue
        dist = torch.sqrt((w @ w) - 2 * y * (w @ x) + (x @ x) + xi2 + ci)
        if i == lo:
            assert pushes == m_at(plain, lo) - int(m0[model])
            terms = (w @ w) + 2 * w.norm() * x.norm() + (x @ x) + xi2 + ci
            bound = (d + 2) * 2.0**-24 * terms / (2 * dist)
            return lo, float(dist), float(r), float(bound)
        if dist < r:
            continue
        window.append(y * x)
        pushes += 1
        if len(window) >= L:  # the farthest-first flush: the first maximum wins
            while window:
                far = [float(torch.sqrt(((w - p) ** 2).sum() + xi2 + ci)) for p in window]
                k = far.index(max(far))
                if far[k] < r:
                    break  # every remaining point is enclosed: the window is dropped
                s = 0.5 * (1 - r / far[k])
                w, r = (1 - s) * w + s * window.pop(k), r + 0.5 * (far[k] - r)
                xi2 = xi2 * (1 - s) ** 2 + s * s * ga
            window = []
    raise AssertionError(f"model {model}: the parting row {lo} is inert")


@pytest.mark.parametrize("b,d,n,ls,layout,window", [
    (1, 784, 700, 2, "small", "smem"),
    (1, 784, 700, 10, "small", "smem"),
    (1, 784, 700, 50, "small", "smem"),
    (8, 784, 500, "mix", "small", "smem"),
    (9, 4096, 300, 10, "small", "smem"),
    (1, 4096, 300, 50, "small", "device"),  # the window does not fit beside the row
    (600, 784, 300, 10, "resident", "device"),
    (140, 16_384, 100, 3, "chunked", "device"),  # past the small layout, no tile fits
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b3_equals_the_ring_in_its_layout(cuda, monkeypatch, b, d, n, ls, layout, window, dtype):
    """B3 with the live count ops passes: the layout and window placement
    scan_plan picks, bit-equal to the ring (which walks every lane) and
    within the engine tolerance of its plain version. A model whose push
    count parts from the plain version (at most one; ROADMAP section C
    records it) must part on a decision that float64 shows to be an f32
    tie; the other models are held to the plain version as before."""
    args, bp = _padded_args(cuda, b, n, d, seed=3 * b + d, dtype=dtype)
    L, lmax = _lookahead(cuda, b, bp, ls)
    kw = dict(lookahead=L, lookahead_max=lmax, n_valid=n - 5, block_n=n)
    plan = scan_plan(bp, d, lookahead_max=lmax, n_live=b, dtype=dtype)
    assert (plan["layout"], plan["window"]) == (layout, window)
    ref = streamsvm_scan_lookahead_many_ring(*args, **kw)
    before = streamsvm_scan_lookahead_many.launches
    seen = _plan_spy(monkeypatch)
    got = streamsvm_scan_lookahead_many(*args, **kw, n_live=b)
    assert streamsvm_scan_lookahead_many.launches == before + 1
    assert seen == [plan]
    for a, c in zip(got, ref):
        assert torch.equal(a, c)
    want = streamsvm_scan_lookahead_many_plain(*args, **kw)
    keep = got[3][:b] == want[3][:b]
    parted = (~keep).nonzero().flatten().tolist()
    assert len(parted) <= 1, f"m parts from the plain version at models {parted}"
    for model in parted:
        kernel = lambda *a, **k: streamsvm_scan_lookahead_many(*a, **k, n_live=b)
        row, dist, r, bound = _lookahead_parting_tie(
            kernel, streamsvm_scan_lookahead_many_plain, args, kw, n - 5, model)
        print(f"D={d} {dtype}: model {model} parts at row {row}: float64 dist {dist!r}, "
              f"r {r!r}, (dist - r)/r {(dist - r) / r:.3e}, f32 bound {bound / r:.3e} of r")
        assert abs(dist - r) <= bound, f"model {model} parts at row {row} beyond an f32 tie"
    _assert_state_close(got, want, b, keep)


@pytest.mark.parametrize("d,small_max,budget,want", [
    (d, *case) for d in (20, 130, 784) for case in (
        (None, None, ("small", 1)),
        (0, None, ("resident", 8)),
        (0, 55_000, ("resident", 4 if d == 784 else 8)),  # 8 models fit at small D
        (0, _FLOOR, ("chunked", 8)),
    )
])
def test_b3_layouts_give_the_same_bits(cuda, monkeypatch, d, small_max, budget, want):
    """Every layout of B3 at per-model windows, with every lane live (the
    small layout then gives padded lanes a CTA too) and with 13 of 16: the
    small layout, and with it switched off (SMALL_BANK_MAX_LIVE 0) 8 or 4
    models per CTA and the chunked kernel, each under the budget it fits."""
    if small_max is not None:
        monkeypatch.setattr(scan_mod, "SMALL_BANK_MAX_LIVE", small_max)
    seen = _plan_spy(monkeypatch)
    for b in (16, 13):
        args, bp = _padded_args(cuda, b, 500, d, seed=d + b)
        L, lmax = _lookahead(cuda, b, bp, "mix")
        kw = dict(lookahead=L, lookahead_max=lmax, n_valid=490, block_n=500)
        ref = streamsvm_scan_lookahead_many_ring(*args, **kw)
        got = streamsvm_scan_lookahead_many(*args, **kw, n_live=b, smem_budget=budget)
        assert (seen[-1]["layout"], seen[-1]["models_per_cta"]) == want
        for a, c in zip(got, ref):
            assert torch.equal(a, c)


def test_fit_lookahead_takes_the_small_layout(cuda, monkeypatch):
    """fit_lookahead (one model) and fit_bank(variant="lookahead") reach the
    small layout through the normal entry point, with the live count."""
    rng = np.random.default_rng(12)
    X = rng.normal(size=(900, 784)).astype(np.float32)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    y = np.sign(rng.normal(size=900)).astype(np.float32)
    seen = _plan_spy(monkeypatch)
    got = fit_lookahead(X, y, 10.0, 10, device=cuda)
    assert [(p["layout"], p["ctas"]) for p in seen] == [("small", 1)]
    _assert_ball_close(got, fit_lookahead(X, y, 10.0, 10, device="cpu"))


@pytest.mark.parametrize("lookahead,budget,want", [
    (None, _FLOOR, ("chunked", 8, None)),
    (None, 45_000, ("chunked", 8, None)),
    (None, 60_000, ("resident", 4, None)),
    (None, 64_031, ("resident", 4, None)),
    (3, _FLOOR, ("chunked", 8, "device")),
    (3, 45_000, ("small", 1, "device")),
    (3, 60_000, ("small", 1, "smem")),
])
def test_vmem_under_a_squeezed_budget_equals_the_ring(cuda, monkeypatch, lookahead, budget,
                                                      want):
    """A budget between the chunked kernels' 25,888 B and the resident
    tile's 64,032 B at D = 784: "vmem" (forced, and "auto") runs B1 / B3 in
    the layout that fits it (4 models per CTA, B3's small layout with its
    window in device or shared memory, or the chunked kernels) and equals
    the ring bit for bit."""
    X, Y, cs = _bank_data(61, 500, 784, seed=19)
    kw = {} if lookahead is None else dict(variant="lookahead", lookahead=lookahead)
    ring = ops.streamsvm_fit_many(X, Y, cs, device=cuda, bank_resident="hbm", **kw)
    seen = _plan_spy(monkeypatch)
    for res in ("vmem", "auto"):
        got = ops.streamsvm_fit_many(X, Y, cs, device=cuda, bank_resident=res,
                                     vmem_budget_bytes=budget, **kw)
        for a, b in zip(got, ring):
            assert torch.equal(a, b)
    assert [(p["layout"], p["models_per_cta"], p["window"]) for p in seen] == [want] * 2
    assert sum(seen[0]["smem"].values()) <= budget


def test_ring_matches_its_plain_version(cuda):
    args = _ring_args(cuda, 40, 700, 130, seed=4)
    got = streamsvm_scan_many_ring(*args, n_valid=690, block_n=700, n_ctas=2)
    want = streamsvm_scan_many_ring_plain(*args, n_valid=690, block_n=700, ring_tile=8, n_ctas=2)
    torch.testing.assert_close(got[0], want[0], rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=0.0)
    torch.testing.assert_close(got[2], want[2], rtol=1e-3, atol=1e-6)
    assert torch.equal(got[3], want[3])


def test_hbm_end_to_end_equals_vmem_on_the_card(cuda):
    X, Y, cs = _bank_data(61, 500, 50, seed=3)
    for kw in ({}, dict(variant="lookahead", lookahead=4)):
        fits = [ops.streamsvm_fit_many(X, Y, cs, device=cuda, b_tile=8, bank_resident=res, **kw)
                for res in ("vmem", "hbm")]
        for a, b in zip(*fits):
            assert torch.equal(a, b)
    squeeze = sum(SCAN_SMEM.values()) - 1  # under the vmem path's smallest layout
    auto = ops.streamsvm_fit_many(X, Y, cs, device=cuda, b_tile=8, vmem_budget_bytes=squeeze)
    vmem = ops.streamsvm_fit_many(X, Y, cs, device=cuda, b_tile=8, bank_resident="vmem")
    for a, b in zip(auto, vmem):
        assert torch.equal(a, b)


@pytest.mark.parametrize("lookahead", [None, 3])
def test_auto_squeezed_at_a_real_width_runs_the_cycling_ring(cuda, lookahead):
    """Under a budget just below the vmem path's smallest layout (the
    chunked kernels, 25,888 B) at D = 784, "auto" launches the ring in its
    lean layout (32-column chunks cycled; owned rows and 128-column chunks
    do not fit) and equals "vmem" bit for bit."""
    X, Y, cs = _bank_data(61, 500, 784, seed=9)
    kw = {} if lookahead is None else dict(variant="lookahead", lookahead=lookahead)
    ring = streamsvm_scan_many_ring if lookahead is None else streamsvm_scan_lookahead_many_ring
    squeeze = sum(SCAN_SMEM.values()) - 1
    before = ring.launches
    auto = ops.streamsvm_fit_many(X, Y, cs, device=cuda, vmem_budget_bytes=squeeze, **kw)
    assert ring.launches == before + 1
    vmem = ops.streamsvm_fit_many(X, Y, cs, device=cuda, bank_resident="vmem", **kw)
    for a, b in zip(auto, vmem):
        assert torch.equal(a, b)


@pytest.mark.parametrize("epilogue,kw", [
    ("scores", {}), ("ovr", {"nc_pad": 24, "b_tile": 48}), ("topk", {"k": 7}),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_predict_ring_equals_b2(cuda, epilogue, kw, dtype):
    rng = np.random.default_rng(5)
    Q = torch.as_tensor(rng.normal(size=(300, 200)).astype(np.float32), device=cuda).to(dtype)
    W = torch.as_tensor(rng.normal(size=(96, 200)).astype(np.float32), device=cuda)
    W[7] = W[3]  # a tie: the lower lane wins in both
    bias = torch.zeros(96, device=cuda)
    bias[-5:] = -3.0e38
    before = predict_bank_ring.launches
    got = predict_bank_ring(Q, W, bias, epilogue=epilogue, q_block=300, **kw)
    assert predict_bank_ring.launches == before + 1
    want = predict_bank_fused(Q, W, bias, epilogue=epilogue, q_block=300, **kw)
    plain = predict_bank_ring_plain(Q, W, bias, epilogue=epilogue, q_block=300, **kw)
    got, want, plain = ((x if isinstance(x, tuple) else (x,)) for x in (got, want, plain))
    for g, w, p in zip(got, want, plain):
        assert torch.equal(g, w)
        if p.dtype == torch.int32:
            assert torch.equal(g, p)
        else:
            torch.testing.assert_close(g, p, rtol=2e-4, atol=2e-5 * max(1.0, p.abs().max().item()))


def _both_kernels(Q, W, bias, **kw):
    """B2's and the ring's results, each a tuple, the ring held to B2 bit
    for bit; returns B2's."""
    b2 = predict_bank_fused(Q, W, bias, **kw)
    ring = predict_bank_ring(Q, W, bias, **kw)
    b2, ring = ((x if isinstance(x, tuple) else (x,)) for x in (b2, ring))
    for a, r in zip(b2, ring):
        assert torch.equal(a, r)
    return b2


def _tied_bank(cuda, b, d, ties, seed):
    """A bank of small random rows where each tuple of lanes in ``ties``
    holds one large row, bit-identical across the tuple, and queries near
    those rows: each tuple's lanes tie exactly and beat the rest of their
    group."""
    rng = np.random.default_rng(seed)
    W = 0.01 * rng.normal(size=(b, d)).astype(np.float32)
    rows = rng.normal(size=(len(ties), d)).astype(np.float32)
    for row, lanes in zip(rows, ties):
        W[list(lanes)] = row
    Q = rows[rng.integers(0, len(ties), size=300)] + 0.1 * rng.normal(size=(300, d))
    return (torch.as_tensor(Q.astype(np.float32), device=cuda),
            torch.as_tensor(W, device=cuda), torch.zeros(b, device=cuda))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ovr_ties_across_tiles_and_clusters_go_to_the_lowest_lane(cuda, dtype):
    """Duplicated bank rows in different 64-lane tiles (B2's CTAs) and in
    different CTAs of the ring's cluster, within one group (nc_pad = 256, so
    every group spans four tiles) and repeated across groups: each group's
    winner is its lowest tied lane, in both kernels, bit for bit equal."""
    nc_pad, d = 256, 96
    ties = [(10, 200), (63, 64), (127, 128, 255), (300, 450, 700), (767, 768, 1000)]
    Q, W, bias = _tied_bank(cuda, 1024, d, ties, seed=41)
    Q = Q.to(dtype)
    cls, margin = _both_kernels(Q, W, bias, epilogue="ovr", q_block=300, nc_pad=nc_pad,
                                b_tile=nc_pad)
    s = Q.float() @ W.T
    for g in range(1024 // nc_pad):
        grp = s[:, g * nc_pad : (g + 1) * nc_pad]
        top = grp.amax(dim=1)
        for lanes in ties:
            inside = [l - g * nc_pad for l in lanes if l // nc_pad == g]
            if not inside:
                continue
            won = grp[:, inside[0]] == top  # queries this tuple wins (near its row)
            assert won.sum() > 10
            assert (cls[won, g] == inside[0]).all()  # the lowest tied lane
    want = predict_bank_plain(Q, W, bias, epilogue="ovr", q_block=300, nc_pad=nc_pad,
                              b_tile=nc_pad)[1]
    torch.testing.assert_close(margin, want, rtol=2e-4,
                               atol=2e-5 * max(1.0, want.abs().max().item()))


def test_topk_ties_across_tiles_go_to_the_lowest_lane(cuda):
    """topk walks the whole bank in one CTA per query tile: exact ties
    across tiles keep lane order, in both kernels."""
    Q, W, bias = _tied_bank(cuda, 320, 40, [(5, 70, 300), (64, 65)], seed=43)
    vals, ids = _both_kernels(Q, W, bias, epilogue="topk", q_block=300, k=3)
    first = (Q @ W.T)[:, 5] > (Q @ W.T)[:, 64]  # the queries near the first row
    assert first.sum() > 10 and (~first).sum() > 10
    assert (ids[first] == torch.tensor([5, 70, 300], device=cuda, dtype=torch.int32)).all()
    assert (vals[first, 0] == vals[first, 1]).all() and (vals[first, 1] == vals[first, 2]).all()
    assert (ids[~first, :2] == torch.tensor([64, 65], device=cuda, dtype=torch.int32)).all()


@pytest.mark.parametrize("b,k", [(1000, 727), (1000, 728), (1000, 1000), (1536, 1536)])
@pytest.mark.parametrize("d", [33, 784])
def test_topk_at_any_k_matches_plain(cuda, b, k, d):
    """k up to B: past 727 the lists live in the outputs (device memory) in
    both kernels, bit-equal to each other, with the plain version's ids
    where the scores are separated."""
    rng = np.random.default_rng(b + k + d)
    Q = torch.as_tensor(rng.normal(size=(300, d)).astype(np.float32), device=cuda)
    W = torch.as_tensor(rng.normal(size=(b, d)).astype(np.float32), device=cuda)
    bias = torch.zeros(b, device=cuda)
    bias[-7:] = -3.0e38  # padded lanes never enter a list ahead of a live one
    before = (predict_bank_fused.launches, predict_bank_ring.launches)
    vals, ids = _both_kernels(Q, W, bias, epilogue="topk", q_block=300, k=k)
    assert (predict_bank_fused.launches, predict_bank_ring.launches) == (before[0] + 1,
                                                                         before[1] + 1)
    want_v, want_i = predict_bank_plain(Q, W, bias, epilogue="topk", q_block=300, k=k)
    torch.testing.assert_close(vals, want_v, rtol=2e-4,
                               atol=2e-5 * max(1.0, want_v[:, : b - 7].abs().max().item()))
    gaps = want_v[:, :-1] - want_v[:, 1:]
    sep = torch.ones_like(vals, dtype=torch.bool)
    tol = 1e-5 * want_v[:, 0].abs().max()
    sep[:, 1:] &= gaps > tol
    sep[:, :-1] &= gaps > tol
    assert torch.equal(ids[sep], want_i[sep])
    assert (torch.diff(vals, dim=1) <= 0).all()


def test_topk_ties_past_the_shared_lists_go_to_the_lowest_lane(cuda):
    """The device-memory lists keep lane order on exact ties across tiles."""
    Q, W, bias = _tied_bank(cuda, 1000, 40, [(5, 70, 900), (64, 999)], seed=44)
    vals, ids = _both_kernels(Q, W, bias, epilogue="topk", q_block=300, k=800)
    first = (Q @ W.T)[:, 5] > (Q @ W.T)[:, 64]
    assert first.sum() > 10 and (~first).sum() > 10
    assert (ids[first, :3] == torch.tensor([5, 70, 900], device=cuda, dtype=torch.int32)).all()
    assert (ids[~first, :2] == torch.tensor([64, 999], device=cuda, dtype=torch.int32)).all()
    assert (vals[first, 0] == vals[first, 2]).all()


@pytest.mark.parametrize("d", [33, 785])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ovr_groups_straddling_tiles_match_plain(cuda, d, dtype):
    """nc_pad = 200 lanes, so groups straddle the kernels' 64-lane tiles;
    D = 33 and 785 are not whole k-steps (nor whole 16-byte copies in bf16
    at 33); Q = 300 and B = 1,000 leave ragged query and lane tiles."""
    rng = np.random.default_rng(d)
    Q = torch.as_tensor(rng.normal(size=(300, d)).astype(np.float32), device=cuda).to(dtype)
    W = torch.as_tensor(rng.normal(size=(1000, d)).astype(np.float32), device=cuda)
    bias = torch.zeros(1000, device=cuda)
    bias[torch.arange(1000, device=cuda) % 200 >= 195] = -3.0e38  # each group's padded lanes
    kw = dict(epilogue="ovr", q_block=300, nc_pad=200, b_tile=200)
    before = (predict_bank_fused.launches, predict_bank_ring.launches)
    cls, margin = _both_kernels(Q, W, bias, **kw)
    assert (predict_bank_fused.launches, predict_bank_ring.launches) == (before[0] + 1,
                                                                         before[1] + 1)
    want_cls, want = predict_bank_plain(Q, W, bias, **kw)
    torch.testing.assert_close(margin, want, rtol=2e-4,
                               atol=2e-5 * max(1.0, want.abs().max().item()))
    top2 = (Q.float() @ W.T + bias).reshape(300, 5, 200).topk(2, dim=-1).values
    sep = (top2[..., 0] - top2[..., 1]) > 1e-5 * top2.abs().max()
    assert torch.equal(cls[sep], want_cls[sep])
    assert (cls < 195).all()


@pytest.mark.parametrize("epilogue", ["scores", "ovr"])
def test_served_step_equals_the_whole_launch(cuda, epilogue):
    """A 256-query step (the small tile, 64-CTA cluster walk) and one
    10,240-query launch (the large tile) give the same bits for the same
    rows, in both kernels: each margin is the same ascending fmaf chain."""
    rng = np.random.default_rng(7)
    Q = torch.as_tensor(rng.normal(size=(10_240, 784)).astype(np.float32), device=cuda)
    W = torch.as_tensor(rng.normal(size=(600, 784)).astype(np.float32), device=cuda)
    bias = torch.zeros(600, device=cuda)
    kw = dict(epilogue=epilogue, q_block=256)
    if epilogue == "ovr":
        kw.update(nc_pad=200, b_tile=200)
    whole = _both_kernels(Q, W, bias, **kw)
    for q0 in (0, 256 * 17, 10_240 - 256):
        step = _both_kernels(Q[q0 : q0 + 256], W, bias, **kw)
        for a, b in zip(step, whole):
            assert torch.equal(a, b[q0 : q0 + 256])


def test_ring_beyond_the_cards_shared_memory_is_refused(cuda):
    """A budget above the card's 232,448 B lets the preflight pass a layout
    the card cannot hold; the launch is then refused with a RuntimeError and
    nothing runs (here 200 tiles on one CTA: ~260 KB in the lean layout)."""
    bp = 1600
    args = _ring_args(cuda, bp, 64, 16, seed=1)
    assert sum(ring_plan(bp, 16, lookahead=False, n_ctas=1)["smem"].values()) > 232_448
    before = streamsvm_scan_many_ring.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        streamsvm_scan_many_ring(*args, n_valid=64, block_n=64, n_ctas=1)
    torch.cuda.synchronize()  # no fault was left behind
    assert streamsvm_scan_many_ring.launches == before


def test_byte_models_equal_what_the_kernels_allocate(cuda):
    """Static shared memory from ptxas plus the dynamic bytes of the launch
    equal each byte model's total."""
    from repro_torch.kernels import kernel_bank as kb_mod
    from repro_torch.kernels import streamsvm_scan as scan_mod
    from repro_torch.kernels import predict as predict_mod

    _build.build()
    lib, plib = scan_mod._lib(), predict_mod._lib()
    assert _build.static_smem("streamsvm_scan", "scan_kernel") == {25_888}
    assert _build.static_smem("streamsvm_scan", "lookahead_kernel") == {25_888}
    assert _build.static_smem("predict", "predict_kernel") == {46_096}
    assert sum(ops.engine_vmem_bytes(600, 784).values()) == 64_032
    # The resident and small layouts: no static bytes, their dynamic
    # request equal to the byte model at every shape and stream dtype.
    assert _build.static_smem("streamsvm_scan", "scan_res_kernel") == {0}
    assert _build.static_smem("streamsvm_scan", "lookahead_small_kernel") == {0}
    for dt in (torch.float32, torch.bfloat16):
        bf = int(dt == torch.bfloat16)
        for d in (20, 130, 784, 4096, 12_288):
            for mpc in (4, 8):
                for look in (0, 1):
                    assert lib.streamsvm_scan_resident_dyn_bytes(d, mpc, look, bf) == sum(
                        resident_smem(d, mpc, lookahead=bool(look), dtype=dt).values())
            for lmax, win in ((2, 1), (50, 1), (50, 0), (1024, 0)):
                assert lib.streamsvm_scan_small_dyn_bytes(d, lmax, win, bf) == sum(
                    small_smem(d, lmax, window_in_smem=bool(win), dtype=dt).values())
    for b, d, la, budget in ((600, 784, None, None), (600, 784, 10, None), (1, 784, 50, None),
                             (1536, 4096, None, None), (1536, 8192, None, None),
                             (16, 12_288, None, None), (600, 784, None, 60_000),
                             (600, 784, 10, 60_000), (1, 784, 10, 60_000),
                             (600, 784, 10, 25_888)):
        plan = scan_plan(-(-b // 8) * 8, d, lookahead_max=la, n_live=b, smem_budget=budget)
        if plan["layout"] == "chunked":
            static, dyn = SCAN_SMEM, 0
        elif plan["layout"] == "small":
            static, dyn = {}, lib.streamsvm_scan_small_dyn_bytes(
                d, la, int(plan["window"] == "smem"), 0)
        else:
            static, dyn = {}, lib.streamsvm_scan_resident_dyn_bytes(
                d, plan["models_per_cta"], int(la is not None), 0)
        assert sum(static.values()) + dyn == sum(ops.engine_vmem_bytes(
            b, d, lookahead_max=la, smem_budget=budget).values()) <= (budget or 232_448)
    # The ring: no static bytes, its dynamic request equal to the byte model
    # in every layout and stream dtype.
    assert _build.static_smem("streamsvm_scan", "scan_ring_kernel") == {0}
    layouts = set()
    for b, d, la, budget in ((600, 784, None, None), (600, 784, None, 25_887),
                             (600, 784, 10, 25_887), (1536, 4096, None, None),
                             (1536, 4096, 10, None), (64, 20, 3, None), (1536, 784, 10, None),
                             (4224, 784, None, None), (600, 90, None, 60_000)):
        for dt, sdt in ((torch.float32, None), (torch.bfloat16, "bf16")):
            plan = ring_plan(-(-b // 8) * 8, d, lookahead=la is not None, dtype=dt,
                             smem_budget=budget)
            layouts.add(plan["layout"])
            dyn = lib.streamsvm_scan_ring_dyn_bytes(
                d, plan["jmax"], scan_mod._RING_LAYOUTS[plan["layout"]], int(la is not None),
                int(dt == torch.bfloat16))
            assert dyn == sum(ops.engine_vmem_bytes(
                b, d, lookahead_max=la, bank_resident="hbm", stream_dtype=sdt,
                smem_budget=budget).values())
    assert layouts == {"owned", "cycling", "lean"}
    # B4: no static bytes; its request with w in shared or device memory.
    slib = scan_mod._single_lib()
    assert _build.static_smem("streamsvm_single", "single_kernel") == {0}
    for d in (20, 90, 784, 4096, 65_536):
        plan = scan_mod.single_plan(d)
        assert slib.streamsvm_single_dyn_bytes(d, int(plan["w_in_smem"]), plan["chunk"]) == sum(
            plan["smem"].values()) <= 232_448
        for ws in (0, 1):
            assert slib.streamsvm_single_dyn_bytes(d, ws, scan_mod.SINGLE_DC) == sum(
                scan_mod.single_smem(d, w_in_smem=bool(ws)).values())
    assert slib.streamsvm_single_chunk() == scan_mod.SINGLE_DC
    (pr_static,) = _build.static_smem("predict", "predict_ring_kernel")
    for ep, k in (("scores", None), ("topk", 9)):
        dyn = plib.predict_bank_ring_dyn_bytes({"scores": 0, "topk": 2}[ep], k or 0)
        assert pr_static + dyn == sum(ops.predict_vmem_bytes(
            96, 100, epilogue=ep, k=k, bank_resident="hbm").values())
    assert _build.static_smem("gram", "gram_kernel") == {46_080}
    # R1: no static bytes in any layout; the staged layout's dynamic request
    # equal to the byte model for every S it takes, and the byte model's
    # R1 term that of the planned layout.
    assert _build.static_smem("kernel_bank", "rows_kernel") == {0}
    assert _build.static_smem("kernel_bank", "rows_wide_kernel") == {0}
    assert _build.static_smem("kernel_bank", "rows_staged_kernel") == {0}
    assert sum(ops.kernel_engine_vmem_bytes(600, 784, coreset_size=64).values()) == 46_080 + 35_872
    klib = kb_mod._lib()
    for s in (1, 2, 3, 16, 64, 100, 128, 129, 256, 257, 300, 1100, 9000):
        sp = 1 << (s - 1).bit_length()
        for far in (False, True):
            assert klib.kernel_bank_rows_staged_bytes(s, int(far)) == (
                sum(staged_smem(s, farthest=far).values()) if sp <= 256 else -1)
            plan = rows_plan(600, s, farthest=far)
            dyn = klib.kernel_bank_rows_staged_bytes(s, int(far)) if (
                plan["layout"] == "staged") else 0
            assert ops.kernel_engine_vmem_bytes(600, 784, coreset_size=s, eviction=(
                "farthest-point" if far else "smallest-coef"))["row_recursion"] == dyn <= 232_448
        assert klib.kernel_bank_rows_scratch_bytes(600, s) == (0 if sp <= 256 else 600 * 6 * sp * 4)
    assert plib.predict_bank_max_k() == TOPK_SMEM_MAX_K
    for k in (TOPK_SMEM_MAX_K, TOPK_SMEM_MAX_K + 1, 1536):
        assert pr_static + plib.predict_bank_ring_dyn_bytes(2, k) == sum(ops.predict_vmem_bytes(
            1536, 100, epilogue="topk", k=k, bank_resident="hbm").values())


# ---------------------------------------------------------------------------
# M1: the Sec 4.3 multi-ball recursion
# ---------------------------------------------------------------------------


def _mb_run(fn, X, y, L, c_inv, slack0, **kw):
    st = _start(X, y, L, slack0)
    fn(X[1:], y[1:], *st, c_inv, slack0, **kw)
    return st


def _grid_budget(L, d, rows):
    """A budget that gives the grid ``rows`` rows a CTA (None: the card's)."""
    from repro_torch.kernels.multiball import grid_smem

    return None if rows is None else sum(grid_smem(d, L, rows).values())


def _mb_forced(plan):
    """M1's kernel in ``plan``, whatever ``multiball_plan`` would pick; called
    as ``multiball_scan`` is."""
    from repro_torch.kernels.multiball import _launch

    return lambda *a: _launch(plan, *a)


def _mb_one_cta_plans(L, d):
    """Every one-CTA layout of ``LAYOUTS`` as a plan."""
    from repro_torch.kernels.multiball import LAYOUTS, cta_plan

    return [cta_plan(L, d, xs, ts) for xs, ts in LAYOUTS]


def _mb_stream(cuda, L, d, stream, n=400):
    """Random unit rows at C = 10 or the edge stream at C = 1e4; returns X,
    y on the card and 1/C as an f32 value."""
    if stream == "random":
        X = _bank_data(1, n, d, seed=L * 31 + d)[0]
        y = np.where(np.random.default_rng(d).random(n) < 0.5, -1.0, 1.0).astype(np.float32)
        c = 10.0
    else:
        X, y = edge_stream(n, d, L)
        c = 1e4
    return (torch.as_tensor(X, device=cuda), torch.as_tensor(y, device=cuda),
            float(np.float32(1.0 / c)))


@pytest.mark.parametrize("stream", ["random", "edges"])
@pytest.mark.parametrize("d", [30, 33, 64, 784])
@pytest.mark.parametrize("L", [1, 2, 3, 8, 11])
def test_multiball_every_layout_matches_plain(cuda, L, d, stream):
    """M1 equals its plain version bit for bit in every leaf, both variants,
    in every layout the plan reaches (each forced by its own bytes), and in
    each of the four one-CTA layouts launched in its own plan (the grid
    takes these shapes, so the plan reaches the staged ones nowhere here;
    D = 30 and 33 stage by element loads)."""
    from repro_torch.kernels.multiball import (
        multiball_layouts, multiball_scan, multiball_scan_plain)

    X, y, c_inv = _mb_stream(cuda, L, d, stream)
    for slack0 in (c_inv, 1.0):
        want = _mb_run(multiball_scan_plain, X, y, L, c_inv, slack0)
        for plan in multiball_layouts(L, d):
            got = _mb_run(multiball_scan, X, y, L, c_inv, slack0,
                          smem_budget=sum(plan["smem"].values()))
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                assert torch.equal(a, b), plan
        for plan in _mb_one_cta_plans(L, d):
            got = _mb_run(_mb_forced(plan), X, y, L, c_inv, slack0)
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                assert torch.equal(a, b), plan


@pytest.mark.parametrize("L", [2, 8])
def test_multiball_unaligned_rows_and_a_ragged_last_block(cuda, L):
    """X[1:] of a D = 33 stream starts off a 16-byte boundary (element
    loads); N - 1 = 300 leaves a last block of 12 rows. Every one-CTA
    layout, each launched in its own plan, and the planned layout (the
    grid) equal the plain version."""
    from repro_torch.kernels.multiball import multiball_scan, multiball_scan_plain

    X, y = edge_stream(301, 33, 5)
    X, y = torch.as_tensor(X, device=cuda), torch.as_tensor(y, device=cuda)
    assert X[1:].data_ptr() % 16 != 0
    want = _mb_run(multiball_scan_plain, X, y, L, 1e-4, 1e-4)
    for fn in [_mb_forced(p) for p in _mb_one_cta_plans(L, 33)] + [multiball_scan]:
        got = _mb_run(fn, X, y, L, 1e-4, 1e-4)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_fit_multiball_on_the_card_matches_the_cpu(cuda):
    from repro_torch.core import fit_multiball

    X, y = edge_stream(500, 40, 9)
    for L in (1, 4):
        got = fit_multiball(X, y, 1e4, n_balls=L)
        want = fit_multiball(X, y, 1e4, n_balls=L, device="cpu")
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)


def test_multiball_byte_model_equals_the_request(cuda):
    from repro_torch.kernels import multiball as mb_mod

    lib = mb_mod._lib()
    assert _build.static_smem("multiball", "multiball_kernel") == {0}
    assert _build.static_smem("multiball", "multiball_grid_kernel") == {0}
    for L, d in ((1, 784), (8, 784), (3, 30), (11, 33), (8, 4096), (300, 16), (72, 768)):
        for n in (None, 11_799, 399):
            for plan in mb_mod.multiball_layouts(L, d, n=n):
                if plan["layout"] == "grid":
                    have = lib.multiball_grid_dyn_bytes(d, L, plan["rows"])
                else:
                    have = lib.multiball_dyn_bytes(d, L, int(plan["x_smem"]), int(plan["tables_smem"]))
                assert have == sum(plan["smem"].values()) <= 232_448
    assert lib.multiball_scratch_bytes(8) == 4 * (32 * 8 + 64)
    assert lib.multiball_grid_scratch_bytes(8, 132) == 2 * 132 * 128 + 4 * 2 * 132 * 8


@pytest.mark.parametrize("stream", ["random", "edges"])
@pytest.mark.parametrize("d", [30, 32, 33, 784])
@pytest.mark.parametrize("L", [1, 2, 3, 8])
def test_multiball_grid_matches_plain(cuda, L, d, stream):
    """The grid layout equals the plain version bit for bit in every leaf,
    both variants, on 1, 2, 7 CTAs and one an SM, with as many rows a CTA as
    fit, one row a CTA, and 32 (a window a CTA count times 32 rows): 399
    rows leave a ragged last window in each."""
    from repro_torch.kernels.multiball import multiball_plan, multiball_scan, multiball_scan_plain

    X, y, c_inv = _mb_stream(cuda, L, d, stream)
    for slack0 in (c_inv, 1.0):
        want = _mb_run(multiball_scan_plain, X, y, L, c_inv, slack0)
        for n_ctas in (1, 2, 7, None):
            for rows in (None, 1, 32):
                budget = _grid_budget(L, d, rows)
                plan = multiball_plan(L, d, n=399, n_ctas=n_ctas, smem_budget=budget)
                assert plan["layout"] == "grid" and (rows is None or plan["rows"] <= rows)
                got = _mb_run(multiball_scan, X, y, L, c_inv, slack0, smem_budget=budget,
                              n_ctas=n_ctas)
                torch.cuda.synchronize()
                for a, b in zip(got, want):
                    assert torch.equal(a, b), plan


@pytest.mark.parametrize("L", [2, 8])
def test_multiball_grid_updates_on_cta_and_window_edges(cuda, L, monkeypatch):
    """On 2 CTAs of 32 rows (windows of 64 over 384 rows), the edge
    stream's updates fall on a window's first row and on a CTA's last row
    (checked on the plain version's updates), and the grid equals the
    plain version."""
    from repro_torch.kernels import multiball as mb_mod

    X, y, c_inv = _mb_stream(cuda, L, 33, "edges", n=385)
    rows, orig = [], mb_mod.absorb

    def spy(W, r, xi2, m, act, P, s_row, x, slack0):
        rows.append(x[:33].clone())
        return orig(W, r, xi2, m, act, P, s_row, x, slack0)

    monkeypatch.setattr(mb_mod, "absorb", spy)
    want = _mb_run(mb_mod.multiball_scan_plain, X, y, L, c_inv, c_inv)
    monkeypatch.setattr(mb_mod, "absorb", orig)
    yx = y[1:, None] * X[1:]
    pos = [int(torch.nonzero((yx == x).all(1))[0]) for x in rows]
    budget = _grid_budget(L, 33, 32)
    plan = mb_mod.multiball_plan(L, 33, n=384, n_ctas=2, smem_budget=budget)
    assert (plan["rows"], plan["windows"]) == (32, 6)
    assert any(p % 64 == 0 and p > 0 for p in pos), pos  # a window's first row
    assert any(p % 32 == 31 for p in pos), pos  # a CTA's last row
    got = _mb_run(mb_mod.multiball_scan, X, y, L, c_inv, c_inv, smem_budget=budget, n_ctas=2)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("L", [2, 8])
def test_multiball_grid_unaligned_rows_and_a_ragged_last_window(cuda, L):
    """X[1:] of a D = 33 stream starts off a 16-byte boundary (element
    loads); 300 rows on 7 CTAs of 5 rows leave a last window of 20 rows."""
    from repro_torch.kernels.multiball import multiball_plan, multiball_scan, multiball_scan_plain

    X, y = edge_stream(301, 33, 5)
    X, y = torch.as_tensor(X, device=cuda), torch.as_tensor(y, device=cuda)
    assert X[1:].data_ptr() % 16 != 0
    budget = _grid_budget(L, 33, 5)
    assert multiball_plan(L, 33, n=300, n_ctas=7, smem_budget=budget)["windows"] == 9
    want = _mb_run(multiball_scan_plain, X, y, L, 1e-4, 1e-4)
    got = _mb_run(multiball_scan, X, y, L, 1e-4, 1e-4, smem_budget=budget, n_ctas=7)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_multiball_grid_the_card_cannot_hold_is_refused(cuda):
    """More CTAs than the card holds at once (512 threads a CTA: at most 4
    an SM) are refused at launch and raise; nothing ran, and no other layout
    was launched in its place."""
    from repro_torch.kernels.multiball import multiball_scan
    from repro_torch.kernels.streamsvm_scan import sm_count

    X, y, c_inv = _mb_stream(cuda, 4, 784, "random")
    st = _start(X, y, 4, c_inv)
    before = [v.clone() for v in st]
    launches = multiball_scan.launches
    with pytest.raises(RuntimeError, match="grid of"):
        multiball_scan(X[1:], y[1:], *st, c_inv, c_inv, n_ctas=4 * sm_count() + 1)
    torch.cuda.synchronize()
    assert multiball_scan.launches == launches
    for a, b in zip(st, before):
        assert torch.equal(a, b)


@pytest.mark.parametrize("L,d", [(72, 768), (300, 16)])
def test_multiball_one_cta_layouts_where_the_grid_does_not_fit(cuda, L, d):
    """Where the state replica and a row pass the card's limit, the plan
    takes the one-CTA layouts, each bit-equal to the plain version."""
    from repro_torch.kernels.multiball import (
        multiball_layouts, multiball_scan, multiball_scan_plain)

    plans = multiball_layouts(L, d)
    assert plans and all(p["layout"] == "cta" for p in plans)
    X, y, c_inv = _mb_stream(cuda, L, d, "random", n=300)
    want = _mb_run(multiball_scan_plain, X, y, L, c_inv, c_inv)
    for plan in plans:
        got = _mb_run(multiball_scan, X, y, L, c_inv, c_inv, smem_budget=sum(plan["smem"].values()))
        for a, b in zip(got, want):
            assert torch.equal(a, b), plan


# ---------------------------------------------------------------------------
# The live loop on the card: crash equivalence bit for bit (B1 / B6, B2, B5,
# R1 between checkpoint writes and restores), and the card's bank against
# the CPU's within the engine tolerance.
# ---------------------------------------------------------------------------

_LIVE_D, _LIVE_B, _LIVE_CHUNK, _LIVE_CHUNKS = 40, 24, 96, 8


def _live_stream():
    rng = np.random.default_rng(21)
    X = rng.normal(size=(_LIVE_CHUNKS * _LIVE_CHUNK, _LIVE_D)).astype(np.float32)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    Y = np.sign(rng.normal(size=(_LIVE_B, X.shape[0])) + X[:, :1].T).astype(np.float32)
    Y[Y == 0] = 1.0
    return X, Y


def _live(tmp_path, name, device, kind, **kw):
    from repro_torch.live import ArraySource, LiveBank

    X, Y = _live_stream()
    if kind == "kernel":
        kw = dict(kernel="rbf", gamma=1.0, coreset_size=16, block_n=64, **kw)
    cs = np.linspace(0.5, 8.0, _LIVE_B).astype(np.float32)
    return LiveBank(ArraySource(X, Y, _LIVE_CHUNK), cs, ckpt_dir=str(tmp_path / name),
                    bank_kind=kind, n_sub_banks=2, rotate_every=2, swap_every=1,
                    sleep=lambda s: None, device=device, **kw)


def _live_scores(bank, device):
    from repro_torch.core import kernel_bank_decision

    q = torch.as_tensor(_live_stream()[0][:64], device=device)
    if hasattr(bank, "coef"):
        return kernel_bank_decision(bank, q, kernel="rbf", gamma=1.0)
    return ops.predict_bank(q, bank.w)


@pytest.mark.parametrize("kind,resident", [("linear", "vmem"), ("linear", "hbm"),
                                           ("kernel", "auto")])
def test_live_crash_at_every_phase_is_bit_identical_on_the_card(cuda, tmp_path, kind, resident):
    from repro_torch.live import PHASES, run_live_with_restarts

    kw = {} if kind == "kernel" else {"bank_resident": resident}
    clean = _live(tmp_path, "clean", cuda, kind, **kw)
    ref_stats = clean.run()
    ref_bank = clean.serving_bank()
    for phase in PHASES:  # chunk 3: rotation, fold, swap and checkpoint all fire
        live = _live(tmp_path, phase, cuda, kind, failpoints=[(phase, 3)], **kw)
        stats = run_live_with_restarts(live, sleep=lambda s: None)
        assert stats.restarts == 1, phase
        for name, a, b in zip(ref_bank._fields, live.serving_bank(), ref_bank):
            assert torch.equal(a, b), (phase, name)
        assert torch.equal(_live_scores(live.serving_bank(), cuda), _live_scores(ref_bank, cuda))
        assert stats.durable() == ref_stats.durable(), phase


@pytest.mark.parametrize("kind", ["linear", "kernel"])
def test_live_loop_on_the_card_matches_the_cpu(cuda, tmp_path, kind):
    """The card's loop against the same loop on the CPU (plain versions):
    m and idx exact, floats within the engine tolerance."""
    card = _live(tmp_path, "card", cuda, kind)
    card.run()
    cpu = _live(tmp_path, "cpu", "cpu", kind)
    cpu.run()
    assert card.stats.durable()["folds"] == cpu.stats.durable()["folds"]
    for name, a, b in zip(cpu.serving_bank()._fields, card.serving_bank(), cpu.serving_bank()):
        if a.dtype == torch.int32:
            assert torch.equal(a.cpu(), b), name
        else:
            torch.testing.assert_close(a.cpu(), b, rtol=2e-4, atol=2e-5, msg=name)


# ---------------------------------------------------------------------------
# P1 and P2: the perceptron and Pegasos
# ---------------------------------------------------------------------------


def _baseline_stream(n, d, seed, noise=0.3):
    """Unit-norm rows, labels of a noisy linear rule (mistakes throughout)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    y = np.sign(X @ rng.normal(size=d) + noise * rng.normal(size=n)).astype(np.float32)
    y[y == 0] = 1.0
    return X, y


def _check_perceptron(X, y):
    from repro_torch.kernels.baselines import perceptron_scan, perceptron_scan_plain
    from repro_torch.kernels.partings import perceptron_parting

    fk = torch.zeros(X.shape[0], dtype=torch.uint8, device=X.device)
    fp = torch.zeros_like(fk)
    wk, mk = perceptron_scan(X, y, flags=fk)
    wp, mp = perceptron_scan_plain(X, y, flags=fp)
    torch.cuda.synchronize()
    part = perceptron_parting(X, y, fk, fp)
    if part is not None:
        assert part["tie"], f"P1 parts from its plain version at an untied row: {part}"
        print(f"P1: a certified f32 tie at {part}")
        return
    assert int(mk) == int(mp) == int(fk.sum())
    torch.testing.assert_close(wk, wp, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("d", [2, 5, 33, 300, 784])
@pytest.mark.parametrize("n", [1000, 4097])
def test_perceptron_kernel_matches_plain(cuda, n, d):
    X, y = _baseline_stream(n, d, seed=n + d)
    _check_perceptron(torch.as_tensor(X, device=cuda), torch.as_tensor(y, device=cuda))


def test_perceptron_kernel_in_every_layout(cuda):
    """B4's layouts under the perceptron's rule: whole blocks staged (D up
    to ~870), 256-column chunks with w in shared memory, w in device memory
    (D = 65,536); rows not 16-byte aligned (X[1:] at D = 33)."""
    for n, d in ((700, 1200), (300, 65_536)):
        X, y = _baseline_stream(n, d, seed=d)
        _check_perceptron(torch.as_tensor(X, device=cuda), torch.as_tensor(y, device=cuda))
    X, y = _baseline_stream(701, 33, seed=1)
    X, y = torch.as_tensor(X, device=cuda), torch.as_tensor(y, device=cuda)
    _check_perceptron(X[1:], y[1:])


def _check_pegasos(X, y, lam, k, budget=None, plan=None):
    """P2 (through ``pegasos_scan`` under ``budget``, or in ``plan`` through
    the private ``_launch``) against its plain version: the same violations
    row for row and w within the engine tolerance, or a first parting that
    ``pegasos_parting`` certifies as an f32 tie (with the walk's terms for a
    walk)."""
    from repro_torch.kernels import baselines as kb
    from repro_torch.kernels.partings import pegasos_parting

    n = X.shape[0] // k * k
    X, y = X[:n], y[:n]

    def run(m, flags=None):
        if plan is None:
            return kb.pegasos_scan(X[:m], y[:m], lam, k, flags=flags, smem_budget=budget)
        w = torch.zeros(X.shape[1], device=X.device)
        if m:
            kb._launch(plan, X[:m].contiguous(), y[:m].contiguous(), lam, k, w, flags)
        return w

    fk = torch.zeros(n, dtype=torch.uint8, device=X.device)
    fp = torch.zeros_like(fk)
    wk = run(n, fk)
    wp = kb.pegasos_scan_plain(X, y, lam, k, flags=fp)
    torch.cuda.synchronize()
    used = plan or kb.pegasos_plan(X.shape[1], k, smem_budget=budget)
    states = lambda t: (run(t * k), kb.pegasos_scan_plain(X[: t * k], y[: t * k], lam, k))
    part = pegasos_parting(X, y, lam, k, fk, fp, states,
                           walk_rows=used.get("rows"))
    if part is not None:
        assert part["tie"], f"P2 ({used['layout']}) parts at an untied row: {part}"
        print(f"P2 ({used['layout']}): a certified f32 tie at {part}")
        return
    torch.testing.assert_close(wk, wp, rtol=2e-4, atol=2e-5)


def _pegasos_plans(d, k, layout):
    """The layouts of ``pegasos_layouts(d, k)`` named ``layout`` (the walk
    has B4's three); none only where that layout does not take k (the walk
    beyond 32 rows a step, the walk over blocks where its R holds no whole
    step or more than 32 or the rows are not 16-byte pieces, the staged ring
    beyond shared memory)."""
    from repro_torch.kernels import baselines as kb

    plans = [p for p in kb.pegasos_layouts(d, k) if p["layout"] == layout]
    if not plans:
        assert {"walk": k > kb.BLOCK_ROWS,
                "blocks": not kb.blocks_rows(k, kb.PEGASOS_BLOCKS_R) or d % 4 != 0,
                "staged": sum(kb.pegasos_smem(d, k, True).values()) > kb.SMEM_PER_BLOCK,
                }.get(layout, False), (d, k, layout)
    return plans


@pytest.mark.parametrize("layout", ["walk", "staged", "in place", "blocks"])
@pytest.mark.parametrize("k", [1, 3, 7, 20, 9, 64])
@pytest.mark.parametrize("d", [2, 33, 64, 784])
def test_pegasos_kernel_matches_plain(cuda, d, k, layout):
    """Every layout of P2 (the walk in each of B4's three layouts, the walk
    over blocks where the rows are 16-byte pieces, staged, in place) at
    D = 2, 33, 64 and 784 and k = 1, 3, 7, 9, 20 and 64 rows a step: the same violations row for row as the plain version and w
    within the engine tolerance, or a certified f32 tie; 1003 rows are not
    whole steps of 3, 7, 9, 20 or 64 nor whole blocks. Table 1's lambda
    (1 / (10 N)) projects at step 0 and on most later violations; 1e-2 at
    the first few steps only."""
    X, y = _baseline_stream(1003, d, seed=7 * d + k)
    X, y = torch.as_tensor(X, device=cuda), torch.as_tensor(y, device=cuda)
    for plan in _pegasos_plans(d, k, layout):
        for lam in (1e-2, 1.0 / (10.0 * 1003)):
            _check_pegasos(X, y, lam, k, plan=plan)


def test_pegasos_planned_layouts_launch_through_the_wrapper(cuda):
    """``pegasos_scan`` launches ``pegasos_plan``'s layout: the walk where k
    <= PEGASOS_WALK_MAX_K, the walk over blocks up to PEGASOS_BLOCKS_MAX_K,
    else the step form; a budget of the in-place layout's bytes forces it."""
    from repro_torch.kernels.baselines import (
        PEGASOS_BLOCKS_MAX_K, PEGASOS_WALK_MAX_K, pegasos_smem)

    X, y = _baseline_stream(1003, 784, seed=11)
    X, y = torch.as_tensor(X, device=cuda), torch.as_tensor(y, device=cuda)
    for k in sorted({1, 3, 20, PEGASOS_WALK_MAX_K, PEGASOS_WALK_MAX_K + 1,
                     PEGASOS_BLOCKS_MAX_K, PEGASOS_BLOCKS_MAX_K + 1}):
        _check_pegasos(X, y, 1e-3, k)
        _check_pegasos(X, y, 1e-3, k, budget=sum(pegasos_smem(784, k, False).values()))


def test_pegasos_kernel_at_wide_rows_and_unaligned_rows(cuda):
    """w in device memory at D = 20,000 (beyond the staged layout; the walk
    in SINGLE_DC-column chunks with w in shared memory, and in device
    memory); rows not 16-byte aligned (X[1:] at D = 784 is aligned, at
    D = 33 it is not), in every layout."""
    from repro_torch.kernels.baselines import pegasos_layouts

    X, y = _baseline_stream(120, 20_000, seed=3)
    X, y = torch.as_tensor(X, device=cuda), torch.as_tensor(y, device=cuda)
    for plan in pegasos_layouts(20_000, 3):
        _check_pegasos(X, y, 1e-3, 3, plan=plan)
    for d in (33, 784):
        X, y = _baseline_stream(401, d, seed=d)
        X, y = torch.as_tensor(X, device=cuda), torch.as_tensor(y, device=cuda)
        for k in (1, 20):
            for plan in pegasos_layouts(d, k):
                _check_pegasos(X[1:], y[1:], 1e-3, k, plan=plan)


def test_pegasos_dyn_bytes_equal_the_byte_model(cuda):
    from repro_torch.kernels.baselines import (
        BLOCKS_CLUSTER, PEGASOS_BLOCKS_R, _blocks_lib, _pegasos_lib, _walk_lib, blocks_rows,
        pegasos_layouts)

    lib, slib, blib = _pegasos_lib(), _walk_lib(), _blocks_lib()
    assert _build.static_smem("baselines", "pegasos_kernel") == {0}
    assert _build.static_smem("baselines", "pegasos_blocks_kernel") == {0}
    assert blib.pegasos_blocks_cluster() == BLOCKS_CLUSTER
    assert _build.static_smem("streamsvm_single", "single_kernel") == {0}
    for d, k in ((2, 1), (784, 1), (784, 20), (300, 20), (20_000, 1), (33, 7), (784, 9),
                 (784, 64), (20_000, 20)):
        for r in (PEGASOS_BLOCKS_R, 64, 224):
            assert blib.pegasos_blocks_rows(k, r) == blocks_rows(k, r)
        for plan in pegasos_layouts(d, k):
            model = sum(plan["smem"].values())
            if plan["layout"] == "walk":
                have = slib.pegasos_single_dyn_bytes(d, int(plan["w_in_smem"]), plan["chunk"])
                assert slib.pegasos_single_block_rows(k) == plan["rows"]
            elif plan["layout"] == "blocks":
                have = blib.pegasos_blocks_dyn_bytes(d, plan["rows"])
            else:
                have = lib.pegasos_dyn_bytes_c(d, k, plan["staged"])
            assert have == model, (d, k, plan)


def test_baseline_entry_points_launch_the_kernels(cuda):
    from repro_torch.baselines import fit_pegasos, fit_perceptron
    from repro_torch.kernels.baselines import pegasos_scan, perceptron_scan

    X, y = _baseline_stream(500, 16, seed=0)
    p1, p2 = perceptron_scan.launches, pegasos_scan.launches
    w, m = fit_perceptron(X, y)
    w2 = fit_pegasos(X, y, 1e-3, k=20)
    w3 = fit_pegasos(X, y, 1e-3, k=1)
    assert w.device.type == w2.device.type == w3.device.type == "cuda" and m.dtype == torch.int32
    assert (perceptron_scan.launches, pegasos_scan.launches) == (p1 + 1, p2 + 2)


def test_float64_baselines_on_the_card_match_the_cpu(cuda):
    """LASVM, CVM (float64) and the batch l2-SVM (f32) on the card against
    the same calls on the CPU: LASVM's decisions (its ties broken by stream
    order on both) and CVM's core set exact, floats within their sums'
    reordering."""
    from repro_torch.baselines import fit_batch_l2svm, fit_cvm, fit_lasvm

    X, y = _baseline_stream(600, 12, seed=5)
    for C in (1.0, 10.0):
        got = fit_lasvm(X, y, C, return_bias=True, device=cuda)
        want = fit_lasvm(X, y, C, return_bias=True, device="cpu")
        assert got[2] == want[2]
        torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-9, atol=1e-12)
        assert abs(got[1] - want[1]) <= 1e-9 * max(1.0, abs(want[1]))
    got = fit_cvm(X, y, 10.0, eps=1e-3, max_passes=8, solver_iters=300, device=cuda)
    want = fit_cvm(X, y, 10.0, eps=1e-3, max_passes=8, solver_iters=300, device="cpu")
    assert got["passes"] == want["passes"]
    assert got["core_idx"].tolist() == want["core_idx"].tolist()
    for a, b in zip(got["w_per_pass"] + [got["w"]], want["w_per_pass"] + [want["w"]]):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-9, atol=1e-12)
    (wb, ob), (wc, oc) = (fit_batch_l2svm(X, y, 10.0, iters=300, device=dv)
                          for dv in (cuda, "cpu"))
    torch.testing.assert_close(wb.cpu(), wc, rtol=1e-4, atol=1e-4 * float(wc.abs().max()))
    torch.testing.assert_close(ob.cpu(), oc, rtol=1e-4, atol=0.0)


@pytest.mark.parametrize("arch", ["gemma3-27b", "xlstm-125m", "qwen3-moe-30b-a3b"])
def test_zoo_prefill_and_decode_on_the_card_match_the_cpu(cuda, arch):
    """A smoke model (f32 copy; gemma3's windows and tied embeddings, xLSTM's
    recurrent state) prefilled and decoded 5 steps on the card, against the
    same calls on the CPU on the same weights: logits within 1e-4 x
    max|logit| (f32 sums in another order; TF32 off)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = dataclasses.replace(get_config(arch, smoke=True), param_dtype="float32",
                              act_dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(1), device="cpu")
    on_card = _tree_to(params, cuda)
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 30)).astype(np.int32)
    runs = []
    for p, dev in ((on_card, cuda), (params, torch.device("cpu"))):
        t = torch.as_tensor(toks, device=dev)
        logits, cache = model.prefill(p, {"tokens": t[:, :24], "max_len": 30})
        out = [logits.float().cpu()]
        for i in range(24, 29):
            logits, cache = model.decode_step(p, cache, t[:, i : i + 1])
            out.append(logits.float().cpu())
        runs.append(out)
    for got, want in zip(*runs):
        assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def test_zoo_moe_forward_and_drops_on_the_card_match_the_cpu(cuda):
    """The MoE smoke config (f32 copy) at a capacity factor that drops: the
    loss, its ce and aux within 1e-5 (relative) of the CPU's, and every
    layer's dropped assignments the CPU's exactly."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config("qwen3-moe-30b-a3b", smoke=True)
    cfg = dataclasses.replace(cfg, param_dtype="float32", act_dtype="float32",
                              moe=dataclasses.replace(cfg.moe, capacity_factor=0.5))
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(4), device="cpu")
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (3, 40)).astype(np.int32)
    runs = []
    for p, dev in ((_tree_to(params, cuda), cuda), (params, torch.device("cpu"))):
        model.moe_stats = []
        t = torch.as_tensor(toks, device=dev)
        with torch.no_grad():
            loss, m = model.loss(p, {"tokens": t[:, :-1], "targets": t[:, 1:]})
        runs.append(([float(loss), float(m["ce"]), float(m["aux"])],
                     [(s["experts"].cpu(), s["kept"].cpu()) for s in model.moe_stats]))
    model.moe_stats = None
    (got, gs), (want, ws) = runs
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert len(gs) == cfg.n_layers and any(int((~k).sum()) for _, k in ws)
    for (ge, gk), (we, wk) in zip(gs, ws):
        assert torch.equal(ge, we) and torch.equal(gk, wk)


def test_train_step_on_the_card_matches_the_cpu(cuda):
    """One make_train_step of the dense smoke config (f32 copy, two
    microbatches) on the card against the CPU on the same weights and
    batch: loss and grad_norm within 1e-5 (relative); after the step (lr
    5e-4, warmup's second step) 99.9 % of the params within 1e-6 x
    max|param| and all within 2 lr (AdamW moves an entry by about lr
    sign(g): a grad at rounding level can go either way)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.train import TrainCfg, make_train_step

    cfg = dataclasses.replace(get_config("internlm2-1.8b", smoke=True), param_dtype="float32",
                              act_dtype="float32")
    model = build_model(cfg, remat="full")
    tc = TrainCfg(microbatches=2, peak_lr=1e-3, warmup_steps=2, total_steps=10)
    params = model.init(torch.Generator().manual_seed(6), device="cpu")
    rng = np.random.default_rng(7)
    batch = {k: rng.integers(0, cfg.vocab, (4, 24)).astype(np.int32) for k in ("tokens", "targets")}
    outs = []
    for dev in (cuda, torch.device("cpu")):
        p = _tree_to(params, dev)
        st = {"params": p, "opt": adamw.init(p)}
        st = {**st, "opt": st["opt"]._replace(step=st["opt"].step + 1)}  # lr > 0
        st, m = make_train_step(model, tc)(st, {k: torch.as_tensor(v, device=dev)
                                                for k, v in batch.items()})
        outs.append((float(m["loss"]), float(m["grad_norm"]), _tree_to(st["params"], "cpu")))
    (lg, gg, pg), (lw, gw, pw) = outs
    np.testing.assert_allclose([lg, gg], [lw, gw], rtol=1e-5)
    for a, b in zip(_leaf_list(pg), _leaf_list(pw)):
        err = (a - b).abs()
        assert float(err.max()) <= 2 * 5e-4
        assert float((err <= 1e-6 * max(float(b.abs().max()), 1.0)).float().mean()) >= 0.999


def _leaf_list(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaf_list(tree[k])]
    return [tree]


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to(v, dev) for v in tree)
    return tree.to(dev)


@pytest.mark.parametrize("arch,prompt", [("zamba2-1.2b", 32), ("zamba2-1.2b", 17),
                                         ("whisper-base", 24)])
def test_zoo_hybrid_and_encdec_on_the_card_match_the_cpu(cuda, arch, prompt):
    """Zamba2 (a prompt of whole chunks: the chunked SSD; 17: the
    recurrence) and Whisper (frames from a seed), smoke configs as f32
    copies, prefilled and decoded 5 steps on the card against the CPU on the
    same weights: logits within 1e-4 x max|logit| (TF32 off)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = dataclasses.replace(get_config(arch, smoke=True), param_dtype="float32",
                              act_dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(1), device="cpu")
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab, (2, prompt + 6)).astype(np.int32)
    extra = {}
    if cfg.family == "encdec":
        extra["frames"] = (rng.normal(size=(2, cfg.encoder_seq, cfg.d_model)) * 0.1).astype(np.float32)
    runs = []
    for p, dev in ((_tree_to(params, cuda), cuda), (params, torch.device("cpu"))):
        t = torch.as_tensor(toks, device=dev)
        b = {k: torch.as_tensor(v, device=dev) for k, v in extra.items()}
        logits, cache = model.prefill(p, {**b, "tokens": t[:, :prompt], "max_len": prompt + 6})
        out = [logits.float().cpu()]
        for i in range(prompt, prompt + 5):
            logits, cache = model.decode_step(p, cache, t[:, i : i + 1])
            out.append(logits.float().cpu())
        runs.append(out)
    for got, want in zip(*runs):
        assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def test_ssd_chunked_and_its_grad_on_the_card_match_the_cpu(cuda):
    """The chunked SSD (64 heads of 64, d_state 64, chunk 128, as zamba2's)
    and its gradients on the card against the CPU: rtol / atol 1e-4 x max
    (f32 products in another order; TF32 off)."""
    from repro_torch.models.mamba2 import ssd_chunked

    rng = np.random.default_rng(3)
    b, s, h, p, n = 1, 256, 64, 64, 64
    arrays = [rng.normal(size=(b, s, h, p)), np.log1p(np.exp(rng.normal(size=(b, s, h)))),
              rng.normal(size=(h,)) * 0.5, rng.normal(size=(b, s, n)), rng.normal(size=(b, s, n))]
    out = []
    for dev in (cuda, torch.device("cpu")):
        ins = [torch.as_tensor(a, dtype=torch.float32, device=dev).requires_grad_() for a in arrays]
        y, fin = ssd_chunked(*ins, 128)
        grads = torch.autograd.grad(y.square().sum() + fin.sum(), ins)
        out.append([t.detach().cpu() for t in (y, fin, *grads)])
    for got, want in zip(*out):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))


def test_launcher_on_the_card_resumes_bit_for_bit(cuda, tmp_path):
    """python -m repro_torch.launch.train's main on the card, Whisper's smoke
    config under --deterministic: preempted after step 3, resumed from the
    step-2 checkpoint, equal to the uninterrupted run bit for bit."""
    from repro_torch._tree import leaves
    from repro_torch.launch import train as launch

    base = ["--arch", "whisper-base", "--smoke", "--steps", "4", "--batch", "2", "--seq", "32",
            "--device", "cuda", "--ckpt-every", "2", "--deterministic", "--quiet"]
    cut = launch.main(base + ["--ckpt-dir", str(tmp_path / "a"), "--stop-after", "3"])
    resumed = launch.main(base + ["--ckpt-dir", str(tmp_path / "a"), "--resume"])
    clean = launch.main(base + ["--ckpt-dir", str(tmp_path / "b")])
    assert resumed["start"] == 2 and cut["losses"][:2] + resumed["losses"] == clean["losses"]
    assert all(torch.equal(x, y) for x, y in zip(leaves(resumed["state"]), leaves(clean["state"])))
