"""The port's CUDA kernels (B1-B4) against their plain versions, on the card.

Marked ``gpu``: each test needs a CUDA card and skips without one. Whether
there is a card is decided inside the fixture, so every pytest worker
collects the same tests. On the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances are the repo's engine tolerance (f32 sums in another order);
core-vector counts and ids are exact, and the bank's tiling changes no bit.
This file imports no JAX: the machine with the card has none.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import fit, fit_lookahead
from repro_torch.kernels import ops
from repro_torch.kernels.predict import predict_bank_fused, predict_bank_plain
from repro_torch.kernels.streamsvm_scan import (
    streamsvm_scan,
    streamsvm_scan_lookahead_many,
    streamsvm_scan_many,
    streamsvm_scan_many_plain,
)

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


@pytest.mark.parametrize("n,d", [(1000, 784), (777, 90), (300, 20)])
def test_single_kernel_matches_plain(cuda, n, d):
    """B4: ragged N, a zero feature row, sign-0 rows, and a continuation."""
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
