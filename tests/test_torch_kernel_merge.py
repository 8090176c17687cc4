"""The kernel half of the port's ``core.meb`` against the JAX reference.

Two banks fitted by the port from disjoint halves of one seeded stream go,
as numpy arrays, through ``repro.core.merge_kernel_banks`` /
``fold_kernel_banks``, the numpy oracle ``repro.kernels.ref.
merge_kernel_banks_ref`` and the port. The kept slots (``idx``, the
gathered ``points``) and ``m`` are held exactly; the floats within rtol
1e-4 / atol 1e-5 (the cross-Gram contraction sums in another order); the
dropped mass is exactly 0.0 when only free slots are dropped.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import KernelBank as JKernelBank
from repro.core import fold_kernel_banks as jfold_kernel_banks
from repro.core import merge_kernel_banks as jmerge_kernel_banks
from repro.core import stack_kernel_banks as jstack_kernel_banks
from repro.kernels.ref import merge_kernel_banks_ref
from repro_torch.convert import ball_from_numpy, kernel_bank_to_numpy
from repro_torch.core import (
    KernelBank,
    fit_kernel_bank,
    fold_banks,
    fold_kernel_banks,
    merge_banks,
    merge_kernel_banks,
    stack_banks,
    stack_kernel_banks,
)


def _stream(seed, b=3, n=80, d=6):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    Y = np.sign(rng.normal(size=(b, n))).astype(np.float32)
    Y[Y == 0] = 1.0
    return X, Y, np.linspace(0.5, 4.0, b).astype(np.float32)


def _banks(kernel, seed, parts=2, s=8, eviction="smallest-coef", gamma=1.0, n=60):
    """``parts`` port banks over consecutive ranges of one stream, with idx in
    stream coordinates."""
    X, Y, cs = _stream(seed, n=parts * n)
    out = []
    for p in range(parts):
        lo = p * n
        kb = fit_kernel_bank(torch.as_tensor(X[lo : lo + n]), torch.as_tensor(Y[:, lo : lo + n]),
                             torch.as_tensor(cs), kernel=kernel, gamma=gamma, coreset_size=s,
                             eviction=eviction, block_n=32)
        out.append(kb._replace(idx=torch.where(kb.idx >= 0, kb.idx + lo, kb.idx)))
    return out


def _j(kb):
    return JKernelBank(*(jnp.asarray(v) for v in kernel_bank_to_numpy(kb)))


def _assert_same(got, want):
    got = kernel_bank_to_numpy(got)
    want = [np.asarray(v) for v in want]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[6], want[6])
    for i in (1, 3, 4, 5):
        np.testing.assert_allclose(got[i], want[i], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kernel", ["rbf", "linear"])
@pytest.mark.parametrize("eviction", ["smallest-coef", "farthest-point"])
def test_merge_vs_reference_and_oracle(kernel, eviction):
    b1, b2 = _banks(kernel, seed=3, eviction=eviction)
    kw = dict(kernel=kernel, gamma=1.0, eviction=eviction)
    got, dropped = merge_kernel_banks(b1, b2, return_dropped=True, **kw)
    assert isinstance(got, KernelBank)
    _assert_same(got, merge_kernel_banks_ref(_j(b1), _j(b2), **kw))
    want, jdropped = jmerge_kernel_banks(_j(b1), _j(b2), return_dropped=True, **kw)
    _assert_same(got, tuple(want))
    np.testing.assert_allclose(dropped.numpy(), np.asarray(jdropped), rtol=1e-4, atol=1e-5)
    assert bool((dropped > 0).any())  # 16 live slots into 8: mass is dropped


def test_dropped_mass_is_exactly_zero_when_only_free_slots_drop():
    b1, b2 = _banks("rbf", seed=5, s=8, n=3)  # at most 3 live slots per bank
    assert int((b1.idx >= 0).sum(1).max() + (b2.idx >= 0).sum(1).max()) <= 8
    for eviction in ("smallest-coef", "farthest-point"):
        merged, dropped = merge_kernel_banks(b1, b2, kernel="rbf", gamma=1.0, eviction=eviction,
                                             return_dropped=True)
        assert torch.equal(dropped, torch.zeros(3))
        live = (merged.idx >= 0).sum(1)
        assert torch.equal(live, (b1.idx >= 0).sum(1) + (b2.idx >= 0).sum(1))


def test_merge_with_an_empty_bank_is_the_identity():
    (b1,) = _banks("rbf", seed=7, parts=1)
    empty = KernelBank(
        idx=torch.full_like(b1.idx, -1), coef=torch.zeros_like(b1.coef),
        points=torch.zeros_like(b1.points), q=torch.zeros_like(b1.q), r=torch.zeros_like(b1.r),
        xi2=torch.zeros_like(b1.xi2), m=torch.zeros_like(b1.m),
    )
    for left, right in ((b1, empty), (empty, b1)):
        merged = merge_kernel_banks(left, right, kernel="rbf", gamma=1.0)
        for name in ("q", "r", "xi2", "m"):
            assert torch.equal(getattr(merged, name), getattr(b1, name)), name
        # the cut may reorder slots (top-S by score): compare idx -> (coef, point)
        for bi in range(3):
            maps = [
                {int(i): (float(c), p.tolist()) for i, c, p in zip(kb.idx[bi], kb.coef[bi],
                                                                    kb.points[bi]) if i >= 0}
                for kb in (merged, b1)
            ]
            assert maps[0] == maps[1], bi
    both = merge_kernel_banks(empty, empty, kernel="rbf", gamma=1.0)
    assert int(both.m.sum()) == 0 and float(both.q.sum()) == 0.0


def test_fold_is_a_left_fold_with_a_live_mask():
    banks = _banks("rbf", seed=9, parts=3)
    kw = dict(kernel="rbf", gamma=1.0)
    acc = merge_kernel_banks(merge_kernel_banks(banks[0], banks[1], **kw), banks[2], **kw)
    folded, dropped = fold_kernel_banks(banks, return_dropped=True, **kw)
    for a, b in zip(folded, acc):
        assert torch.equal(a, b)
    stacked = stack_kernel_banks(banks)
    assert stacked.coef.shape == (3, 3, 8)
    for a, b in zip(fold_kernel_banks(stacked, **kw), acc):
        assert torch.equal(a, b)
    # dead entries never enter a merge
    live = fold_kernel_banks(banks, live=[True, False, True], **kw)
    for a, b in zip(live, merge_kernel_banks(banks[0], banks[2], **kw)):
        assert torch.equal(a, b)
    single, zero = fold_kernel_banks(banks, live=[False, True, False], return_dropped=True, **kw)
    assert all(torch.equal(a, b) for a, b in zip(single, banks[1]))
    assert torch.equal(zero, torch.zeros(3))
    # the reference folds the same banks to the same kept slots
    want, jdropped = jfold_kernel_banks(jstack_kernel_banks([_j(b) for b in banks]),
                                        return_dropped=True, **kw)
    _assert_same(folded, tuple(want))
    np.testing.assert_allclose(dropped.numpy(), np.asarray(jdropped), rtol=1e-4, atol=1e-5)
    jlive = jfold_kernel_banks([_j(b) for b in banks], live=np.array([True, False, True]), **kw)
    _assert_same(live, tuple(jlive))


def test_errors():
    b1, b2 = _banks("rbf", seed=11)
    with pytest.raises(ValueError, match="identically-shaped"):
        merge_kernel_banks(b1, b2._replace(coef=b2.coef[:, :4]), kernel="rbf")
    with pytest.raises(ValueError, match="eviction"):
        merge_kernel_banks(b1, b2, kernel="rbf", eviction="lru")
    with pytest.raises(ValueError, match="empty"):
        stack_kernel_banks([])
    with pytest.raises(ValueError, match="empty"):
        fold_kernel_banks([], kernel="rbf")
    with pytest.raises(ValueError, match="LIVE"):
        fold_kernel_banks([b1, b2], kernel="rbf", live=[False, False])
    with pytest.raises(ValueError, match="does not match"):
        fold_kernel_banks([b1, b2], kernel="rbf", live=[True])
    # Linear and kernelized banks refuse each other, naming the other half.
    ball = ball_from_numpy((np.zeros((3, 6)), np.zeros(3), np.zeros(3), np.ones(3)), "cpu")
    for fn, args in ((merge_banks, (ball, b1)), (stack_banks, ([ball, b1],)),
                     (fold_banks, ([b1],))):
        with pytest.raises(ValueError, match="merge_kernel_banks"):
            fn(*args)
    with pytest.raises(ValueError, match="merge_banks"):
        merge_kernel_banks(b1, ball, kernel="rbf")
