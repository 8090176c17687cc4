"""B5 (the Gram block) and the dense kernelized engine of the port against
the JAX reference.

The same seeded numpy inputs go through ``repro.kernels.gram`` (its Pallas
kernel in interpret mode), ``repro.kernels.ref.gram_ref`` and
``repro.core.kernelized``, and through the port on the CPU, which runs B5's
plain version. Gram tolerance: each element is a D-long f32 sum whose
rounding error is at most about D u sum_d |a_d b_d| <= D u |a_i| |b_j|
(u = 2^-24, Cauchy-Schwarz), in each package and in any summation order,
so two of them differ by at most 2 (D + 1) u |a_i| |b_j|; the RBF map
exp(-gamma max(d^2, 0)) is gamma-Lipschitz in d^2 = ... - 2<a, b>, so there
the bound is 2 gamma times that, plus 1e-6 for exp's own rounding. No fixed
atol: a fixed one would be loose for small norms and wrong for large ones.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fit_kernelized as jfit_kernelized
from repro.core import linear_kernel as jlinear_kernel
from repro.core import linear_weights as jlinear_weights
from repro.core import rbf_kernel as jrbf_kernel
from repro.core.kernelized import decision_function as jdecision_function
from repro.kernels import gram as jgram
from repro.kernels.ref import gram_ref
from repro_torch.core import fit_kernelized, linear_kernel, linear_weights, rbf_kernel
from repro_torch.core.kernelized import decision_function
from repro_torch.kernels import ops
from repro_torch.kernels.gram import (
    fma32,
    gram_fused,
    gram_plain,
    row_norms,
    row_norms_plain,
    tree_sum,
)

U = 2.0**-24


def gram_tol(A, B, epilogue, gamma):
    """Per-element bound on the difference of two f32 Gram evaluations."""
    d = A.shape[1]
    na = np.linalg.norm(A.astype(np.float64), axis=1)
    nb = np.linalg.norm(B.astype(np.float64), axis=1)
    lin = 2.0 * (d + 1) * U * na[:, None] * nb[None, :]
    if epilogue == "linear":
        return lin
    return 2.0 * gamma * lin + 1e-6


def assert_gram_close(got, want, A, B, epilogue, gamma):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    tol = gram_tol(A, B, epilogue, gamma)
    worst = np.unravel_index(np.argmax(err - tol), err.shape)
    assert np.all(err <= tol), (worst, err[worst], tol[worst])


@pytest.mark.parametrize("m,n,d", [(37, 130, 33), (9, 1, 7), (64, 65, 16)])
@pytest.mark.parametrize("epilogue", ["linear", "rbf"])
def test_gram_odd_shapes_vs_reference(m, n, d, epilogue):
    rng = np.random.default_rng(m + n + d)
    A = rng.normal(size=(m, d)).astype(np.float32)
    B = rng.normal(size=(n, d)).astype(np.float32)
    gamma = 0.1
    got = ops.gram(torch.as_tensor(A), torch.as_tensor(B), epilogue=epilogue, gamma=gamma).numpy()
    assert got.shape == (m, n) and got.dtype == np.float32
    for want in (
        jgram(jnp.asarray(A), jnp.asarray(B), epilogue=epilogue, gamma=gamma),
        gram_ref(jnp.asarray(A), jnp.asarray(B), epilogue=epilogue, gamma=gamma),
    ):
        assert_gram_close(got, np.asarray(want), A, B, epilogue, gamma)


@pytest.mark.parametrize("gamma", [0.05, 0.5, 2.0, 8.0])
def test_gram_rbf_gamma_sweep_vs_reference(gamma):
    rng = np.random.default_rng(3)
    A = rng.normal(size=(21, 12)).astype(np.float32) * 0.5
    B = rng.normal(size=(40, 12)).astype(np.float32) * 0.5
    got = ops.gram(torch.as_tensor(A), torch.as_tensor(B), epilogue="rbf", gamma=gamma).numpy()
    want = np.asarray(jgram(jnp.asarray(A), jnp.asarray(B), epilogue="rbf", gamma=gamma))
    assert_gram_close(got, want, A, B, "rbf", gamma)
    assert np.all(got <= 1.0)


def test_gram_rbf_diagonal_is_one_on_duplicates():
    """The row norms are the Gram's own chain, so k(x, x) is exactly 1 even
    for duplicate rows (the clamp removes the negative side only)."""
    rng = np.random.default_rng(2)
    A = rng.normal(size=(12, 40)).astype(np.float32)
    A[3], A[9] = A[0], A[4]
    K = ops.gram(torch.as_tensor(A), torch.as_tensor(A), epilogue="rbf", gamma=2.5)
    assert torch.equal(torch.diagonal(K), torch.ones(12))
    assert float(K.max()) <= 1.0
    assert K[3, 0] == 1.0 and K[9, 4] == 1.0
    torch.testing.assert_close(row_norms(torch.as_tensor(A)),
                               torch.as_tensor((A.astype(np.float64) ** 2).sum(1), dtype=torch.float32),
                               rtol=1e-5, atol=0.0)


def test_gram_bf16_operand_is_upcast():
    rng = np.random.default_rng(4)
    A = torch.as_tensor(rng.normal(size=(10, 9)).astype(np.float32)).to(torch.bfloat16)
    B = torch.as_tensor(rng.normal(size=(7, 9)).astype(np.float32))
    got = ops.gram(A, B, epilogue="rbf", gamma=0.3)
    want = ops.gram(A.float(), B, epilogue="rbf", gamma=0.3)
    assert torch.equal(got, want)


def test_gram_chunks_are_bit_exact():
    """An element's sum does not depend on the launch's shape: slices of B's
    rows give the bits of the whole launch (what s_tile relies on)."""
    rng = np.random.default_rng(5)
    A = torch.as_tensor(rng.normal(size=(16, 23)).astype(np.float32))
    B = torch.as_tensor(rng.normal(size=(50, 23)).astype(np.float32))
    an, bn = row_norms(A), row_norms(B)
    whole = gram_fused(A, B, an, bn, 0.7, epilogue="rbf")
    parts = torch.cat([gram_fused(A, B[lo:lo + 7], an, bn[lo:lo + 7], 0.7, epilogue="rbf")
                       for lo in range(0, 50, 7)], dim=1)
    assert torch.equal(whole, parts)
    assert torch.equal(gram_plain(A[5:9], B, an[5:9], bn, 0.7, epilogue="rbf"), whole[5:9])


def test_tree_sum_and_norms_are_row_independent():
    rng = np.random.default_rng(6)
    x = torch.as_tensor(rng.normal(size=(9, 13)).astype(np.float32))
    full = tree_sum(x)
    assert torch.equal(torch.stack([tree_sum(x[i : i + 1])[0] for i in range(9)]), full)
    torch.testing.assert_close(full, x.double().sum(1).float(), rtol=1e-5, atol=1e-6)
    assert torch.equal(row_norms_plain(x[2:5]), row_norms_plain(x)[2:5])
    assert tree_sum(torch.ones(3, 1)).tolist() == [1.0, 1.0, 1.0]


def _fma_exact(a, b, c):
    """f32 fma(a, b, c) by exact rational arithmetic: a b + c rounded once
    to the nearest f32, ties to even."""
    from fractions import Fraction

    v = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    f = np.float32(float(v))
    cands = [np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf))]
    return min(cands, key=lambda x: (abs(Fraction(float(x)) - v),
                                     int(np.float32(x).view(np.uint32)) & 1))


def test_fma32_is_the_exactly_rounded_fused_multiply_add():
    """fma32, the plain versions' emulation of the card's fmaf, equals the
    exact rounding on random triples, on cancelling ones (c near -a b) and
    on a true double-rounding case, where a float64 product and sum rounded
    to f32 is one ulp off."""
    rng = np.random.default_rng(11)
    a = rng.normal(size=4000).astype(np.float32)
    b = (rng.normal(size=4000) * np.exp2(rng.integers(-30, 30, size=4000))).astype(np.float32)
    c = rng.normal(size=4000).astype(np.float32)
    c[2000:] = (-(a[2000:].astype(np.float64) * b[2000:]) * (1 + rng.normal(size=2000) * 1e-6)
                ).astype(np.float32)
    a = np.append(a, np.float32(1 + 2**-23))
    b = np.append(b, np.float32(2**-24 * (1 - 2**-23)))
    c = np.append(c, np.float32(1 + 2**-23))
    got = fma32(torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(c)).numpy()
    want = np.array([_fma_exact(x, y, z) for x, y, z in zip(a, b, c)], np.float32)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    naive = (a.astype(np.float64) * b + c).astype(np.float32)
    assert naive[-1] != want[-1] and got[-1] == want[-1] == np.float32(1 + 2**-23)
    z = torch.tensor([-0.0])
    assert torch.signbit(fma32(z, torch.tensor([1.0]), z)).item()  # -0 stays -0


def test_gram_is_one_fma_chain_per_element():
    """gram_plain's element (i, j) is fmaf(a_d, b_d, acc) over d ascending
    from 0, and the row norms the same chain of a row with itself."""
    rng = np.random.default_rng(12)
    A = torch.as_tensor(rng.normal(size=(5, 19)).astype(np.float32))
    B = torch.as_tensor(rng.normal(size=(4, 19)).astype(np.float32))
    K = gram_plain(A, B, row_norms(A), row_norms(B), epilogue="linear")
    for i, j in ((0, 0), (4, 3), (2, 1)):
        acc = torch.zeros(())
        for d in range(19):
            acc = fma32(A[i, d], B[j, d], acc)
        assert K[i, j] == acc
    assert torch.equal(torch.diagonal(gram_plain(A, A, row_norms(A), row_norms(A))), row_norms(A))


def test_gram_validation():
    A, B = torch.zeros(3, 4), torch.zeros(5, 4)
    with pytest.raises(ValueError, match="feature axis"):
        ops.gram(A, torch.zeros(5, 3))
    with pytest.raises(ValueError, match="epilogue"):
        ops.gram(A, B, epilogue="poly")
    with pytest.raises(ValueError, match="bm"):
        ops.gram(A, B, bm=0)
    with pytest.raises(ValueError, match="row norms"):
        gram_fused(A, B, torch.zeros(2), torch.zeros(5))


# ---------------------------------------------------------------------------
# The dense engine (fit_kernelized) and its readouts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernel", ["linear", "rbf"])
@pytest.mark.parametrize("variant", ["exact", "paper-listing"])
def test_fit_kernelized_vs_reference(kernel, variant):
    rng = np.random.default_rng(7)
    n, d = 40, 6
    X = rng.normal(size=(n, d)).astype(np.float32)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    y = np.where(rng.random(n) < 0.5, 1.0, -1.0).astype(np.float32)
    gamma = 0.8
    jk = jrbf_kernel(gamma) if kernel == "rbf" else jlinear_kernel
    pk = rbf_kernel(gamma) if kernel == "rbf" else linear_kernel
    want = jfit_kernelized(jnp.asarray(X), jnp.asarray(y), 2.0, jk, variant)
    got = fit_kernelized(torch.as_tensor(X), torch.as_tensor(y), 2.0, pk, variant)
    np.testing.assert_allclose(got.alpha.numpy(), np.asarray(want.alpha), rtol=1e-4, atol=1e-5)
    for name in ("q", "r"):
        np.testing.assert_allclose(float(getattr(got, name)), float(getattr(want, name)),
                                   rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(float(got.xi2), float(want.xi2), rtol=1e-3, atol=1e-6)
    assert int(got.m) == int(want.m)
    Q = rng.normal(size=(9, d)).astype(np.float32)
    np.testing.assert_allclose(
        decision_function(got, torch.as_tensor(X), torch.as_tensor(Q), pk).numpy(),
        np.asarray(jdecision_function(want, jnp.asarray(X), jnp.asarray(Q), jk)),
        rtol=1e-4, atol=1e-5,
    )
    if kernel == "linear":
        np.testing.assert_allclose(linear_weights(got, torch.as_tensor(X)).numpy(),
                                   np.asarray(jlinear_weights(want, jnp.asarray(X))),
                                   rtol=1e-4, atol=1e-5)


def test_rbf_kernel_clamps_like_the_gram():
    rng = np.random.default_rng(8)
    A = rng.normal(size=(12, 40)).astype(np.float32)
    A[3] = A[0]
    K = rbf_kernel(2.5)(torch.as_tensor(A), torch.as_tensor(A))
    assert float(K.max()) <= 1.0
    np.testing.assert_allclose(torch.diagonal(K).numpy(), 1.0, rtol=0, atol=1e-4)
    np.testing.assert_allclose(
        K.numpy(), np.asarray(jrbf_kernel(2.5)(jnp.asarray(A), jnp.asarray(A))), rtol=1e-4, atol=1e-4
    )


@pytest.mark.parametrize("m,n,bm,bn", [
    (1, 1, 256, 256), (7, 129, 256, 256), (100, 200, 256, 256), (1000, 1000, 256, 256),
    (37, 513, 64, 128), (9, 1, 8, 128), (300, 5000, 100, 300),
])
def test_gram_tiling_is_the_references(m, n, bm, bn):
    """ops.gram_tiling keeps the reference's public tile policy."""
    from repro.kernels.ops import gram_tiling as jgram_tiling

    got = ops.gram_tiling(m, n, bm, bn)
    assert got == jgram_tiling(m, n, bm, bn)
    assert got[0] % 8 == 0 and got[1] % 128 == 0
