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
    (dict(variant="lookahead", mesh=object()), "A10"),
    (dict(variant="lookahead-paper", lookahead=3, bank_resident="hbm"), None),
    (dict(bank_resident="hbm"), None),
    (dict(mesh=object()), "A10"),
])
def test_unported_options_raise(kw, what):
    """mesh= (A10) still raises; bank_resident="hbm" (B6, the ring) runs and
    gives the bits of "vmem"."""
    X, Y, cs = _bank_data(4, 20, 4, seed=1)
    if what is not None:
        with pytest.raises(NotImplementedError, match=what):
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
