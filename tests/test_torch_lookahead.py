"""B3 and the Algorithm-2 path of the port against the JAX reference.

The same seeded numpy inputs go through the reference (``repro.kernels.ops.
streamsvm_fit_many`` with its Pallas kernel in interpret mode, the
plain-python oracle ``repro.kernels.ref.streamsvm_scan_lookahead_many_ref``
and ``repro.core``) and through the port on the CPU, which runs B3's plain
version. Tolerances: rtol 2e-4 / atol 2e-5 on ``w`` (f32 sums in another
order), rtol 1e-4 on ``r``, rtol 1e-3 / atol 1e-6 on ``xi2``; core-vector
counts ``m`` exactly. Within the port, the bank's tiling changes no bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fit_lookahead as jfit_lookahead
from repro.core import fit_ovr as jfit_ovr
from repro.kernels import ops as jops
from repro.kernels.ref import streamsvm_scan_lookahead_many_ref
from repro_torch.convert import ball_from_numpy, ball_to_numpy
from repro_torch.core import fit_bank, fit_chunked_many, fit_lookahead, fit_ovr, predict_ovr
from repro_torch.kernels import ops
from repro_torch.kernels.streamsvm_scan import (
    streamsvm_scan_lookahead_many,
    streamsvm_scan_lookahead_many_plain,
    streamsvm_scan_many,
)


def _bank_data(b, n, d, seed, sign0=0.0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
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


def _oracle(X, Y, cs, ls, variant="lookahead", start=None):
    c_inv = 1.0 / cs
    gain = c_inv if variant == "lookahead" else np.ones_like(c_inv)
    if start is None:
        return streamsvm_scan_lookahead_many_ref(
            X[1:], Y[:, 1:], Y[:, 0:1] * X[0][None, :], 0.0, gain, c_inv, 1, ls, gain=gain
        )
    w, r, xi2, m = start
    return streamsvm_scan_lookahead_many_ref(X, Y, w, r, xi2, c_inv, m, ls, gain=gain)


@pytest.mark.parametrize("b,n,d,block_n,b_tile,ls,sign0", [
    (5, 257, 16, 64, 8, (1, 4, 7, 100, 3), 0.0),  # per-model L, L > block_n
    (8, 400, 24, 128, 8, 10, 0.05),               # shared L, sign-0 rows
    (3, 129, 7, 256, None, (2, 300, 5), 0.0),     # L >> N: one final flush
    (12, 300, 33, 64, 8, 6, 0.03),                # ragged B and D
    (13, 200, 20, 64, 8, (1, 16) * 6 + (3,), 0.0),  # L mixing 1 and 16
])
@pytest.mark.parametrize("variant", ["lookahead", "lookahead-paper"])
def test_fit_many_lookahead_matches_jax_engine_and_oracle(b, n, d, block_n, b_tile, ls, sign0,
                                                           variant):
    X, Y, cs = _bank_data(b, n, d, seed=7 * b + n, sign0=sign0)
    kw = dict(variant=variant, lookahead=ls, block_n=block_n, b_tile=b_tile)
    port = _port_fit(X, Y, cs, **kw)
    ref = jops.streamsvm_fit_many(jnp.asarray(X), jnp.asarray(Y), jnp.asarray(cs), **kw)
    _assert_bank_close(port, ref)
    _assert_bank_close(port, _oracle(X, Y, cs, ls, variant))


@pytest.mark.parametrize("variant", ["lookahead", "lookahead-paper"])
def test_lookahead_continues_from_balls(variant):
    b, n, L, cut = 6, 360, 5, 150
    X, Y, cs = _bank_data(b, n, 10, seed=11, sign0=0.02)
    kw = dict(variant=variant, lookahead=L, block_n=64, b_tile=8)
    head = _port_fit(X[:cut], Y[:, :cut], cs, **kw)
    rest = _port_fit(X[cut:], Y[:, cut:], cs, head, **kw)
    jhead = jops.streamsvm_fit_many(jnp.asarray(X[:cut]), jnp.asarray(Y[:, :cut]),
                                    jnp.asarray(cs), **kw)
    jrest = jops.streamsvm_fit_many(jnp.asarray(X[cut:]), jnp.asarray(Y[:, cut:]),
                                    jnp.asarray(cs), jhead, **kw)
    _assert_bank_close(rest, jrest)
    # The oracle chunk by chunk, each pass with its trailing flush.
    mid = _oracle(X[:cut], Y[:, :cut], cs, L, variant)
    _assert_bank_close(rest, _oracle(X[cut:], Y[:, cut:], cs, L, variant, start=mid))


def test_bf16_stream_matches_jax_bf16():
    X, Y, cs = _bank_data(10, 300, 16, seed=23)
    kw = dict(variant="lookahead", lookahead=(4, 1, 7, 2, 3, 9, 4, 4, 2, 5), stream_dtype="bf16",
              block_n=64, b_tile=8)
    port = _port_fit(X, Y, cs, **kw)
    ref = jops.streamsvm_fit_many(jnp.asarray(X), jnp.asarray(Y), jnp.asarray(cs), **kw)
    _assert_bank_close(port, ref)


def test_b_tile_does_not_change_a_bit():
    X, Y, cs = _bank_data(21, 300, 12, seed=3, sign0=0.02)
    ls = tuple(range(1, 22))
    fits = [
        _port_fit(X, Y, cs, variant="lookahead", lookahead=ls, block_n=64, b_tile=bt)
        for bt in (8, 16, 64)
    ]
    for other in fits[1:]:
        for a, c in zip(fits[0], other):
            assert torch.equal(a, c)


def test_lookahead_one_equals_algorithm_1():
    """L = 1 buffers each violator and flushes it at once: Algorithm 1."""
    X, Y, cs = _bank_data(6, 300, 12, seed=2)
    la = _port_fit(X, Y, cs, variant="lookahead", lookahead=1, block_n=64)
    a1 = _port_fit(X, Y, cs, block_n=64)
    torch.testing.assert_close(la.w, a1.w, rtol=2e-5, atol=2e-6)
    assert torch.equal(la.m, a1.m)


@pytest.mark.parametrize("engine", ["pallas", "qp"])
@pytest.mark.parametrize("variant", ["exact", "paper-listing"])
def test_fit_lookahead_matches_repro_core(engine, variant):
    rng = np.random.default_rng(21)
    X = rng.normal(size=(400, 14)).astype(np.float32)
    y = np.sign(rng.normal(size=400)).astype(np.float32)
    port = fit_lookahead(torch.from_numpy(X), torch.from_numpy(y), 10.0, 8, engine=engine,
                         variant=variant, block_n=64)
    ref = jfit_lookahead(jnp.asarray(X), jnp.asarray(y), 10.0, 8, engine=engine,
                         variant=variant, block_n=64)
    _assert_bank_close(port, ref)


def test_fit_ovr_lookahead_matches_repro():
    rng = np.random.default_rng(31)
    proto = rng.normal(size=(6, 16)) * 4
    labels = rng.integers(0, 6, size=900)
    X = (rng.normal(size=(900, 16)) + proto[labels]).astype(np.float32)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    port = fit_ovr(torch.from_numpy(X), torch.from_numpy(labels), 6, 10.0, lookahead=8, b_tile=8)
    ref = jfit_ovr(jnp.asarray(X), jnp.asarray(labels), 6, 10.0, lookahead=8, b_tile=8)
    _assert_bank_close(port, ref)
    assert (predict_ovr(port, X).numpy() == labels).mean() > 0.9


def test_fit_chunked_many_lookahead_flushes_per_chunk():
    X, Y, cs = _bank_data(5, 500, 10, seed=19)
    chunks = [(X[lo : lo + 200], Y[:, lo : lo + 200]) for lo in range(0, 500, 200)]
    kw = dict(variant="lookahead-paper", lookahead=(3, 1, 6, 2, 4), block_n=64)
    port = fit_chunked_many(chunks, cs, device="cpu", **kw)
    bank = None
    for Xc, Yc in chunks:
        bank = jops.streamsvm_fit_many(jnp.asarray(Xc), jnp.asarray(Yc), jnp.asarray(cs), bank,
                                       **kw)
    assert port.position == 500
    _assert_bank_close(port.ball, bank)


def test_kernel_wrapper_runs_plain_version_on_cpu():
    """On a CPU tensor the B3 wrapper is the plain version and counts no
    launch; B1's wrapper hands a lookahead call to it."""
    X, Y, cs = _bank_data(8, 128, 8, seed=4)
    t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt)
    args = (t(X[1:]), t(Y[:, 1:]), t(Y[:, :1] * X[:1]), t(np.zeros(8)), t(1 / cs),
            t(1 / cs), t(np.ones(8), torch.int32), t(1 / cs))
    kw = dict(lookahead=t(np.full(8, 3), torch.int32), lookahead_max=3, n_valid=127, block_n=127)
    before = streamsvm_scan_lookahead_many.launches
    a = streamsvm_scan_lookahead_many(*args, **kw)
    b = streamsvm_scan_lookahead_many_plain(*args, **kw)
    c = streamsvm_scan_many(*args, **kw)
    assert streamsvm_scan_lookahead_many.launches == before
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y) and torch.equal(x, z)


def test_bad_arguments_raise():
    X, Y, cs = _bank_data(4, 20, 4, seed=1)
    with pytest.raises(ValueError, match="requires variant"):
        _port_fit(X, Y, cs, lookahead=3)
    with pytest.raises(ValueError, match="length-B"):
        _port_fit(X, Y, cs, variant="lookahead", lookahead=(2, 2))
    with pytest.raises(ValueError, match="length-B"):
        _port_fit(X, Y, cs, variant="lookahead", lookahead=0)
    with pytest.raises(ValueError, match="engine"):
        fit_lookahead(torch.from_numpy(X), torch.from_numpy(Y[0]), 1.0, 4, engine="scan")
    with pytest.raises(ValueError, match="variant"):
        fit_lookahead(torch.from_numpy(X), torch.from_numpy(Y[0]), 1.0, 4, variant="lookahead")
    hbm = fit_bank(X, Y, cs, device="cpu", variant="lookahead", lookahead=2, bank_resident="hbm")
    vmem = fit_bank(X, Y, cs, device="cpu", variant="lookahead", lookahead=2, bank_resident="vmem")
    assert all(torch.equal(a, b) for a, b in zip(hbm, vmem))  # B6 runs, as B3
    X, Y, cs = _bank_data(8, 20, 4, seed=1)
    start = ball_from_numpy((Y[:, 0:1] * X[0], np.zeros(8), 1 / cs, np.ones(8)), device="cpu")
    with pytest.raises(ValueError, match="lookahead_max"):
        streamsvm_scan_lookahead_many_plain(
            torch.from_numpy(X), torch.from_numpy(Y), *start[:3], torch.from_numpy(1 / cs),
            start.m, torch.from_numpy(1 / cs), lookahead=torch.ones(8, dtype=torch.int32),
            lookahead_max=None, n_valid=20, block_n=20,
        )
