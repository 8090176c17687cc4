"""The port's Mamba2 mixer (repro_torch.models.mamba2) against the
reference's (repro.models.mamba2) on the CPU, in f32.

The same numpy-seeded inputs go through both. Tolerances, stated before
the runs: values within rtol 1e-5 and atol 1e-5 x max|want| (the same f32
operations, other contraction orders); gradients of ``ssd_chunked`` within
rtol 1e-4 and atol 1e-4 x max|want| a leaf (the backward sums over the
chunk and the heads in other orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.base as rbase
import repro.models.mamba2 as rm
import repro_torch.configs.base as tbase
import repro_torch.models.mamba2 as tm

H, P, N = 3, 4, 5


def _close(got, want, rtol=1e-5, atol=1e-5):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * max(1.0, np.abs(want).max()))


def _ssd_inputs(seed, b=2, s=64):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, s, H)))).astype(np.float32)  # softplus
    A_log = (rng.normal(size=(H,)) * 0.5).astype(np.float32)
    B = rng.normal(size=(b, s, N)).astype(np.float32)
    C = rng.normal(size=(b, s, N)).astype(np.float32)
    st = rng.normal(size=(b, H, P, N)).astype(np.float32)
    return x, dt, A_log, B, C, st


def test_segsum_equals_the_reference():
    a = np.random.default_rng(0).normal(size=(2, 3, 9)).astype(np.float32)
    got = tm._segsum(torch.from_numpy(a)).numpy()
    want = np.asarray(rm._segsum(jnp.asarray(a)))
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    _close(torch.from_numpy(got[fin]), want[fin])


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_equals_the_reference(with_state):
    x, dt, A_log, B, C, st = _ssd_inputs(1)
    init = st if with_state else None
    y, fin = tm.ssd_chunked(*(torch.from_numpy(a) for a in (x, dt, A_log, B, C)), 16,
                            init_state=None if init is None else torch.from_numpy(init))
    ry, rfin = rm.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A_log, B, C)), 16,
                              init_state=None if init is None else jnp.asarray(init))
    _close(y, ry)
    _close(fin, rfin)


def test_ssd_chunked_rejects_a_ragged_length():
    x, dt, A_log, B, C, _ = _ssd_inputs(2, s=20)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tm.ssd_chunked(*(torch.from_numpy(a) for a in (x, dt, A_log, B, C)), 16)


def test_ssd_chunked_grad_equals_jax_grad():
    """d/d(x, dt, A_log, B, C) of sum(y * wy) + sum(final * wf), the port's
    autograd against ``jax.grad`` of the reference's."""
    x, dt, A_log, B, C, st = _ssd_inputs(3, s=48)
    rng = np.random.default_rng(4)
    wy = rng.normal(size=x.shape).astype(np.float32)
    wf = rng.normal(size=st.shape).astype(np.float32)

    def ref_obj(x, dt, A_log, B, C):
        y, fin = rm.ssd_chunked(x, dt, A_log, B, C, 16, init_state=jnp.asarray(st))
        return jnp.sum(y * wy) + jnp.sum(fin * wf)

    want = jax.grad(ref_obj, argnums=(0, 1, 2, 3, 4))(*(jnp.asarray(a) for a in (x, dt, A_log, B, C)))
    ins = [torch.from_numpy(a).requires_grad_() for a in (x, dt, A_log, B, C)]
    y, fin = tm.ssd_chunked(*ins, 16, init_state=torch.from_numpy(st))
    got = torch.autograd.grad((y * torch.from_numpy(wy)).sum() + (fin * torch.from_numpy(wf)).sum(),
                              ins)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        _close(g, w, rtol=1e-4, atol=1e-4)


def test_ssd_chunked_grad_finite_where_the_segsum_overflows():
    """Large steps: above the diagonal exp(cs[t] - cs[s]) overflows f32 at
    this chunk (the masked entries reach ~1e3), so a mask taken after the
    exp would give inf there and NaN in the backward pass."""
    x, dt, A_log, B, C, _ = _ssd_inputs(5, b=1, s=128)
    dt = dt * 20.0
    ins = [torch.from_numpy(a).requires_grad_() for a in (x, dt, A_log, B, C)]
    cs = torch.cumsum(ins[1][0, :, 0].detach() * -torch.exp(ins[2][0].detach()), 0)
    assert (cs[0] - cs[-1]).item() > 89.0  # exp of it is inf in f32
    y, fin = tm.ssd_chunked(*ins, 128)
    grads = torch.autograd.grad(y.sum() + fin.sum(), ins)
    assert all(torch.isfinite(g).all() for g in grads)
    assert torch.isfinite(y).all()


def _mixer(seed, d_model=32):
    """Both packages' SSMCfg, the reference's mamba params (f32, made
    non-trivial: random A_log, dt_bias, D, norm, conv_b) and the port's copy."""
    kw = dict(d_state=8, d_conv=4, expand=2, head_dim=16, chunk=16)
    rs, ts = rbase.SSMCfg(**kw), tbase.SSMCfg(**kw)
    p = rm.mamba_init(jax.random.PRNGKey(seed), d_model, rs, jnp.float32)
    rng = np.random.default_rng(seed)
    p = {k: np.asarray(v) for k, v in p.items()}
    for k in ("A_log", "dt_bias", "D", "norm", "conv_b"):
        p[k] = (rng.normal(size=p[k].shape) * 0.3).astype(np.float32)
    return rs, ts, {k: jnp.asarray(v) for k, v in p.items()}, {k: torch.from_numpy(v.copy()) for k, v in p.items()}


@pytest.mark.parametrize("S", [32, 13, 1])
def test_mamba_apply_equals_the_reference(S):
    """S = 32: the chunked SSD; 13 and 1: the sequential recurrence."""
    rs, ts, pr, pt = _mixer(6)
    x = np.random.default_rng(7).normal(size=(2, S, 32)).astype(np.float32)
    out, (st, cv) = tm.mamba_apply(pt, torch.from_numpy(x), ts)
    rout, (rst, rcv) = rm.mamba_apply(pr, jnp.asarray(x), rs)
    _close(out, rout)
    _close(st, rst)
    _close(cv, rcv)
    assert st.dtype == torch.float32 and cv.dtype == torch.float32


@pytest.mark.parametrize("S2", [16, 5, 1])
def test_mamba_apply_continues_from_a_state(S2):
    """A 32-token prefix, then S2 more tokens from its SSM and conv states
    (16: chunked with an initial state; 5 and 1: sequential)."""
    rs, ts, pr, pt = _mixer(8)
    x = np.random.default_rng(9).normal(size=(2, 32 + S2, 32)).astype(np.float32)
    _, (st, cv) = tm.mamba_apply(pt, torch.from_numpy(x[:, :32]), ts)
    _, (rst, rcv) = rm.mamba_apply(pr, jnp.asarray(x[:, :32]), rs)
    out, (st2, cv2) = tm.mamba_apply(pt, torch.from_numpy(x[:, 32:]), ts, state=st, conv_state=cv)
    rout, (rst2, rcv2) = rm.mamba_apply(pr, jnp.asarray(x[:, 32:]), rs, state=rst, conv_state=rcv)
    _close(out, rout)
    _close(st2, rst2)
    _close(cv2, rcv2)


def test_chunked_and_sequential_paths_agree():
    """The port against itself: 48 tokens chunked (3 chunks) and the same
    tokens one at a time from the states."""
    _, ts, _, pt = _mixer(10)
    x = torch.from_numpy(np.random.default_rng(11).normal(size=(1, 48, 32)).astype(np.float32))
    whole, (st_w, _) = tm.mamba_apply(pt, x, ts)
    st = cv = None
    outs = []
    for t in range(48):
        o, (st, cv) = tm.mamba_apply(pt, x[:, t : t + 1], ts, state=st, conv_state=cv)
        outs.append(o)
    _close(torch.cat(outs, 1), whole.numpy())
    _close(st, st_w.numpy())


def test_mamba_init_shapes_and_dtypes_equal_the_reference():
    kw = dict(d_state=8, d_conv=4, expand=2, head_dim=16, chunk=16)
    want = jax.eval_shape(lambda k: rm.mamba_init(k, 32, rbase.SSMCfg(**kw), jnp.bfloat16),
                          jax.random.PRNGKey(0))
    got = tm.mamba_init(torch.Generator().manual_seed(0), 32, tbase.SSMCfg(**kw), torch.bfloat16,
                        device="cpu")
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape and str(got[k].dtype).endswith(str(w.dtype)), k
