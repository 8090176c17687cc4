"""The port's optimizers (repro_torch.optim) against the JAX reference on the
CPU: the warmup-cosine schedule, AdamW, top-k error feedback and int8
quantization, and the compressed all-reduce on 2 spawned gloo ranks.

Tolerances, stated before the runs:
- the schedule: rtol 1e-6 (the same f32 operations; f32 cos may differ by
  an ulp);
- AdamW with f32 moments: params, moments and grad_norm within rtol 1e-5 /
  atol 1e-7 x max|want| after three updates (the same f32 operations in the
  same order; the sums of the norm and the powers of the bias corrections
  may round differently);
- AdamW with bf16 moments: the params as above; the moments within one
  bf16 ulp (rtol 2^-7), since an f32 ulp can move a bf16 rounding;
- top-k, int8 and the compressed sums: exact (selections and single f32
  operations; ties ordered by the lower index, as ``jax.lax.top_k``).
"""
import multiprocessing
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.optim.adamw as radamw
import repro.optim.grad_compress as rgc
import repro.optim.schedule as rsched

import repro_torch.optim as topt
from repro_torch._ops import top_k
from repro_torch._tree import leaves, map_tree
from repro_torch.optim import adamw, grad_compress, schedule

JOIN_S = 240  # a rank that has not finished by then is hung


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


def _close(got, want, rtol, atol=0.0):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(_np(got), want, rtol=rtol,
                               atol=atol * max(1.0, float(np.abs(want).max())))


def test_optim_exports_the_reference_names():
    import repro.optim as ropt

    assert topt.__all__ == ropt.__all__
    for mod in ("adamw", "grad_compress", "schedule"):
        want = {n for n in dir(getattr(ropt, mod)) if not n.startswith("_")
                and callable(getattr(getattr(ropt, mod), n))} - {"NamedTuple", "Tuple"}
        assert want <= set(dir(getattr(topt, mod))), (mod, want - set(dir(getattr(topt, mod))))


@pytest.mark.parametrize("kw", [dict(peak_lr=1e-3, warmup_steps=10, total_steps=60),
                                dict(peak_lr=3e-4, warmup_steps=0, total_steps=7, min_ratio=0.2),
                                dict(peak_lr=2e-3, warmup_steps=5, total_steps=5)])
def test_warmup_cosine_at_each_step(kw):
    for step in range(kw["total_steps"] + 4):
        want = float(rsched.warmup_cosine(jnp.asarray(step, jnp.int32), **kw))
        got_t = schedule.warmup_cosine(torch.tensor(step, dtype=torch.int32), **kw)
        got_n = schedule.warmup_cosine(step, **kw)
        assert got_t.dtype == torch.float32 and got_t.dim() == 0 and isinstance(got_n, float)
        np.testing.assert_allclose([float(got_t), got_n], [want, want], rtol=1e-6)


def _adamw_inputs(seed):
    rng = np.random.default_rng(seed)
    shapes = {"a": (5, 7), "b": {"c": (3, 4, 2), "d": (11,)}}

    def draw(scale):
        return jax.tree.map(lambda s: (rng.normal(size=s) * scale).astype(np.float32), shapes,
                            is_leaf=lambda s: isinstance(s, tuple))

    params = draw(0.5)
    grads = [draw(g) for g in (1.0, 3.0, 0.01)]  # the second clips at grad_clip 1
    grads[2]["a"][0, :3] = 0.0  # zero grads: the update is weight decay alone
    return params, grads


def _to_torch(tree, dtype=torch.float32):
    if isinstance(tree, dict):
        return {k: _to_torch(v, dtype) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).to(dtype)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_update_matches_the_reference(moments):
    mdt_j, mdt_t = {"float32": (jnp.float32, torch.float32),
                    "bfloat16": (jnp.bfloat16, torch.bfloat16)}[moments]
    params, grads = _adamw_inputs(0)
    pj = jax.tree.map(jnp.asarray, params)
    sj = radamw.init(pj, mdt_j)
    pt = _to_torch(params)
    st = adamw.init(pt, mdt_t)
    assert st.m["b"]["c"].dtype == mdt_t and int(st.step) == 0
    for i, (g, lr) in enumerate(zip(grads, (1e-2, 3e-3, 5e-2))):
        pj, sj, mj = radamw.update(jax.tree.map(jnp.asarray, g), sj, pj, lr=lr)
        pt, st, mt = adamw.update(_to_torch(g), st, pt, lr=torch.tensor(lr), weight_decay=0.1)
        assert int(st.step) == int(sj.step) == i + 1
        _close(mt["grad_norm"], mj["grad_norm"], 1e-5)
        for got, want in zip(leaves(pt),
                             jax.tree.leaves(pj)):
            _close(got, want, 1e-5, 1e-7)
        mrtol = 1e-5 if moments == "float32" else 2.0**-7
        for tree_t, tree_j in ((st.m, sj.m), (st.v, sj.v)):
            for got, want in zip(leaves(tree_t),
                                 jax.tree.leaves(tree_j)):
                assert got.dtype == mdt_t
                _close(got, np.asarray(want, np.float32), mrtol, 1e-7)


def test_adamw_moments_dtype_and_in_place():
    """tests/test_train_loop.py::test_adamw_moments_dtype on the port; the
    update writes the caller's params and moments."""
    params = {"w": torch.zeros((4, 4), dtype=torch.bfloat16)}
    st = adamw.init(params, torch.bfloat16)
    assert st.m["w"].dtype == torch.bfloat16
    grads = {"w": torch.ones((4, 4), dtype=torch.bfloat16)}
    newp, st2, metrics = adamw.update(grads, st, params, lr=1e-2)
    assert newp["w"].dtype == torch.bfloat16 and newp["w"] is params["w"]
    assert float(metrics["grad_norm"]) > 0
    assert int(st2.step) == 1 and st2.m["w"] is st.m["w"] and float(st.m["w"][0, 0]) != 0.0
    with pytest.raises(ValueError, match="contiguous"):
        adamw.update(grads, st2, {"w": torch.zeros((4, 4), dtype=torch.bfloat16).T}, lr=1e-2)


def test_adamw_chunked_update_changes_no_bit(monkeypatch):
    params, grads = _adamw_inputs(1)
    runs = []
    for chunk in (adamw.CHUNK, 5):
        monkeypatch.setattr(adamw, "CHUNK", chunk)
        pt = _to_torch(params)
        st = adamw.init(pt)
        for g in grads:
            pt, st, _ = adamw.update(_to_torch(g), st, pt, lr=1e-2)
        runs.append(leaves(pt))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# top-k, int8, error feedback
# ---------------------------------------------------------------------------


def test_top_k_orders_ties_by_the_lower_index():
    x = np.array([[1.0, 3.0, 3.0, 2.0, 3.0, -3.0, 3.0],
                  [0.0, 0.0, 0.0, 0.0, 5.0, 0.0, 0.0]], np.float32)
    for k in (1, 2, 3, 5, 7):
        vals, idx = top_k(torch.from_numpy(x), k)
        rv, ri = jax.lax.top_k(jnp.asarray(x), k)
        assert np.array_equal(vals.numpy(), np.asarray(rv))
        assert np.array_equal(idx.numpy(), np.asarray(ri)), (k, idx, ri)


@pytest.mark.parametrize("frac", [0.1, 0.25, 0.5])
def test_topk_compress_with_ties_matches_the_reference(frac):
    rng = np.random.default_rng(2)
    x = rng.integers(-4, 5, size=(6, 10)).astype(np.float32)  # many equal magnitudes
    vals, idx = grad_compress.topk_compress(torch.from_numpy(x), frac)
    rv, ri = rgc.topk_compress(jnp.asarray(x), frac)
    assert np.array_equal(idx.numpy(), np.asarray(ri)) and np.array_equal(vals.numpy(), rv)
    dense = grad_compress.topk_decompress(vals, idx, x.shape, torch.float32)
    assert np.array_equal(dense.numpy(), rgc.topk_decompress(rv, ri, x.shape, jnp.float32))


def test_int8_quant_matches_the_reference():
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(9, 13)) * 2).astype(np.float32)
    x[0, :3] = [0.0, -0.0, 1e-30]
    q, s = grad_compress.int8_quant(torch.from_numpy(x))
    rq, rs = rgc.int8_quant(jnp.asarray(x))
    assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(rq))
    assert float(s) == float(rs)
    assert np.array_equal(grad_compress.int8_dequant(q, s).numpy(),
                          np.asarray(rgc.int8_dequant(rq, rs)))


def _grad_tree(seed, ties=True):
    rng = np.random.default_rng(seed)
    g = {"w": rng.normal(size=(8, 6)).astype(np.float32),
         "layers": {"a": rng.integers(-3, 4, size=(4, 5)).astype(np.float32) if ties
                    else rng.normal(size=(4, 5)).astype(np.float32),
                    "b": rng.normal(size=(7,)).astype(np.float32)}}
    return g


def test_compress_grads_topk_with_error_feedback_matches_the_reference():
    ef_t = grad_compress.ef_init(_to_torch(_grad_tree(0)))
    ef_j = rgc.ef_init(jax.tree.map(jnp.asarray, _grad_tree(0)))
    for rnd in range(3):
        g = _grad_tree(10 + rnd)
        dt, ef_t = grad_compress.compress_grads_topk(_to_torch(g), ef_t, 0.2)
        dj, ef_j = rgc.compress_grads_topk(jax.tree.map(jnp.asarray, g), ef_j, 0.2)
        for tt, tj in ((dt, dj), (ef_t.residual, ef_j.residual)):
            for a, b in zip([t.numpy() for t in leaves(tt)],
                            jax.tree.leaves(tj)):
                assert np.array_equal(a, np.asarray(b))


def _psum_rank(rank, world, path):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{path}/store", rank=rank,
                            world_size=world)
    try:
        mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("pod",))
        ef = grad_compress.ef_init(_to_torch(_grad_tree(0)))
        out = []
        for rnd in range(2):  # the residual carried into the second round
            g = _to_torch(_grad_tree(100 * rank + rnd))
            dense, ef = grad_compress.compressed_psum_pods(g, mesh, 0.25, ef)
            out.append((map_tree(lambda t: t.numpy(), dense),
                        map_tree(lambda t: t.numpy(), ef.residual)))
        with open(f"{path}/rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def test_compressed_psum_pods_on_two_gloo_ranks(tmp_path):
    """Each rank's result equals the sum over the ranks of their own
    ``compress_grads_topk`` (each carrying its residual) over 2, and its
    residual its own, bit for bit."""
    world = 2
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_psum_rank, args=(r, world, str(tmp_path)))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_S)
    hung = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    assert not hung and [p.exitcode for p in procs] == [0] * world
    outs = [pickle.load(open(tmp_path / f"rank{r}.pkl", "rb")) for r in range(world)]
    efs = [grad_compress.ef_init(_to_torch(_grad_tree(0))) for _ in range(world)]
    for rnd in range(2):
        local = []
        for r in range(world):
            d, efs[r] = grad_compress.compress_grads_topk(_to_torch(_grad_tree(100 * r + rnd)),
                                                          efs[r], 0.25)
            local.append(d)
        want = map_tree(lambda a, b: ((a + b) / world).numpy(), *local)
        for r in range(world):
            dense, resid = outs[r][rnd]
            for a, b in zip(jax.tree.leaves(dense), jax.tree.leaves(want)):
                assert np.array_equal(a, b)
            for a, b in zip(jax.tree.leaves(resid),
                            jax.tree.leaves(map_tree(lambda t: t.numpy(),
                                                           efs[r].residual))):
                assert np.array_equal(a, b)
