"""The LLM zoo's training path on the port (repro_torch.train, the models'
differentiable losses, remat, MoE) against the JAX reference on the CPU.

Smoke configs in f32; inputs from numpy seeds; the reference's params
carried across by ``convert.lm_params_from_numpy``. Tolerances, stated
before the runs:
- ``loss``: rtol 1e-5; its grads (``torch.autograd`` against ``jax.grad``)
  within 1e-4 x the leaf's max|grad| (the same f32 operations, other
  summation orders, and the backward's products summed in other orders);
- ``moe_apply``: out within 1e-5 x max|out|, aux rtol 1e-5, and the dropped
  (token, expert) set equal;
- ``make_train_step`` over 6 steps: losses rtol 1e-4; the first step's
  grads as above (through its grad_norm, rtol 1e-5); the params within
  2 x the summed lr of the steps (AdamW's early steps move an entry by about
  lr sign(g), so an entry whose grad is at rounding level can go either
  way) and 99.9 % of entries within 1e-4 x max|param|;
- remat "full" and selective against "none": the same loss and grads bit
  for bit (the recomputed forward is the same operations);
- ``microbatches=4`` against 1 and the loss falling: tests/test_train_loop.py's
  own tolerances (loss rtol 2e-2; params rtol 0.1, atol 2e-2; a fall of 0.5
  over 15 steps).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rcfg
import repro.models.moe as rmoe
import repro.optim.adamw as radamw
from repro.models import build_model as ref_build
from repro.train import TrainCfg as RTrainCfg
from repro.train import init_state as r_init_state
from repro.train import make_train_step as r_make_train_step

import repro_torch.configs as tcfg
import repro_torch.train as ttrain
from repro_torch._tree import leaves
from repro_torch.configs.base import MoECfg
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import build_model
from repro_torch.models.moe import moe_apply
from repro_torch.optim import adamw
from repro_torch.train import TrainCfg, init_state, make_train_step

KEY = jax.random.PRNGKey(0)
CPU = torch.device("cpu")
LOSS_ARCHS = ["internlm2-1.8b", "qwen3-moe-30b-a3b", "llava-next-mistral-7b", "xlstm-125m"]


def _f32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32", act_dtype="float32")


def _cfgs(arch):
    return _f32(rcfg.get_config(arch, smoke=True)), _f32(tcfg.get_config(arch, smoke=True))


def _batch(cfg, b=4, s=16, seed=0, image=False):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
           "targets": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if image and cfg.family == "vlm":
        out["image_embeds"] = (rng.normal(size=(b, cfg.n_patches, cfg.d_model)) * 0.02).astype(
            np.float32)
    return out


def _params(arch, seed=0):
    cfg_r, cfg_t = _cfgs(arch)
    pj = jax.jit(ref_build(cfg_r).init)(jax.random.PRNGKey(seed))
    return cfg_r, cfg_t, pj, lm_params_from_numpy(cfg_t, jax.tree.map(np.asarray, pj), device=CPU)


def _grads_port(model, params, batch):
    ps = jax.tree.map(lambda t: t.detach().requires_grad_(), params)
    loss, metrics = model.loss(ps, {k: torch.as_tensor(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves(ps))
    return loss.detach(), metrics, grads


def _grad_close(got, want, tol=1e-4):
    for g, w in zip(got, jax.tree.leaves(want)):
        w = np.asarray(w, np.float32)
        err = float(np.abs(g.detach().numpy() - w).max())
        assert err <= tol * max(float(np.abs(w).max()), 1e-12), (err, float(np.abs(w).max()))


@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_loss_and_grads_match_the_reference(arch):
    cfg_r, cfg_t, pj, pt = _params(arch)
    batch = _batch(cfg_t, image=True)
    (lj, mj), gj = jax.jit(jax.value_and_grad(ref_build(cfg_r).loss, has_aux=True))(
        pj, jax.tree.map(jnp.asarray, batch))
    lt, mt, gt = _grads_port(build_model(cfg_t), pt, batch)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    np.testing.assert_allclose(float(mt["ce"]), float(mj["ce"]), rtol=1e-5)
    np.testing.assert_allclose(float(mt["aux"]), float(mj["aux"]), rtol=1e-5)
    if cfg_t.moe is not None:
        assert float(mt["aux"]) > 0.5  # E * sum f p: 1 when balanced
    _grad_close(gt, gj)


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "qwen3-moe-30b-a3b", "xlstm-125m"])
def test_remat_modes_give_the_same_loss_and_grads(arch, remat):
    _, cfg_t, _, pt = _params(arch)
    batch = _batch(cfg_t, seed=1)
    l0, _, g0 = _grads_port(build_model(cfg_t, remat="none"), pt, batch)
    l1, _, g1 = _grads_port(build_model(cfg_t, remat=remat), pt, batch)
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_selective_remat_saves_products_and_recomputes_the_rest():
    """"dots" keeps the unbatched products' outputs: its backward recomputes
    fewer matrix products than "full" and more than "none"."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default):
                self.n += 1
            return func(*args, **(kwargs or {}))

    _, cfg_t, _, pt = _params("internlm2-1.8b")
    batch = _batch(cfg_t, seed=2)
    counts = {}
    for remat in ("none", "dots", "full"):
        ps = jax.tree.map(lambda t: t.detach().requires_grad_(), pt)
        loss, _ = build_model(cfg_t, remat=remat).loss(
            ps, {k: torch.as_tensor(v) for k, v in batch.items()})
        with Count() as c:
            torch.autograd.grad(loss, leaves(ps))
        counts[remat] = c.n
    assert counts["none"] < counts["dots"] < counts["full"], counts


def test_moe_decoder_init():
    cfg = tcfg.get_config("qwen3-moe-30b-a3b", smoke=True)
    p = build_model(cfg).init(torch.Generator().manual_seed(0), device=CPU)
    lay = p["layers"]
    assert "mlp" not in lay and set(lay["moe"]) == {"router", "w1", "w2", "w3"}
    E, Fd, L, D = cfg.moe.n_experts, cfg.moe.d_ff, cfg.n_layers, cfg.d_model
    assert lay["moe"]["router"].dtype == torch.float32 and lay["moe"]["w1"].dtype == torch.bfloat16
    assert tuple(lay["moe"]["w1"].shape) == (L, E, D, Fd)
    assert tuple(lay["moe"]["w2"].shape) == (L, E, Fd, D)
    # init_dense's fan_in of an (E, D, F) leaf is E * D, as the reference's
    std = float(lay["moe"]["w1"].float().std())
    assert abs(std * (E * D) ** 0.5 - 1.0) < 0.05, std


# ---------------------------------------------------------------------------
# moe_apply
# ---------------------------------------------------------------------------


def _ref_dropped(p, x, cfg):
    """The reference's dropped (token, expert) pairs, from its routing lines
    (src/repro/models/moe.py:38-51) in jnp."""
    B, S, D = x.shape
    T, E, K = B * S, cfg.n_experts, cfg.top_k
    C = max(1, int(cfg.capacity_factor * T * K / E))
    probs = jax.nn.softmax(jnp.asarray(x).reshape(T, D).astype(jnp.float32) @ p["router"], -1)
    _, eidx = jax.lax.top_k(probs, K)
    flat_e = eidx.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    counts = jnp.bincount(flat_e, length=E)
    pos = jnp.arange(T * K) - (jnp.cumsum(counts) - counts)[flat_e[order]]
    drop = np.asarray(order)[np.asarray(pos) >= C]
    return {(int(i // K), int(np.asarray(flat_e)[i])) for i in drop}


@pytest.mark.parametrize("cf,want_drops", [(1.25, None), (0.5, True), (4.0, False)])
def test_moe_apply_matches_the_reference(cf, want_drops):
    E, K, D, Fd = 8, 2, 32, 48
    mcfg = MoECfg(n_experts=E, top_k=K, d_ff=Fd, capacity_factor=cf)
    pj = rmoe.moe_init(jax.random.PRNGKey(3), D, mcfg, jnp.float32)
    pt = {k: torch.from_numpy(np.asarray(v)) for k, v in pj.items()}
    x = np.random.default_rng(4).normal(size=(3, 10, D)).astype(np.float32)
    oj, aj = rmoe.moe_apply(pj, jnp.asarray(x), mcfg)
    stats = []
    ot, at = moe_apply(pt, torch.from_numpy(x), mcfg, stats=stats)
    want = np.asarray(oj)
    assert float(np.abs(ot.numpy() - want).max()) <= 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-5)
    st = stats[0]
    ex, kept = st["experts"].numpy(), st["kept"].numpy()
    got = {(t, int(ex[t, k])) for t, k in zip(*np.nonzero(~kept))}
    assert got == _ref_dropped(pj, x, mcfg)
    assert int(st["dropped"]) == len(got) and st["capacity"] == max(1, int(cf * 30 * K / E))
    if want_drops is not None:
        assert bool(got) == want_drops


# ---------------------------------------------------------------------------
# make_train_step
# ---------------------------------------------------------------------------


def test_train_step_trajectory_matches_the_reference():
    cfg_r, cfg_t, pj, pt = _params("internlm2-1.8b")
    kw = dict(peak_lr=1e-3, warmup_steps=2, total_steps=20)
    sj = {"params": pj, "opt": radamw.init(pj)}
    st = {"params": pt, "opt": adamw.init(pt)}
    step_j = jax.jit(r_make_train_step(ref_build(cfg_r), RTrainCfg(**kw)))
    step_t = make_train_step(build_model(cfg_t), TrainCfg(**kw))
    lr_sum = 0.0
    for i in range(6):
        b = _batch(cfg_t, seed=10 + i)
        sj, mj = step_j(sj, jax.tree.map(jnp.asarray, b))
        st, mt = step_t(st, {k: torch.as_tensor(v) for k, v in b.items()})
        np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(mt["lr"]), float(mj["lr"]), rtol=1e-6)
        if i == 0:  # the same params: the grads themselves agree
            assert float(mt["lr"]) == 0.0
            np.testing.assert_allclose(float(mt["grad_norm"]), float(mj["grad_norm"]), rtol=1e-5)
        lr_sum += float(mt["lr"])
    assert int(st["opt"].step) == 6
    for got, want in zip(leaves(st["params"]), jax.tree.leaves(sj["params"])):
        want = np.asarray(want)
        err = np.abs(got.numpy() - want)
        assert err.max() <= 2 * lr_sum * (1 + 0.1 * np.abs(want).max()), (err.max(), lr_sum)
        assert (err <= 1e-4 * max(np.abs(want).max(), 1e-6)).mean() >= 0.999


def test_train_step_grads_equal_the_references_grads():
    """The first step's grads directly: the port's autograd against
    jax.grad of the reference's loss, through a recording update."""
    cfg_r, cfg_t, pj, pt = _params("qwen3-moe-30b-a3b", seed=1)
    b = _batch(cfg_t, seed=3)
    seen = {}
    real = adamw.update

    def record(grads, *a, **k):
        seen["g"] = [g.clone() for g in leaves(grads)]
        return real(grads, *a, **k)

    adamw.update = record
    try:
        make_train_step(build_model(cfg_t), TrainCfg())(
            {"params": pt, "opt": adamw.init(pt)}, {k: torch.as_tensor(v) for k, v in b.items()})
    finally:
        adamw.update = real
    _, gj = jax.jit(jax.value_and_grad(ref_build(cfg_r).loss, has_aux=True))(
        pj, jax.tree.map(jnp.asarray, b))
    _grad_close(seen["g"], gj)


def _toy():
    """tests/test_train_loop.py's _toy on the port."""
    cfg = tcfg.get_config("internlm2-1.8b", smoke=True)
    model = build_model(cfg)
    rng = np.random.default_rng(0)
    batch = {
        "tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (8, 32)), dtype=torch.int32),
        "targets": torch.as_tensor(rng.integers(0, 64, (8, 32)), dtype=torch.int32),
    }
    return cfg, model, batch


def test_loss_decreases():
    cfg, model, batch = _toy()
    tc = TrainCfg(peak_lr=1e-3, warmup_steps=2, total_steps=40)
    state = init_state(model, torch.Generator().manual_seed(0), tc)
    step = make_train_step(model, tc)
    losses = []
    for _ in range(15):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses


def test_microbatch_equals_fullbatch_grads():
    """A=4 accumulation must match A=1 (same data) up to fp tolerance."""
    cfg, model, batch = _toy()
    s1 = init_state(model, torch.Generator().manual_seed(0), TrainCfg(microbatches=1))
    s4 = init_state(model, torch.Generator().manual_seed(0), TrainCfg(microbatches=4))
    o1, m1 = make_train_step(model, TrainCfg(microbatches=1))(s1, batch)
    o4, m4 = make_train_step(model, TrainCfg(microbatches=4))(s4, batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]), rtol=2e-2)
    for a, b in zip(leaves(o1["params"]), leaves(o4["params"])):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), rtol=0.1, atol=2e-2)


def test_microbatches_against_the_reference():
    """Four microbatches on the port against four on the reference, f32:
    the f32 sum of the four grads then / 4 (the reference's scan)."""
    cfg_r, cfg_t, pj, pt = _params("internlm2-1.8b", seed=2)
    b = _batch(cfg_t, b=8, seed=5)
    kw = dict(microbatches=4, peak_lr=1e-3, warmup_steps=1, total_steps=10)
    sj = r_init_state(ref_build(cfg_r), jax.random.PRNGKey(2), RTrainCfg(**kw))
    sj = {"params": pj, "opt": sj["opt"]}
    st = {"params": pt, "opt": adamw.init(pt)}
    step_j = jax.jit(r_make_train_step(ref_build(cfg_r), RTrainCfg(**kw)))
    step_t = make_train_step(build_model(cfg_t), TrainCfg(**kw))
    for _ in range(2):
        sj, mj = step_j(sj, jax.tree.map(jnp.asarray, b))
        st, mt = step_t(st, {k: torch.as_tensor(v) for k, v in b.items()})
        np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(mt["grad_norm"]), float(mj["grad_norm"]), rtol=1e-4)


def test_init_state_and_exports():
    import repro.train as rtrain

    assert ttrain.__all__ == rtrain.__all__
    assert [f.name for f in dataclasses.fields(TrainCfg)] == [
        f.name for f in dataclasses.fields(RTrainCfg)]
    assert dataclasses.asdict(TrainCfg()) == dataclasses.asdict(RTrainCfg())
    cfg = tcfg.get_config("internlm2-1.8b", smoke=True)
    st = init_state(build_model(cfg), torch.Generator().manual_seed(0),
                    TrainCfg(moment_dtype="bfloat16"))
    assert st["params"]["embed"].device == CPU and st["opt"].m["embed"].dtype == torch.bfloat16
    assert int(st["opt"].step) == 0
