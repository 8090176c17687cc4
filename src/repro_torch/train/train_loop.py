"""Training step factory: microbatch gradient accumulation, remat, AdamW.

The port of the reference's ``train/train_loop.py``. ``make_train_step``
returns a ``(state, batch) -> (state, metrics)`` function: the loss's
gradients by ``torch.autograd`` on the params (``grads_of``), accumulated in
f32 over ``microbatches`` equal splits of the batch (``accumulate``; the
reference's ``lax.scan``) and divided by their count in place, then one
AdamW update at the schedule's lr for the steps taken so far (0 at the
first step, as the reference reads it before the increment;
``apply_update``). Remat is configured on the model (``build_model(cfg,
remat=...)``). The step writes the params and moments in place and returns
them (the reference's callers donate the state). The dry run runs the
halves apart to read the memory of each.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch._tree import map_tree
from repro_torch.optim import adamw, schedule


@dataclasses.dataclass(frozen=True)
class TrainCfg:
    microbatches: int = 1
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"


def init_state(model, generator, tcfg: TrainCfg, device=None):
    """``{"params", "opt"}``: the model's params from ``generator`` on
    ``device`` (default: the generator's device) and zero AdamW moments of
    ``tcfg.moment_dtype``."""
    if device is None and generator is not None:
        device = generator.device
    params = model.init(generator, device=device)
    mdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[tcfg.moment_dtype]
    return {"params": params, "opt": adamw.init(params, mdt)}


def _tree_leaves(tree) -> list:
    out = []
    map_tree(out.append, tree)
    return out


def _rebuild(tree, values):
    """``tree``'s structure with its leaves, in ``map_tree``'s order, replaced
    by ``values``."""
    it = iter(values)
    return map_tree(lambda _: next(it), tree)


def grads_of(model, params, mb):
    """(loss, the grads of the loss in the params' dtypes, as a list in
    ``map_tree``'s order) of one microbatch."""
    leaves = [p.detach().requires_grad_() for p in _tree_leaves(params)]
    with torch.enable_grad():
        loss, _ = model.loss(_rebuild(params, leaves), mb)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, leaves)]
    return loss.detach(), grads


def accumulators(params):
    """(the loss's sum, the grads' sums): f32 zeros, a leaf per param."""
    grads = [torch.zeros_like(p, dtype=torch.float32) for p in _tree_leaves(params)]
    return torch.zeros((), dtype=torch.float32, device=grads[0].device), grads


def _add_into(sums, grads):
    for s, g in zip(sums, grads):
        s.add_(g)


def accumulate(model, params, batch, A: int):
    """(loss, grads) of ``batch`` in ``A`` equal microbatches: the f32 sums
    over them divided by A, in place. One microbatch's grads are released
    before the next one runs."""
    b = batch["tokens"].shape[0]
    if b % A:
        raise ValueError(f"batch {b} does not split into {A} microbatches")
    s = b // A
    loss, grads = accumulators(params)
    for a in range(A):
        l, g = grads_of(model, params, {k: v[a * s : (a + 1) * s] for k, v in batch.items()})
        _add_into(grads, g)
        loss.add_(l)
        del l, g
    for g in grads:
        g.div_(A)
    return loss.div_(A), grads


def apply_update(tcfg: TrainCfg, state, loss, grads):
    """One AdamW update of ``state`` by ``grads`` (a list in ``map_tree``'s
    order) at the schedule's lr: (the new state, the step's metrics)."""
    params = state["params"]
    lr = schedule.warmup_cosine(
        state["opt"].step,
        peak_lr=tcfg.peak_lr,
        warmup_steps=tcfg.warmup_steps,
        total_steps=tcfg.total_steps,
    )
    new_params, new_opt, opt_metrics = adamw.update(
        _rebuild(params, grads),
        state["opt"],
        params,
        lr=lr,
        weight_decay=tcfg.weight_decay,
        grad_clip=tcfg.grad_clip,
    )
    return {"params": new_params, "opt": new_opt}, {"loss": loss, "lr": lr, **opt_metrics}


def make_train_step(model, tcfg: TrainCfg):
    A = tcfg.microbatches

    def train_step(state, batch):
        if A == 1:
            loss, grads = grads_of(model, state["params"], batch)
        else:
            loss, grads = accumulate(model, state["params"], batch, A)
        return apply_update(tcfg, state, loss, grads)

    return train_step
