"""Training step factory: microbatch gradient accumulation, remat, AdamW.

The port of the reference's ``train/train_loop.py``. ``make_train_step``
returns a ``(state, batch) -> (state, metrics)`` function: the loss's
gradients by ``torch.autograd`` on the params, accumulated in f32 over
``microbatches`` equal splits of the batch (the reference's ``lax.scan``)
and divided by their count, then one AdamW update at the schedule's lr for
the steps taken so far (0 at the first step, as the reference reads it
before the increment). Remat is configured on the model (``build_model(cfg,
remat=...)``). The step writes the params and moments in place and returns
them (the reference's callers donate the state).
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


def make_train_step(model, tcfg: TrainCfg):
    A = tcfg.microbatches

    def grads_of(params, mb):
        """(loss, the grads of the loss in the params' dtypes, as a list in
        ``map_tree``'s order)."""
        leaves = [p.detach().requires_grad_() for p in _tree_leaves(params)]
        with torch.enable_grad():
            loss, _ = model.loss(_rebuild(params, leaves), mb)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, leaves)]
        return loss.detach(), grads

    def train_step(state, batch):
        params = state["params"]
        if A == 1:
            loss, grads = grads_of(params, batch)
        else:
            b = batch["tokens"].shape[0]
            if b % A:
                raise ValueError(f"batch {b} does not split into {A} microbatches")
            s = b // A
            grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for p in _tree_leaves(params)]
            loss = torch.zeros((), dtype=torch.float32, device=grads[0].device)
            for a in range(A):
                l, g = grads_of(params, {k: v[a * s : (a + 1) * s] for k, v in batch.items()})
                for acc, gi in zip(grads, g):
                    acc.add_(gi)
                loss = loss + l
            grads = [g / A for g in grads]
            loss = loss / A

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

    return train_step
