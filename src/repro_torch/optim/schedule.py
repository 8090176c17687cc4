"""LR schedules (warmup + cosine), plain functions of the step.

The port of the reference's ``optim/schedule.py``: the same f32 operations
in the same order.
"""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, peak_lr, warmup_steps, total_steps, min_ratio=0.1):
    """Linear warmup to ``peak_lr`` over ``warmup_steps``, then a cosine down
    to ``min_ratio * peak_lr`` at ``total_steps``, computed in f32.

    ``step`` is a Python number or a 0-d tensor; the result is a 0-d f32
    tensor on the step's device for a tensor, a Python float for a number."""
    is_tensor = isinstance(step, torch.Tensor)
    s = step.to(torch.float32) if is_tensor else torch.tensor(step, dtype=torch.float32)
    warm = peak_lr * s / max(warmup_steps, 1)
    frac = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac)))
    lr = torch.where(s < warmup_steps, warm, cos)
    return lr if is_tensor else float(lr)
