"""Small operations the port needs with the reference's exact semantics."""
from __future__ import annotations

import torch


def top_k(x: torch.Tensor, k: int):
    """The ``k`` largest entries along the last axis and their indices,
    largest first, equal entries in the order of their indices (the lower
    first), as ``jax.lax.top_k`` orders them; ``torch.topk`` orders ties
    as its kernel falls. A stable descending sort, then its first k."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]
