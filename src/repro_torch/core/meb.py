"""Ball algebra for the augmented-space MEB that underlies the l2-SVM.

A ``Ball`` is the streaming state of StreamSVM: the center of the minimum
enclosing ball in the augmented feature space ``[y x ; C^{-1/2} e_n]`` is
``[w ; sigma]``. Every example adds a fresh orthogonal slack direction, so
``sigma`` is never stored: its squared norm ``xi2`` is enough for every
distance the algorithm computes (paper, Sec. 4.1).

The functions are branch-free (``torch.where``) and broadcast over leading
axes, so a bank (w: (B, D), scalars (B,)) goes through the same code as a
single ball (w: (D,), scalars ()). This module holds the linear half of the
algebra; the kernel-bank merges wait for their own slice.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

_EPS = 1e-12


class Ball(NamedTuple):
    """Streaming MEB state == StreamSVM classifier state.

    w:   (..., D) feature block of the ball center == SVM weight vector.
    r:   (...) radius.
    xi2: (...) squared norm of the slack block of the center.
    m:   (...) int32 — number of core vectors absorbed (paper's M).
    """

    w: torch.Tensor
    r: torch.Tensor
    xi2: torch.Tensor
    m: torch.Tensor

    @property
    def dim(self) -> int:
        return self.w.shape[-1]


def make_ball(w, r=0.0, xi2=0.0, m=1) -> Ball:
    w = torch.as_tensor(w)
    return Ball(
        w=w,
        r=torch.as_tensor(r, dtype=w.dtype, device=w.device),
        xi2=torch.as_tensor(xi2, dtype=w.dtype, device=w.device),
        m=torch.as_tensor(m, dtype=torch.int32, device=w.device),
    )


def center_distance(b1: Ball, b2: Ball) -> torch.Tensor:
    """Distance between two ball centers built from disjoint example sets:
    ``|c1-c2|^2 = |w1-w2|^2 + xi1^2 + xi2^2`` (orthogonal slack blocks)."""
    d2 = ((b1.w - b2.w) ** 2).sum(-1) + b1.xi2 + b2.xi2
    return torch.sqrt(torch.clamp(d2, min=0.0))


def point_distance(ball: Ball, yx: torch.Tensor, c_inv) -> torch.Tensor:
    """Distance from the center to the augmented point [y x ; C^{-1/2} e_new]
    (Algorithm 1, line 5); ``c_inv`` is 1/C."""
    d2 = ((ball.w - yx) ** 2).sum(-1) + ball.xi2 + c_inv
    return torch.sqrt(torch.clamp(d2, min=_EPS))


def enclose_point(ball: Ball, yx: torch.Tensor, c_inv, *, variant: str = "exact") -> Ball:
    """Algorithm 1 inner update, applied unconditionally.

    ``variant``: "exact" keeps the slack recursion xi2 (1-s)^2 + s^2 / C;
    "paper-listing" is the listing's line 9, xi2 (1-s)^2 + s^2.
    """
    d = point_distance(ball, yx, c_inv)
    s = 0.5 * (1.0 - ball.r / d)
    w = ball.w + s[..., None] * (yx - ball.w)
    r = ball.r + 0.5 * (d - ball.r)
    gain = c_inv if variant == "exact" else 1.0
    xi2 = ball.xi2 * (1.0 - s) ** 2 + (s**2) * gain
    return Ball(w=w, r=r, xi2=xi2, m=ball.m + 1)


def merge_balls(b1: Ball, b2: Ball) -> Ball:
    """Smallest ball enclosing two balls built from disjoint example sets
    (the paper's Sec 4.3 merge). Handles containment and coincident centers
    without branches; broadcasts over a leading bank axis."""
    dist = center_distance(b1, b2)
    safe = torch.clamp(dist, min=_EPS)

    one_in_two = dist + b1.r <= b2.r
    two_in_one = dist + b2.r <= b1.r

    r_join = 0.5 * (b1.r + b2.r + dist)
    t = torch.clamp((r_join - b1.r) / safe, 0.0, 1.0)
    w_join = b1.w + t[..., None] * (b2.w - b1.w)
    xi2_join = (1.0 - t) ** 2 * b1.xi2 + t**2 * b2.xi2

    w = torch.where(
        one_in_two[..., None], b2.w, torch.where(two_in_one[..., None], b1.w, w_join)
    )
    r = torch.where(one_in_two, b2.r, torch.where(two_in_one, b1.r, r_join))
    xi2 = torch.where(one_in_two, b2.xi2, torch.where(two_in_one, b1.xi2, xi2_join))
    return Ball(w=w, r=r, xi2=xi2, m=b1.m + b2.m)


def _require_linear(fn_name: str, banks) -> None:
    """Refuse kernelized banks: their merge algebra is not this one."""
    bad = [type(b).__name__ for b in banks if not isinstance(b, Ball)]
    if bad:
        raise NotImplementedError(
            f"{fn_name} takes linear Ball banks; got {bad}. Kernelized banks "
            "(KernelBank) are not ported yet: ROADMAP A9 (kernel B5)."
        )


def merge_banks(b1: Ball, b2: Ball) -> Ball:
    """Sec-4.3 merge of two banks, model by model (w: (B, D), scalars (B,))."""
    _require_linear("merge_banks", (b1, b2))
    return merge_balls(b1, b2)


def stack_banks(banks) -> Ball:
    """Stack same-shape Ball banks on a NEW leading axis: K banks of (B, D)
    become one Ball with w: (K, B, D)."""
    banks = list(banks)
    if not banks:
        raise ValueError("stack_banks needs at least one bank; got an empty sequence")
    _require_linear("stack_banks", banks)
    return Ball(*(torch.stack(leaves) for leaves in zip(*banks)))


def _take(balls: Ball, i) -> Ball:
    return Ball(*(x[i] for x in balls))


def fold_merge(balls: Ball, live=None) -> Ball:
    """Deterministic left fold of a stacked Ball over its leading axis.

    Accepts stacked single balls (w: (S, D)) or stacked banks (w: (S, B, D)).
    ``live``: optional (S,) bool mask; dead entries are skipped exactly and
    the fold starts at the first live entry (at least one must be live).
    """
    n = balls.w.shape[0]
    if live is None:
        acc = _take(balls, 0)
        for i in range(1, n):
            acc = merge_balls(acc, _take(balls, i))
        return acc
    live = [bool(v) for v in torch.as_tensor(live).reshape(-1).tolist()]
    if len(live) != n or not any(live):
        raise ValueError(
            f"fold_merge needs a (S,) live mask with at least one True entry "
            f"for S={n}: got {live}"
        )
    i0 = live.index(True)
    acc = _take(balls, i0)
    for i in range(i0 + 1, n):
        if live[i]:
            acc = merge_balls(acc, _take(balls, i))
    return acc


def fold_banks(banks, live=None) -> Ball:
    """Sec-4.3 fold of a sequence of same-shape banks, in order (callers pass
    oldest first). A single bank passes through untouched; ``live`` is
    forwarded to ``fold_merge``."""
    banks = list(banks)
    if not banks:
        raise ValueError("fold_banks needs at least one bank; got an empty sequence")
    _require_linear("fold_banks", banks)
    if live is None and len(banks) == 1:
        return banks[0]
    return fold_merge(stack_banks(banks), live=live)


def nonfinite_rows(bank) -> torch.Tensor:
    """(B,) bool: model rows whose FLOAT state holds NaN/Inf (integer leaves
    are skipped). A fold with a poisoned row must never be served."""
    leaves = [x for x in bank if torch.is_tensor(x) and x.is_floating_point()]
    if not leaves:
        raise ValueError(f"nonfinite_rows needs at least one float leaf: got {bank!r}")
    b = leaves[0].shape[0]
    bad = torch.zeros((b,), dtype=torch.bool, device=leaves[0].device)
    for leaf in leaves:
        if leaf.shape[:1] != (b,):
            raise ValueError(
                "nonfinite_rows needs every float leaf stacked on the same "
                f"leading B axis: got shapes {[tuple(l.shape) for l in leaves]}"
            )
        bad = bad | (~torch.isfinite(leaf.reshape(b, -1))).any(dim=1)
    return bad
