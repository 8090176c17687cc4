"""MEB of (ball ∪ L augmented points) — the lookahead "QP" of Algorithm 2.

The port of ``repro/core/qp.py``. The paper solves a size-L quadratic
program whenever the lookahead buffer fills; this solves the equivalent
geometric problem — the smallest ball enclosing the current ball and L
augmented points — with a fixed number of Badoiu–Clarkson / Frank–Wolfe
steps. No TPU kernel computes it, so it is plain PyTorch on any device.

Coordinates. Relative to the current center only three blocks of the
augmented space matter, so a candidate center is carried as ``(u, a, b)``:
  u: (D,)  feature block,
  a: ()    magnitude along the *old* slack block direction sigma/|sigma|,
  b: (L,)  coordinates along the L fresh slack directions of buffered points.
The current ball center is (w, sqrt(xi2), 0); buffered point i is
(P_i, 0, sqrt(1/C) e_i). The solved center folds back to
Ball(u, r_new, a^2 + |b|^2).

Guarantee: after the iterations the radius is *set* to the largest distance
over all entities, so the returned ball always encloses ball ∪ points.
Ties in the farthest point go to the lowest slot (``torch.argmax`` returns
the first maximum, as ``jnp.argmax`` does).
"""
from __future__ import annotations

import torch

from .meb import Ball

_EPS = 1e-12


def _distances(u, a, b, w, sxi, r, pts, valid, c_inv):
    """Distances from candidate center (u, a, b) to each point and to the
    ball: ``(point_dists (L,), far side of the ball (), center dist ())``."""
    # |c - p_i|^2 = |u - P_i|^2 + a^2 + |b|^2 - 2 sqrt(cinv) b_i + cinv
    b2 = (b * b).sum()
    pd2 = ((u[None, :] - pts) ** 2).sum(-1) + a * a + b2 - 2.0 * torch.sqrt(c_inv) * b + c_inv
    pd = torch.sqrt(torch.clamp(pd2, min=0.0))
    pd = torch.where(valid, pd, -torch.inf)
    # |c - c_ball|^2 = |u - w|^2 + (a - sqrt(xi2))^2 + |b|^2
    cd2 = ((u - w) ** 2).sum() + (a - sxi) ** 2 + b2
    cd = torch.sqrt(torch.clamp(cd2, min=0.0))
    return pd, cd + r, cd


def solve_meb_ball_points(ball: Ball, pts, valid, c_inv, *, iters: int = 128) -> Ball:
    """Smallest ball enclosing ``ball`` and the valid rows of ``pts``.

    pts: (L, D) label-signed feature rows (y_i * x_i); valid: (L,) bool —
    rows beyond the current buffer fill are masked out. With no valid row
    the ball comes back unchanged (m included).
    """
    L = pts.shape[0]
    w, r, xi2 = ball.w, ball.r, ball.xi2
    sxi = torch.sqrt(torch.clamp(xi2, min=0.0))
    c_inv = torch.as_tensor(c_inv, dtype=w.dtype, device=w.device)
    nvalid = valid.sum().to(torch.int32)

    # Start at the midpoint between the ball center and the valid-point
    # centroid (in the (u, a, b) blocks).
    denom = torch.clamp(nvalid.to(w.dtype), min=1.0)
    cen_u = torch.where(valid[:, None], pts, 0.0).sum(0) / denom
    cen_b = torch.where(valid, torch.sqrt(c_inv), 0.0) / denom
    u, a, b = 0.5 * (w + cen_u), 0.5 * sxi, 0.5 * cen_b
    onehot = torch.eye(L, dtype=w.dtype, device=w.device)

    for t in range(iters):
        pd, bd, cd = _distances(u, a, b, w, sxi, r, pts, valid, c_inv)
        far_pt = torch.argmax(pd)
        ball_wins = bd >= pd[far_pt]
        # Support (farthest) point of the chosen entity: point i is
        # (P_i, 0, sqrt(cinv) e_i); the ball's is its far side,
        # c_ball + r (c_ball - c) / |c_ball - c|.
        inv_cd = 1.0 / torch.clamp(cd, min=_EPS)
        fu = torch.where(ball_wins, w - r * (u - w) * inv_cd, pts[far_pt])
        fa = torch.where(ball_wins, sxi - r * (a - sxi) * inv_cd, torch.zeros_like(a))
        fb = torch.where(ball_wins, -r * b * inv_cd, torch.sqrt(c_inv) * onehot[far_pt])
        eta = 1.0 / (t + 2.0)
        u, a, b = u + eta * (fu - u), a + eta * (fa - a), b + eta * (fb - b)

    pd, bd, _ = _distances(u, a, b, w, sxi, r, pts, valid, c_inv)
    r_new = torch.maximum(pd.max(), bd)
    any_valid = nvalid > 0
    return Ball(
        w=torch.where(any_valid, u, w),
        r=torch.where(any_valid, r_new, r),
        xi2=torch.where(any_valid, a * a + (b * b).sum(), xi2),
        m=ball.m + nvalid,
    )
