"""Ball algebra for the augmented-space MEB that underlies the l2-SVM.

A ``Ball`` is the streaming state of StreamSVM: the center of the minimum
enclosing ball in the augmented feature space ``[y x ; C^{-1/2} e_n]`` is
``[w ; sigma]``. Every example adds a fresh orthogonal slack direction, so
``sigma`` is never stored: its squared norm ``xi2`` is enough for every
distance the algorithm computes (paper, Sec. 4.1).

The functions are branch-free (``torch.where``) and broadcast over leading
axes, so a bank (w: (B, D), scalars (B,)) goes through the same code as a
single ball (w: (D,), scalars ()). The kernel half (``merge_kernel_banks``,
``stack_kernel_banks``, ``fold_kernel_banks``) merges KernelBanks, whose
centers are coefficient expansions over stored core-set points; the two
halves refuse each other's banks.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
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


def _is_kernel_bank(bank) -> bool:
    """True for KernelBank-shaped banks (core-set buffers present)."""
    return hasattr(bank, "coef") and hasattr(bank, "points")


def _require_kind(fn_name: str, banks, *, want_kernel: bool) -> None:
    """Refuse linear/kernel bank mixing with a ValueError naming both sides:
    a Ball center lives in the feature space, a KernelBank center is an
    expansion over stored points, and their merges are not interchangeable."""
    names = [type(b).__name__ for b in banks]
    bad = [n for b, n in zip(banks, names) if _is_kernel_bank(b) != want_kernel]
    if bad:
        expected = "KernelBank" if want_kernel else "linear Ball"
        other = (
            "linear banks merge via merge_banks/fold_banks/stack_banks"
            if want_kernel
            else "kernelized banks merge via merge_kernel_banks/"
            "fold_kernel_banks/stack_kernel_banks (kernel=..., gamma=...)"
        )
        raise ValueError(
            f"{fn_name} operates on {expected} banks; got {names} — "
            f"mixing linear and kernelized banks has no exact merge; {other}"
        )


def merge_banks(b1: Ball, b2: Ball) -> Ball:
    """Sec-4.3 merge of two banks, model by model (w: (B, D), scalars (B,))."""
    _require_kind("merge_banks", (b1, b2), want_kernel=False)
    return merge_balls(b1, b2)


def stack_banks(banks) -> Ball:
    """Stack same-shape Ball banks on a NEW leading axis: K banks of (B, D)
    become one Ball with w: (K, B, D)."""
    banks = list(banks)
    if not banks:
        raise ValueError("stack_banks needs at least one bank; got an empty sequence")
    _require_kind("stack_banks", banks, want_kernel=False)
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
    _require_kind("fold_banks", banks, want_kernel=False)
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


# ---------------------------------------------------------------------------
# The kernel half: Sec-4.3 merges of KernelBanks (no kernel; batched products)
# ---------------------------------------------------------------------------


def _pair_gram(P1, P2, kernel: str, gamma):
    """(B, S1, S2) kernel matrix between two (B, S, D) core-set buffers."""
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32, as on the TPU
    P1, P2 = P1.float(), P2.float()
    acc = torch.bmm(P1, P2.transpose(1, 2))
    if kernel == "rbf":
        n1 = torch.sum(P1 * P1, dim=-1)
        n2 = torch.sum(P2 * P2, dim=-1)
        return torch.exp(
            -float(gamma) * torch.clamp(n1[:, :, None] + n2[:, None, :] - 2.0 * acc, min=0.0)
        )
    return acc


def merge_kernel_banks(b1, b2, *, kernel: str, gamma=1.0, eviction: str = "smallest-coef",
                       return_dropped: bool = False):
    """Sec-4.3 merge of two same-shape KernelBanks built from disjoint
    example sets, model by model.

    The center distance needs one cross-Gram contraction,
    |c1 - c2|^2 = q1 + q2 - 2 coef1^T K12 coef2 + xi1 + xi2, and then the
    ``merge_balls`` algebra applies: the merged center (1-t) c1 + t c2 lives
    on the concatenated (B, 2S) buffer as [(1-t) coef1 ; t coef2], with
    containment and empty banks (m == 0, an exact identity) collapsed onto
    t in {0, 1}. The 2S slots are cut back to S under the fit's
    ``eviction`` policy (largest |coef|, or farthest from the merged
    center), free slots dropped first, ties to the lowest slot.

    ``return_dropped=True`` also returns the (B,) |coef| mass the cut
    dropped, summed over the slots not kept (exactly 0.0 when only free
    slots were dropped).
    """
    from .kernel_bank import KernelBank  # lazy: kernel_bank -> kernels.ops -> meb

    _require_kind("merge_kernel_banks", (b1, b2), want_kernel=True)
    if b1.coef.shape != b2.coef.shape:
        raise ValueError(
            f"merge_kernel_banks needs identically-shaped banks: got "
            f"coef {tuple(b1.coef.shape)} vs {tuple(b2.coef.shape)}"
        )
    if eviction not in ("smallest-coef", "farthest-point"):
        raise ValueError(
            f"unknown eviction {eviction!r}; expected 'smallest-coef' or 'farthest-point'"
        )
    s_size = b1.coef.shape[1]
    c1, c2 = b1.coef.float(), b2.coef.float()
    k12 = _pair_gram(b1.points, b2.points, kernel, gamma)
    cross = torch.einsum("bs,bst,bt->b", c1, k12, c2)

    d2 = b1.q + b2.q - 2.0 * cross + b1.xi2 + b2.xi2
    dist = torch.sqrt(torch.clamp(d2, min=0.0))
    safe = torch.clamp(dist, min=_EPS)
    one_in_two = dist + b1.r <= b2.r
    two_in_one = dist + b2.r <= b1.r
    empty1, empty2 = b1.m == 0, b2.m == 0

    r_join = 0.5 * (b1.r + b2.r + dist)
    t = torch.clamp((r_join - b1.r) / safe, 0.0, 1.0)
    t = torch.where(one_in_two, 1.0, torch.where(two_in_one, 0.0, t))
    t = torch.where(empty1, 1.0, torch.where(empty2, 0.0, t))
    r = torch.where(one_in_two, b2.r, torch.where(two_in_one, b1.r, r_join))
    r = torch.where(empty1, b2.r, torch.where(empty2, b1.r, r))

    q = (1.0 - t) ** 2 * b1.q + 2.0 * t * (1.0 - t) * cross + t**2 * b2.q
    xi2 = (1.0 - t) ** 2 * b1.xi2 + t**2 * b2.xi2
    m = b1.m + b2.m

    idx_c = torch.cat([b1.idx, b2.idx], dim=1)  # (B, 2S)
    coef_c = torch.cat([(1.0 - t)[:, None] * c1, t[:, None] * c2], dim=1)
    pts_c = torch.cat([b1.points.float(), b2.points.float()], dim=1)

    if eviction == "farthest-point":
        kcc = _pair_gram(pts_c, pts_c, kernel, gamma)
        gs = torch.einsum("bst,bt->bs", kcc, coef_c)
        kdiag = torch.diagonal(kcc, dim1=1, dim2=2)
        score = torch.where(
            idx_c >= 0, q[:, None] - 2.0 * torch.sign(coef_c) * gs + kdiag, -torch.inf
        )  # keep the slots farthest from the merged center
    else:
        score = torch.where(idx_c >= 0, torch.abs(coef_c), -torch.inf)
    keep = torch.sort(score, dim=1, descending=True, stable=True).indices[:, :s_size]
    merged = KernelBank(
        idx=torch.gather(idx_c, 1, keep),
        coef=torch.gather(coef_c, 1, keep),
        points=torch.gather(pts_c, 1, keep[..., None].expand(-1, -1, pts_c.shape[2])),
        q=q, r=r, xi2=xi2, m=m,
    )
    if not return_dropped:
        return merged
    kept = torch.zeros(coef_c.shape, dtype=torch.bool, device=coef_c.device)
    kept.scatter_(1, keep, True)
    dropped = torch.sum(torch.where(kept, 0.0, torch.abs(coef_c)), dim=1)
    return merged, dropped


def stack_kernel_banks(banks):
    """Stack same-shape KernelBanks on a NEW leading axis: K banks of coef
    (B, S) become one KernelBank with coef (K, B, S)."""
    banks = list(banks)
    if not banks:
        raise ValueError("stack_kernel_banks needs at least one bank; got an empty sequence")
    _require_kind("stack_kernel_banks", banks, want_kernel=True)
    return type(banks[0])(*(torch.stack(leaves) for leaves in zip(*banks)))


def fold_kernel_banks(banks, *, kernel: str, gamma=1.0, eviction: str = "smallest-coef",
                      live=None, return_dropped: bool = False):
    """Left fold of same-shape KernelBanks, in order (oldest first), by
    ``merge_kernel_banks``. ``banks`` is a sequence of (B, S) banks or a
    stacked KernelBank (coef (K, B, S)). ``live``: optional (K,) bool mask;
    dead entries never enter a merge (at least one must be live).
    ``return_dropped=True`` also returns the summed (B,) dropped |coef|
    mass over every cut of the fold."""
    if _is_kernel_bank(banks) and getattr(banks.coef, "ndim", 0) == 3:
        banks = [type(banks)(*(x[i] for x in banks)) for i in range(banks.coef.shape[0])]
    else:
        banks = list(banks)
    if not banks:
        raise ValueError("fold_kernel_banks needs at least one bank; got an empty sequence")
    _require_kind("fold_kernel_banks", banks, want_kernel=True)
    if live is not None:
        mask = np.asarray(live.cpu() if torch.is_tensor(live) else live)
        if mask.shape != (len(banks),):
            raise ValueError(
                f"live mask shape {mask.shape} does not match the "
                f"{len(banks)} banks being folded"
            )
        banks = [b for b, alive in zip(banks, mask) if alive]
        if not banks:
            raise ValueError(
                "fold_kernel_banks needs at least one LIVE bank; the live "
                "mask marked every entry dead"
            )
    acc = banks[0]
    dropped = torch.zeros(acc.coef.shape[0], dtype=torch.float32, device=acc.coef.device)
    for nxt in banks[1:]:
        acc, dd = merge_kernel_banks(acc, nxt, kernel=kernel, gamma=gamma, eviction=eviction,
                                     return_dropped=True)
        dropped = dropped + dd
    if return_dropped:
        return acc, dropped
    return acc
