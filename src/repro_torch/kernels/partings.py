"""Where a kernel's run first parts from its plain version's, and whether
that parting is an f32 tie: a decision that the rounding of a sum in f32
can take either way, so that neither run is at fault.

perceptron_parting  P1: the first row whose mistake flags differ
pegasos_parting     P2: the first row whose violation flags differ
stream_parting      B4 (Algorithm 1) and B3 (Algorithm 2, an L-row window
                    flushed farthest-first) for one model, from prefix runs
                    of the entry points (no kernel reports its decisions)

Each evaluates the parting decision in float64 at the state both runs had
reached, and bounds what f32 could make of it: a sum of n terms errs by at
most (n + 2) u times the sum of its absolute terms (u = 2^-24), plus what
the runs' own states differ by. A decision whose float64 margin lies within
that bound is a tie.
"""
from __future__ import annotations

import math

import torch

from .baselines import pegasos_scalars

_U32 = 2.0**-24  # f32 unit roundoff
#: Rows a block of B3's, B4's and P2's walks: a row's <w, y x> takes at most
#: this many corrections (one an update, absorbed point or step) after its
#: dot product.
_BN = 32


def perceptron_parting(X, y, flags_a, flags_b):
    """The first row where two perceptron runs' mistakes (``flags``) part,
    or None. Before it both made the same mistakes, so the exact w there is
    the sum of those signed rows, and its margin is evaluated in float64.
    ``bound`` is the f32 error of that margin: each entry of w a sum of M
    terms and the dot a sum of D, so at most (M + D + 2) u times the sum of
    the absolute terms. Returns ``row``, ``margin``, ``bound`` and ``tie``
    (|margin| <= bound: either decision is an f32 rounding)."""
    diff = (flags_a != flags_b).nonzero().flatten()
    if diff.numel() == 0:
        return None
    j = int(diff[0])
    X64, y64, f = X.double(), y.double(), flags_a[:j].double()
    w = (f * y64[:j]) @ X64[:j]
    margin = float(y64[j] * (w @ X64[j]))
    terms = float((f @ X64[:j].abs()) @ X64[j].abs())
    bound = (int(f.sum()) + X.shape[1] + 2) * _U32 * terms
    return dict(row=j, margin=margin, bound=bound, tie=abs(margin) <= bound)


def pegasos_parting(X, y, lam, k, flags_a, flags_b, states, walk_rows=None):
    """The first row where two Pegasos sweeps' violations (``flags``) part,
    or None. Its step t's w is replayed exactly in float64 (the f32 step
    scalars, the decisions both made before step t), and the row's margin
    evaluated there. ``states`` are the two runs' own f32 w after t steps
    (``states(t)`` returns them); ``bound`` is the larger, over the two, of
    |y (w32 - w64) . x| (the run's drift from the exact state) plus
    (D + 2) u sum |w32 x| (its dot's rounding). Returns ``row``, ``step``,
    ``margin``, ``bound`` and ``tie`` (|margin - 1| <= bound).

    ``walk_rows``: run a is P2's walk in blocks of that many rows (whole
    steps), whose margin at row j is not a dot against its w but
    fl(p_j g_j): g_j = y_j <w_B, x_j> against the run's w at the block's
    start (``states(t_B)[0]``, t_B the block's first step), carried through
    the rounds of the block's earlier steps (at most BN - 1 = 31, one a
    step: g <- scale (c g + a_s sum_V G_rj), four roundings, and the sum of
    up to k Gram entries, each a D-term dot), and p_j, a product of up to
    31 step factors. Every term of that margin is at most one of
    |w_B,i x_j,i| (times p, c and the scales, all at most 1 in magnitude)
    or a_s |x_r,i x_j,i| for an earlier violating row r of the block (a_s =
    eta_s / k, times factors and scales at most 1), so with T the sum of
    those absolute terms the walk's margin errs from its own state's exact
    one by at most (D + 2 + k + 4 BN + BN) u T. The run's w after t steps (a
    prefix run, whose deferred pass replays each step in four f32
    roundings: f w, coef s, their sum, the scale) lies within 4 BN u T of
    that state along x_j. Run a's bound is then |y (w32 - w64) . x| +
    (D + k + 9 BN + 4) u T, where B4's walk counts 3 * 32
    (``stream_parting``). Run b's stays the dot's."""
    diff = (flags_a != flags_b).nonzero().flatten()
    if diff.numel() == 0:
        return None
    j = int(diff[0])
    t = j // k
    factor, coef, radius = pegasos_scalars(lam, k, t + 1)
    X64, y64 = X.double(), y.double()
    w = torch.zeros(X.shape[1], dtype=torch.float64, device=X.device)
    for u in range(t):
        rows = slice(u * k, (u + 1) * k)
        s = (-(flags_a[rows].double() * y64[rows]))[:, None].mul(X64[rows]).sum(0)
        w = float(factor[u]) * w + float(coef[u]) * s
        w = w * min(1.0, float(radius) / max(float(torch.linalg.vector_norm(w)), 1e-12))
    x = X64[j]
    d = X.shape[1]
    margin = float(y64[j] * (w @ x))
    runs = states(t)
    bounds = [float((w32.double() - w).abs() @ x.abs()) + (d + 2) * _U32
              * float(w32.double().abs() @ x.abs()) for w32 in runs]
    if walk_rows is not None:
        r0 = j // walk_rows * walk_rows
        t_b = r0 // k
        w_b = (states(t_b)[0].double() if t_b > 0
               else torch.zeros(d, dtype=torch.float64, device=X.device))
        viol = flags_a[r0:j].double()
        a = torch.as_tensor(-coef.astype("float64"), device=X.device)[
            torch.arange(r0, j, device=X.device) // k]
        terms = float(w_b.abs() @ x.abs()) + float((viol * a) @ (X64[r0:j].abs() @ x.abs()))
        bounds[0] = (float((runs[0].double() - w).abs() @ x.abs())
                     + (d + k + 9 * _BN + 4) * _U32 * terms)
    bound = max(bounds)
    return dict(row=j, step=t, margin=margin, bound=bound, tie=abs(margin - 1.0) <= bound)


def _state(run, nv):
    """``run(nv)``'s (w, r, xi2, m) as float64 CPU w, floats and an int."""
    w, r, xi2, m = run(nv)
    return w.detach().double().cpu().reshape(-1), float(r), float(xi2), int(m)


def stream_parting(run_a, run_b, Z, c_inv, gain, lookahead=None, *, rtol=2e-4, atol=2e-5,
                   pushes_a=None):
    """Where two runs of Algorithm 1 (``lookahead`` None) or Algorithm 2
    (an L-row window, flushed farthest-first when full and after the last
    row) of one model first part, and whether that is an f32 tie; None
    where their final states agree (m equal, w and r within rtol / atol).

    ``run_a(nv)`` and ``run_b(nv)`` return the model's (w, r, xi2, m) after
    the first ``nv`` rows of the stream (row 0 seeds the ball; a partial
    window is flushed after the last row). ``run_a`` should be the cheap
    one: its pushes (Algorithm 1: its updates) are found by bisecting its m
    over prefixes, since m counts the pushes of the rows before, unless the
    caller gives them (``pushes_a``: run a's pushing rows, ascending). Z: the
    (N, D) signed rows y x; ``c_inv`` 1/C and ``gain`` the slack gain, as
    the runs hold them (f32 values).

    Between two flushes the ball does not change, so a parting lies in the
    first segment (after a flush, up to and with the next) at whose end the
    two states part (bisecting over the flushes). From run b's state at
    the segment's start, in float64:

    - each row's push test d >= r, d^2 = |w|^2 - 2 <w, z> + |z|^2 + xi2 +
      1/C: either run's f32 d errs by at most (D + 5 + 3 * 32 + 4 m) u times
      the absolute terms over 2 d (the dot products, up to 32 corrections of
      <w, z> within a block, and B4's |w|^2 carried through the m updates
      before), and run a's also by its state's distance from
      run b's (|dw| + |dxi2| / 2 d + |dr|). Run a must take every decision
      outside that bound as float64 does (else: not a tie); at a row within
      it the runs' counts show which way run b went (one run of b each), and
      run b must take the others as float64 does;
    - with equal pushes, the flush of the window replayed step by step: a
      step whose farthest point is within both points' bounds of another
      remaining point, or within its bound of r, is a tie; each decided
      step widens the bounds by what its s, w, r and xi2 can take from them.

    Returns ``kind`` ("push", "flush" or "state": the states part with
    every decision of the segment decided), ``row``, ``margin`` (d - r, or
    the gap to the rival point), ``bound`` and ``tie``."""
    Z = Z.detach().double().cpu()
    n, d = Z.shape
    ca, cb = {}, {}
    A = lambda nv: ca[nv] if nv in ca else ca.setdefault(nv, _state(run_a, nv))
    B = lambda nv: cb[nv] if nv in cb else cb.setdefault(nv, _state(run_b, nv))

    def agree(nv):
        (wa, ra, _, ma), (wb, rb, _, mb) = A(nv), B(nv)
        return (ma == mb and torch.allclose(wa, wb, rtol=rtol, atol=atol)
                and abs(ra - rb) <= atol + rtol * abs(rb))

    if agree(n):
        return None
    pushes = []

    def find(lo, hi):  # run a's pushing rows in [lo, hi)
        if A(hi)[3] == A(lo)[3]:
            return
        if hi - lo == 1:
            pushes.append(lo)
            return
        mid = (lo + hi) // 2
        find(lo, mid)
        find(mid, hi)

    if pushes_a is None:
        find(1, n)
    else:
        pushes = [int(p) for p in pushes_a]
    L = 1 if lookahead is None else int(lookahead)
    ends = sorted({p + 1 for p in pushes[L - 1::L]} | {n})
    lo, hi = -1, len(ends) - 1  # agree after event lo (-1: the seed), part after event hi
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if agree(ends[mid]):
            lo = mid
        else:
            hi = mid
    start, stop = (1 if lo < 0 else ends[lo]), ends[hi]
    (wa, ra, xa, ma0), (w, r, xi2, mb0) = A(start), B(start)
    dw, dr, dx = float((wa - w).norm()), abs(ra - r), abs(xa - xi2)
    u = _U32

    # The segment's push tests, from run b's state.
    Zs = Z[start:stop]
    dist = torch.sqrt(((w - Zs) ** 2).sum(1) + xi2 + c_inv)
    wn, zn = float(w.norm()), Zs.norm(dim=1)
    terms = wn * wn + 2 * wn * zn + zn * zn + xi2 + c_inv
    own = (d + 5 + 3 * _BN + 4 * mb0) * u * terms / (2 * dist) + u * dist
    bound = own + dw + dx / (2 * dist) + dr
    margin = dist - r
    seg = [p for p in pushes if start <= p < stop]
    a_push = torch.zeros(stop - start, dtype=torch.bool)
    a_push[[p - start for p in seg]] = True
    decided = margin.abs() > bound
    wrong = (decided & ((margin >= 0) != a_push)).nonzero().flatten()
    amb = (~decided).nonzero().flatten().tolist()
    first_wrong = int(wrong[0]) if len(wrong) else stop - start
    for j in amb:
        if j > first_wrong:
            break
        if B(start + j + 1)[3] - mb0 != int(a_push[: j + 1].sum()):
            return dict(kind="push", row=start + j, margin=float(margin[j]),
                        bound=float(bound[j]), tie=True)
    if len(wrong):
        j = first_wrong
        return dict(kind="push", row=start + j, margin=float(margin[j]), bound=float(bound[j]),
                    tie=False)
    if B(stop)[3] - mb0 != len(seg):  # run b parts from a decided test: find where
        lo_, hi_ = start, stop
        while hi_ - lo_ > 1:
            mid = (lo_ + hi_) // 2
            if B(mid)[3] - mb0 == int(a_push[: mid - start].sum()):
                lo_ = mid
            else:
                hi_ = mid
        j = lo_ - start
        return dict(kind="push", row=lo_, margin=float(margin[j]), bound=float(bound[j]),
                    tie=False)
    if lookahead is None or not seg:  # Algorithm 1 absorbs its one pushed row: no choice
        return dict(kind="state", row=stop - 1, margin=float("nan"), bound=float("nan"),
                    tie=False)

    # The flush of the window (the segment's pushes), replayed in float64.
    win = {i: Z[p] for i, p in enumerate(seg)}
    while win:
        bd = {i: math.sqrt(float(((w - p) ** 2).sum()) + xi2 + c_inv) for i, p in win.items()}
        slack = {i: (d + 8) * u * v + dw + dx / (2 * v) for i, v in bd.items()}
        k = max(bd, key=lambda i: (bd[i], -i))  # the first maximum
        for i in bd:  # a rival: another point (an equal one is no choice) as far
            if (i != k and bd[k] - bd[i] <= slack[k] + slack[i]
                    and not torch.equal(win[i], win[k])):
                return dict(kind="flush", row=seg[k], margin=bd[k] - bd[i],
                            bound=slack[k] + slack[i], tie=True)
        if abs(bd[k] - r) <= slack[k] + dr:
            return dict(kind="flush", row=seg[k], margin=bd[k] - r, bound=slack[k] + dr,
                        tie=True)
        if bd[k] < r:
            break  # every remaining point is enclosed: the window is dropped
        p = win.pop(k)
        s = 0.5 * (1.0 - r / bd[k])
        ds = 0.5 * (r * slack[k] / bd[k] ** 2 + dr / bd[k])  # s moves with d and r
        dw = (1 - s) * dw + ds * float((p - w).norm()) + 2 * u * wn
        dr = 0.5 * dr + 0.5 * slack[k] + u * (r + bd[k])
        dx = (1 - s) ** 2 * dx + 2 * ds * (xi2 + gain) + 4 * u * (xi2 + gain)
        w, r = (1 - s) * w + s * p, r + 0.5 * (bd[k] - r)
        xi2 = xi2 * (1 - s) ** 2 + s * s * gain
        wn = float(w.norm())
    return dict(kind="state", row=stop - 1, margin=float("nan"), bound=float("nan"), tie=False)
