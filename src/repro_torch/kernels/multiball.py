"""M1: one pass of the paper's Sec 4.3 multi-ball recursion over a stream.

The port of ``step`` in ``repro/core/multiball.py::fit_multiball`` (a
``lax.scan`` over the rows there, no Pallas kernel): one model of L ball
slots. The kernel is CUDA C++ for Hopper, in ``csrc/multiball.cu``; its
header says how it is laid out and what bounds it.

``multiball_scan`` dispatches on the device of ``X``: a CPU tensor runs
``multiball_scan_plain``, a CUDA tensor launches the kernel, or raises.
Both advance the state in place over every row of the stream:

  X (N, D) f32 rows, y (N,) f32 signs (the row is the point y x)
  w (L, D) f32 centers, r, xi2 (L,) f32, m (L,) int32, active (L,) bool
  c_inv: 1/C; slack0: the point ball's slack (1/C for "exact", else 1)

Both take the rows a 32-row block at a time: the block's distances to every
slot against the state at its start, then the first row outside every
active ball acts, and only the table entries of the slots it changed are
computed again. Every sum over D is ``sq_dist``'s, every scalar step is
rounded on its own, so the kernel gives the plain version's bits.

``multiball_plan`` picks the launch's layout by bytes, before the launch.
First the grid: one CTA an SM, launched cooperatively, each CTA holding
``rows`` rows of a window of the stream and a replica of the whole state
in shared memory, one grid-wide search for the first row outside every
active ball per update (see csrc). Where the state and one row do not fit
the budget, one CTA walks the stream: the stream staged in shared memory a
block ahead, and the tables (S, the block's row-to-slot distances; P, the
slot-to-slot ones) with the slot scalars, each in shared memory where the
budget allows and else in device memory; its L centers stay in device
memory. Every layout gives the same bits: how the rows are grouped into
blocks, CTAs or windows changes none.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build
from .streamsvm_scan import SMEM_PER_BLOCK, sm_count

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

#: Rows of a block (``BN`` in csrc/multiball.cu) and bytes of the kernel's
#: fixed shared memory (``HEAD``: two mbarriers, the argmin scratch and the
#: block's signs).
BLOCK_ROWS, HEAD_BYTES = 32, 400
#: The layouts ``multiball_plan`` tries, in order: (stream staged, tables)
#: in shared memory. The last takes only the head.
LAYOUTS = ((True, True), (True, False), (False, True), (False, False))
#: Bytes of the grid kernel's fixed shared memory (``GHEAD``: the mbarrier,
#: the argmin scratch and the search's first row a warp).
GRID_HEAD_BYTES = 336


def _lib() -> ctypes.CDLL:
    lib = _build.load("multiball")
    lib.multiball_scan.argtypes = [_P] * 8 + [_I] * 3 + [_F, _F] + [_I] * 3 + [_P]
    lib.multiball_scan.restype = ctypes.c_int
    lib.multiball_dyn_bytes.argtypes = [_I] * 4
    lib.multiball_dyn_bytes.restype = ctypes.c_long
    lib.multiball_scratch_bytes.argtypes = [_I]
    lib.multiball_scratch_bytes.restype = ctypes.c_long
    lib.multiball_grid_scan.argtypes = [_P] * 8 + [_I] * 3 + [_F, _F] + [_I] * 3 + [_P]
    lib.multiball_grid_scan.restype = ctypes.c_int
    lib.multiball_grid_dyn_bytes.argtypes = [_I] * 3
    lib.multiball_grid_dyn_bytes.restype = ctypes.c_long
    lib.multiball_grid_scratch_bytes.argtypes = [_I] * 2
    lib.multiball_grid_scratch_bytes.restype = ctypes.c_long
    lib.multiball_grid_barriers.argtypes = [_P, _I, _I, ctypes.c_long, _P]
    lib.multiball_grid_barriers.restype = ctypes.c_int
    return lib


def pitch(d: int) -> int:
    """Columns of a padded row: D rounded up to 32 (zeros past D)."""
    return -(-int(d) // 32) * 32


def multiball_smem(d: int, n_balls: int, *, x_smem: bool, tables_smem: bool) -> dict:
    """Dynamic shared memory of M1 (its only shared memory), bytes by term,
    as ``multiball_dyn_bytes`` in csrc computes it: the head, two staged
    blocks of 32 padded rows, and the tables (S: 32 x L, P: L x L) with 4
    words of scalars a slot."""
    wp, l = pitch(d), int(n_balls)
    return {
        "head": HEAD_BYTES,
        "stream_blocks": 4 * 2 * BLOCK_ROWS * wp if x_smem else 0,
        "tables": 4 * (BLOCK_ROWS * l + l * l + 4 * l) if tables_smem else 0,
    }


def grid_smem(d: int, n_balls: int, rows: int) -> dict:
    """Dynamic shared memory of the grid layout (its only shared memory) at
    ``rows`` rows a CTA, bytes by term, as ``multiball_grid_dyn_bytes`` in
    csrc computes it: the head, the state replica (L padded centers, the
    acting row, P: L x L, 5 words a slot) and the rows with their S
    entries."""
    wp, l = pitch(d), int(n_balls)
    return {
        "head": GRID_HEAD_BYTES,
        "state": 4 * ((l + 1) * wp + l * l + 5 * l),
        "rows": 4 * int(rows) * (wp + l),
    }


def cta_plan(n_balls: int, d: int, x_smem: bool, tables_smem: bool) -> dict:
    """The one-CTA layout ``(x_smem, tables_smem)`` of ``LAYOUTS`` as a plan.
    ``_launch`` runs it whatever ``multiball_plan`` would pick: tests and
    chip_smoke.py hold every one-CTA layout to the plain version so."""
    return dict(layout="cta", x_smem=x_smem, tables_smem=tables_smem,
                smem=multiball_smem(d, n_balls, x_smem=x_smem, tables_smem=tables_smem))


@functools.lru_cache(maxsize=256)
def multiball_plan(n_balls: int, d: int, *, n: int | None = None, n_ctas: int | None = None,
                   smem_budget: int | None = None) -> dict:
    """M1's launch layout for L slots at D features over ``n`` rows, by
    bytes alone (a shared dict: do not change it), under ``smem_budget``
    (capped at the card's SMEM_PER_BLOCK).

    The grid (``layout`` "grid") where the state and one row fit: ``n_ctas``
    CTAs (default one per SM), each with ``rows`` rows of a window, as many
    as fit, evened out over the ``windows`` windows that ``n`` rows take
    (``n`` None: as many as fit, ``windows`` None). Else the first of
    ``LAYOUTS`` (``layout`` "cta") whose shared memory fits, else the last,
    which takes the head's 400 bytes, so every L and D runs. Returns
    ``layout``, ``x_smem``, ``tables_smem`` and ``smem`` by term, and for the
    grid ``n_ctas``, ``rows`` and ``windows``."""
    limit = SMEM_PER_BLOCK if smem_budget is None else min(int(smem_budget), SMEM_PER_BLOCK)
    per_row = sum(grid_smem(d, n_balls, 1).values()) - sum(grid_smem(d, n_balls, 0).values())
    rows = (limit - sum(grid_smem(d, n_balls, 0).values())) // per_row
    if rows >= 1:
        g = sm_count() if n_ctas is None else int(n_ctas)
        if g < 1:
            raise ValueError(f"n_ctas must be at least 1: got {n_ctas}")
        windows = None
        if n is not None:
            windows = max(1, -(-int(n) // (g * rows)))
            rows = max(1, -(-int(n) // (g * windows)))
        return dict(layout="grid", x_smem=True, tables_smem=True, n_ctas=g, rows=rows,
                    windows=windows, smem=grid_smem(d, n_balls, rows))
    for xs, ts in LAYOUTS:
        plan = cta_plan(n_balls, d, xs, ts)
        if sum(plan["smem"].values()) <= limit or (xs, ts) == LAYOUTS[-1]:
            return plan
    raise AssertionError("unreachable")


def multiball_layouts(n_balls: int, d: int, *, n: int | None = None) -> list[dict]:
    """Every layout ``multiball_plan`` picks for L slots at D (over ``n``
    rows) as the budget falls from the card's limit to 0: the grid where it
    fits, then each one-CTA layout below the grid's bytes for one row. A
    budget of a plan's own bytes (``sum(plan["smem"].values())``) launches
    it: tests and chip_smoke.py force each layout so."""
    out = []
    top = multiball_plan(n_balls, d, n=n)
    if top["layout"] == "grid":
        out.append(top)
    for xs, ts in LAYOUTS:
        budget = sum(multiball_smem(d, n_balls, x_smem=xs, tables_smem=ts).values())
        plan = multiball_plan(n_balls, d, n=n, smem_budget=budget)
        if budget <= SMEM_PER_BLOCK and plan["layout"] == "cta" and plan not in out:
            out.append(plan)
    return out


def sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b|^2 over the last axis, broadcast, in the kernel's order: the
    axis zero-padded to a multiple of 32; chain k (0..7) sums the squares of
    columns 32 u + 4 k + e for u ascending, e = 0..3, one rounding an
    operation; the chains combine as ((p0 + p4) + (p2 + p6)) + ((p1 + p5) +
    (p3 + p7))."""
    diff = a - b
    sq = diff * diff
    sq = F.pad(sq, (0, (-sq.shape[-1]) % 32))
    sq = sq.reshape(*sq.shape[:-1], sq.shape[-1] // 32, 8, 4)
    acc = torch.zeros(sq.shape[:-3] + (8,), dtype=sq.dtype, device=sq.device)
    for u in range(sq.shape[-3]):
        for e in range(4):
            acc = acc + sq[..., u, :, e]
    acc = acc[..., :4] + acc[..., 4:]
    acc = acc[..., :2] + acc[..., 2:]
    return acc[..., 0] + acc[..., 1]


def merge(d2w, r1, x1, r2, x2):
    """``meb.merge_balls`` on the scalars of ball 1 (r1, x1 its slack) and
    ball 2 at squared feature distance ``d2w``, one rounding an operation,
    as the kernel's ``merge``. Returns (r, t, xi2, one_in_two, two_in_one):
    the merged radius and slack, and t, the step from w1 toward w2."""
    dist = torch.sqrt(torch.clamp((d2w + x1) + x2, min=0.0))
    one = (dist + r1) <= r2
    two = (dist + r2) <= r1
    rj = 0.5 * ((r1 + r2) + dist)
    t = torch.clamp((rj - r1) / torch.clamp(dist, min=1e-12), 0.0, 1.0)
    om = 1.0 - t
    xj = (om * om) * x1 + (t * t) * x2
    r = torch.where(one, r2, torch.where(two, r1, rj))
    return r, t, torch.where(one, x2, torch.where(two, x1, xj)), one, two


def merged_center(w1, w2, t, one, two):
    """The merged center: w2 inside, w1 inside, or w1 + t (w2 - w1)."""
    return torch.where(one, w2, torch.where(two, w1, w1 + t * (w2 - w1)))


def absorb(W, r, xi2, m, act, P, s_row, x, slack0) -> list[int]:
    """Apply one row that no active ball encloses to the state (W padded
    centers, r, xi2, m, act, P the slot-pair table; ``s_row`` its (L,)
    distances to the slots, ``x`` its padded signed row), in place: the
    first free slot takes the point ball, else the cheapest of B and C.
    Returns the slots it wrote."""
    n_balls = W.shape[0]
    free = (~act).nonzero()
    if len(free):
        f = int(free[0])
        W[f], r[f], xi2[f], m[f], act[f] = x, 0.0, slack0, 1, True
        return [f]
    zero = torch.zeros_like(slack0)
    rb, tb, xb, oneb, twob = merge(s_row, r, xi2, zero, slack0)
    ib = int(torch.argmin(rb))
    if n_balls > 1:
        ii, jj = torch.triu_indices(n_balls, n_balls, 1, device=W.device)
        rc, tc, xc, onec, twoc = merge(P[ii, jj], r[ii], xi2[ii], r[jj], xi2[jj])
        ic = int(torch.argmin(rc))
        if bool(rc[ic] < rb[ib]):
            a, b = int(ii[ic]), int(jj[ic])
            W[a] = merged_center(W[a], W[b], tc[ic], onec[ic], twoc[ic])
            r[a], xi2[a], m[a] = rc[ic], xc[ic], m[a] + m[b]
            W[b], r[b], xi2[b], m[b] = x, 0.0, slack0, 1
            return [a, b]
    W[ib] = merged_center(W[ib], x, tb[ib], oneb[ib], twob[ib])
    r[ib], xi2[ib], m[ib] = rb[ib], xb[ib], m[ib] + 1
    return [ib]


def _check_args(X, y, w, r, xi2, m, active):
    n, d = X.shape
    n_balls = w.shape[0]
    if y.shape != (n,) or w.shape != (n_balls, d):
        raise ValueError(
            f"y must be (N,) and w (L, D) for X of shape (N, D)={tuple(X.shape)}: got "
            f"y.shape={tuple(y.shape)}, w.shape={tuple(w.shape)}"
        )
    for name, v in (("r", r), ("xi2", xi2), ("m", m), ("active", active)):
        if v.shape != (n_balls,):
            raise ValueError(f"{name} must be ({n_balls},): got {tuple(v.shape)}")
    if n_balls < 1:
        raise ValueError("the state needs at least one slot")


def multiball_scan_plain(X, y, w, r, xi2, m, active, c_inv, slack0, *,
                         smem_budget=None) -> None:
    """Plain PyTorch version of M1, the kernel's blocked algorithm. Arguments
    as in the module docstring; the state is advanced in place.
    ``smem_budget`` is the kernel's and changes nothing here."""
    _check_args(X, y, w, r, xi2, m, active)
    n, d = X.shape
    dev = X.device
    wp = pitch(d)
    W = F.pad(w.float(), (0, wp - d))
    rr, xx, mm, act = r.clone(), xi2.clone(), m.clone(), active.clone()
    ci = torch.as_tensor(c_inv, dtype=torch.float32, device=dev)
    s0 = torch.as_tensor(slack0, dtype=torch.float32, device=dev)
    P = sq_dist(W[:, None], W[None])
    for b0 in range(0, n, BLOCK_ROWS):
        xb = y[b0 : b0 + BLOCK_ROWS, None].float() * F.pad(X[b0 : b0 + BLOCK_ROWS].float(),
                                                           (0, wp - d))
        S = sq_dist(W[None], xb[:, None])  # (rows, L) at the block's start
        j0 = 0
        while j0 < len(xb):
            dist = torch.sqrt(torch.clamp((S[j0:] + xx) + ci, min=1e-12))
            out = (~(act & (dist <= rr)).any(1)).nonzero()
            if len(out) == 0:
                break
            j = j0 + int(out[0])
            ch = torch.tensor(absorb(W, rr, xx, mm, act, P, S[j], xb[j], s0), device=dev)
            P[ch] = sq_dist(W[ch][:, None], W[None])
            P[:, ch] = P[ch].T
            S[:, ch] = sq_dist(W[ch][None], xb[:, None])
            j0 = j + 1
    w.copy_(W[:, :d])
    for dst, src in zip((r, xi2, m, active), (rr, xx, mm, act)):
        dst.copy_(src)


def multiball_scan(X, y, w, r, xi2, m, active, c_inv, slack0, *, smem_budget=None,
                   n_ctas=None) -> None:
    """M1 on the device of ``X``: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor. Arguments as in the module docstring;
    the state is advanced in place. The kernel launches the layout
    ``multiball_plan`` picks under ``smem_budget``; ``n_ctas`` (private, for
    tests) sets the grid's CTAs, one per SM by default. A grid the card
    cannot hold at once is refused at launch and raises."""
    if X.device.type == "cpu":
        return multiball_scan_plain(X, y, w, r, xi2, m, active, c_inv, slack0)
    if X.device.type != "cuda":
        raise ValueError(f"multiball_scan runs on cuda or cpu, not {X.device}")
    _check_args(X, y, w, r, xi2, m, active)
    for t in (X, y, w, r, xi2):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != X.device:
            raise ValueError("M1 takes contiguous float32 X, y, w, r, xi2 on one device")
    if m.dtype != torch.int32 or active.dtype != torch.bool or not m.is_contiguous():
        raise ValueError("M1 takes an int32 m and a bool active")
    n, d = X.shape
    if n == 0:
        return
    _launch(multiball_plan(w.shape[0], d, n=n, n_ctas=n_ctas, smem_budget=smem_budget),
            X, y, w, r, xi2, m, active, c_inv, slack0)
    multiball_scan.launches += 1


def _launch(plan, X, y, w, r, xi2, m, active, c_inv, slack0) -> None:
    """Launch M1 in the layout ``plan`` (checked arguments, n > 0)."""
    n, d = X.shape
    n_balls = w.shape[0]
    dev = X.device
    lib = _lib()
    W = F.pad(w, (0, pitch(d) - d)).contiguous()
    act = active.to(torch.int32)
    vec16 = int(X.data_ptr() % 16 == 0 and d % 4 == 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if plan["layout"] == "grid":
        g = plan["n_ctas"]
        scratch = torch.empty(lib.multiball_grid_scratch_bytes(n_balls, g), device=dev,
                              dtype=torch.uint8)
        err = lib.multiball_grid_scan(
            X.data_ptr(), y.data_ptr(), W.data_ptr(), r.data_ptr(), xi2.data_ptr(),
            m.data_ptr(), act.data_ptr(), scratch.data_ptr(), n, d, n_balls, float(c_inv),
            float(slack0), plan["rows"], g, vec16, stream,
        )
        _build.check(err, f"multiball_scan (grid of {g} CTAs)")
    else:
        scratch = None
        if not plan["tables_smem"]:
            scratch = torch.empty(lib.multiball_scratch_bytes(n_balls), device=dev,
                                  dtype=torch.uint8)
        err = lib.multiball_scan(
            X.data_ptr(), y.data_ptr(), W.data_ptr(), r.data_ptr(), xi2.data_ptr(),
            m.data_ptr(), act.data_ptr(), None if scratch is None else scratch.data_ptr(), n,
            d, n_balls, float(c_inv), float(slack0), int(plan["x_smem"]),
            int(plan["tables_smem"]), vec16, stream,
        )
        _build.check(err, "multiball_scan")
    w.copy_(W[:, :d])
    active.copy_(act.bool())


multiball_scan.launches = 0  # kernel launches, read by chip_smoke.py

