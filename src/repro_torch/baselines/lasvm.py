"""LASVM (Bordes et al. 2005) — online SMO, linear kernel, single pass.

Faithful-in-spirit re-implementation for the unbiased linear C-SVM:
each new example triggers PROCESS (try to add it with one SMO direction
step) followed by one REPROCESS (one SMO step on the max tau-violating pair
among current support vectors), exactly the single-pass regime the paper
benchmarks. Uses y-signed alphas with box A_i = min(0, C y_i),
B_i = max(0, C y_i) and dual gradients g_i = y_i - w.x_i (linear kernel keeps
w = sum_i alpha_i x_i explicit, so every step is O(|S| D)).

float64, sequential — a baseline for accuracy comparison, not a production
path. Every dot product (the gradients, the pair's kernel entries, the
squared norms, |w|) is summed in one fixed pairwise order (``dots``): a
BLAS gemv sums in an order of its own, and the pass is chaotic in those
roundings (an SMO step's lam = (g_i - g_j) / |x_i - x_j|^2 magnifies them),
so on another order the card's pass and the host CPU's drifted 0.4 % apart
in w on synthetic_b before any search picked differently. In the fixed
order every step is one exactly rounded IEEE operation, and the card gives
the host CPU's bits. The rows, w, the alphas and the support set's indices live on the
device, in buffers of N entries made once (the set's size changes every
step, its buffers never); each search for the extreme pair reduces the
set's products with w in place in one preallocated buffer and brings the
step's few decision scalars to the host in one copy. The decisions (the
tau test, the clipped step, pruning) and the pair's three kernel entries
are computed on the host, from a host copy of the alphas that takes the
same float64 steps and a host copy of the rows.

Ties. After an unclipped SMO step the pair's gradients are equal in exact
arithmetic, so the next search often meets two candidates whose float64
gradients differ only by the rounding of their dot products, and the
reference's numpy picks whichever its BLAS rounds higher (numpy's own gemv
rounds a row differently with the rows around it). The port breaks such
ties by stream order: the first candidate of S whose gradient lies within
twice the rounding bound (``search_bound``) of the extreme one, the same on
every device and BLAS. Candidates farther apart are ordered as float64
orders them.
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import as_tensor, pick_device

_TAU = 1e-8
_U64 = 2.0**-53  # float64 unit roundoff


def pow2(n):
    """The least power of two >= n (1 for n <= 1)."""
    return 1 << max(n - 1, 0).bit_length()


def halve(P):
    """The sums over P's last axis (a power of two wide) in one fixed
    pairwise order, in place: the two halves added until one column
    remains, which is returned (a view of P). Each step is an exactly
    rounded elementwise operation, so every device gives the same bits.
    Numpy arrays are taken too."""
    h = P.shape[-1]
    while h > 1:
        h //= 2
        P[..., :h] += P[..., h : 2 * h]
    return P[..., 0]


def dots(A, B):
    """The sums over the last axis of A * B (broadcast) in ``halve``'s
    order, the products padded with zeros to a power-of-two width (numpy
    arrays: of a power-of-two width already)."""
    P = A * B
    n = P.shape[-1]
    if pow2(n) != n:
        P = torch.nn.functional.pad(P, (0, pow2(n) - n))
    return halve(P)


def search_bound(d, xmax, wnorm):
    """The most by which float64 can misplace a gradient y_i - <x_i, w>
    (D terms, |x_i| <= ``xmax``): (D + 2) u (1 + xmax |w|), u = 2^-53,
    since the sum of the dot product's absolute terms is at most |x_i| |w|."""
    return (d + 2) * _U64 * (1.0 + xmax * wnorm)


def first_extreme(V, bound):
    """Per row of V (..., n): the largest entry e, and the index of the first
    entry within 2 ``bound`` of it (the search's tie rule: two gradients
    that close are ordered by rounding, not by their values)."""
    e = V.max(-1).values
    return e, (V >= (e - 2.0 * bound)[..., None]).to(torch.uint8).argmax(-1)


def fit_lasvm(X, y, C: float, return_bias: bool = False, *, device=None):
    """Single pass. Returns (w, n_support) or (w, b, n_support); w a float64
    device tensor, b a float, n_support an int.

    The bias is recovered KKT-style after the pass: b = median over on-margin
    support vectors (0 < |alpha| < C) of (y_i - w.x_i). Real LASVM solves the
    biased SVM; without b, heavily imbalanced non-centered data (w3a) tilts
    toward the minority class.
    """
    dev = pick_device(device, X, y)
    X, y = as_tensor(X, dev, torch.float64), as_tensor(y, dev, torch.float64)
    N, D = X.shape
    C = float(C)
    Dp = pow2(D)
    Xp = torch.nn.functional.pad(X, (0, Dp - D))  # the rows at a power-of-two width
    Xh = Xp.cpu().numpy()  # for the pair's kernel entries on the host

    wp = torch.zeros(Dp, dtype=torch.float64, device=dev)
    w = wp[:D]  # the pass updates w in place; wp's padding stays 0
    # A search's products: row r of S times w, then w times w, summed in
    # place by ``halve``; the padding columns stay 0.
    P = torch.zeros(N + 1, Dp, dtype=torch.float64, device=dev)
    yh = y.cpu().numpy()
    knorm = dots(Xh, Xh)
    xmax = float(np.sqrt(knorm.max())) if N else 0.0
    alpha = np.zeros(N)  # the host's copy, for the decisions
    Bh, Ah = np.maximum(0.0, C * yh), np.minimum(0.0, C * yh)
    # A row's sign, its box's ends moved in by the reference's 1e-12, and
    # its alpha (the device's copy, updated by the same float64 steps).
    T = torch.stack([y, *(torch.as_tensor(a, device=dev) for a in (Ah + 1e-12, Bh - 1e-12)),
                     torch.zeros_like(y)], 1)
    S: list[int] = []  # indices of support candidates
    S_d = torch.zeros(N, dtype=torch.int64, device=dev)  # S in its first len(S) entries

    def extremes(k):
        """Among S (row k its last entry): the row that may go up with the
        largest gradient and the row that may go down with the smallest
        (ties: ``first_extreme``'s rule, within ``search_bound``), with
        their gradients, row k's, and the dot products among them and x_k:
        (ok, i, j, g_i, g_j, g_k, <x_i, x_k>, <x_i, x_j>, <x_j, x_k>)."""
        n = len(S)
        Sv = S_d[:n]
        t = T.index_select(0, Sv)
        torch.index_select(Xp, 0, Sv, out=P[:n])
        P[n, :D] = w
        Q = P[: n + 1]
        Q[:, :D].mul_(w)
        G = halve(Q)  # X w, then |w|^2
        gs = t[:, 0] - G[:-1]  # y - X w
        a = t[:, 3]
        V = torch.where(torch.stack([a < t[:, 2], a > t[:, 1]]), torch.stack([gs, -gs]),
                        -torch.inf)  # row 0: up's gradients, row 1: down's, negated
        e, idx = first_extreme(V, search_bound(D, xmax, torch.sqrt(G[-1])))
        v = torch.cat([e, Sv.index_select(0, idx).double(), gs.index_select(0, idx),
                       gs[-1:]]).tolist()
        i, j = int(v[2]), int(v[3])
        K = dots(Xh[[i, i, j]], Xh[[k, j, k]])
        return (v[0] > -np.inf and v[1] > -np.inf, i, j, *v[4:7], *K.tolist())

    def smo_step(i, j, gi, gj, kij):
        nonlocal w
        denom = max(knorm[i] + knorm[j] - 2.0 * kij, 1e-12)
        lam = (gi - gj) / denom
        Bi = max(0.0, C * yh[i])
        Aj = min(0.0, C * yh[j])
        lam = min(lam, Bi - alpha[i], alpha[j] - Aj)
        if lam <= 0.0:
            return False
        alpha[i] += lam
        alpha[j] -= lam
        T[i, 3] += lam
        T[j, 3] -= lam
        w += lam * (X[i] - X[j])
        return True

    for k in range(N):
        # PROCESS(k)
        S_d[len(S)] = k
        S.append(k)
        found = extremes(k)
        ok, iu, jd, g_iu, g_jd, g_k, k_iu, _, k_jd = found
        stepped = False
        if ok:
            if yh[k] > 0:  # i = k, j = the min-gradient row
                if k != jd and g_k - g_jd > _TAU:
                    stepped = smo_step(k, jd, g_k, g_jd, k_jd)
            elif iu != k and g_iu - g_k > _TAU:  # j = k, i = the max-gradient row
                stepped = smo_step(iu, k, g_iu, g_k, k_iu)
        # REPROCESS: one step on the max violating pair (the same search
        # again unless PROCESS stepped)
        ok, iu, jd, g_iu, g_jd, _, _, k_ij, _ = extremes(k) if stepped else found
        if ok and iu != jd and g_iu - g_jd > _TAU:
            smo_step(iu, jd, g_iu, g_jd, k_ij)
        # prune non-support (alpha == 0) to keep |S| small, LASVM-style
        if len(S) > 64 and k % 32 == 0:
            S = [s for s in S if abs(alpha[s]) > 1e-12 or s == k]
            S_d[: len(S)] = torch.as_tensor(S, dtype=torch.int64, device=dev)

    n_sv = int(np.sum(np.abs(alpha) > 1e-12))
    if not return_bias:
        return w, n_sv
    on_margin = (np.abs(alpha) > 1e-9) & (np.abs(alpha) < C - 1e-9)
    sel = on_margin if on_margin.any() else np.abs(alpha) > 1e-12
    if not sel.any():
        return w, 0.0, n_sv
    idx = torch.as_tensor(np.flatnonzero(sel), device=dev)
    v = torch.sort(y[idx] - dots(Xp[idx], wp)).values
    b = float((v[(len(v) - 1) // 2] + v[len(v) // 2]) / 2)  # numpy's median
    return w, b, n_sv
