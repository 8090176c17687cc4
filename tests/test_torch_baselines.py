"""The port's baselines (``repro_torch.baselines``, kernels P1 and P2) against
the JAX reference's ``repro.baselines``.

The same seeded numpy inputs (the reference tests' ``_sep_data`` draws and
an imbalanced all-positive case) go through both packages; the port runs on
the CPU, through P1's and P2's plain versions. Tolerances:

- perceptron: ``n_updates`` exact, w within rtol 2e-4 / atol 2e-5 (f32 dot
  products summed in another order);
- Pegasos (k = 1, 20, and 7 on N not divisible by k): w within the same;
- batch l2-SVM (800 iterations): w and the objective within rtol 1e-4;
- CVM (float64): ``passes`` and ``core_idx`` exact, w, r and every
  ``w_per_pass`` within rtol 1e-9;
- LASVM (float64): against the reference as it is, ``n_sv`` exact and w
  and b within rtol 1e-9, or a first parting at a search whose two picks'
  gradients (the reference's own values) lie within the float64 rounding
  of their dot products (``search_bound``): after an unclipped SMO step the
  pair's gradients are equal in exact arithmetic, and numpy then picks
  whichever its BLAS rounds higher, while the port takes the first in S
  within twice that bound (``first_extreme``). Then also against the
  reference with its ``np.argmax`` / ``np.argmin`` wrapped with the port's
  tie rule: ``n_sv`` exact, w and b within rtol 1e-9 over the whole pass.

Then the reference tests' own properties, within the port, and the slice as
a whole: Table 1's seven columns on waveform through both packages.
"""
import subprocess
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.baselines as rb
import repro.baselines.lasvm as rlasvm
import repro_torch.baselines as tb
from repro.core import fit as jfit
from repro.core import fit_lookahead as jfit_lookahead
from repro.data import load_dataset as jload_dataset
from repro.data import permuted as jpermuted
from repro.data import preprocess_for as jpreprocess_for
from repro_torch.baselines.lasvm import search_bound
from repro_torch.baselines.pegasos import fit_pegasos_plain
from repro_torch.baselines.perceptron import fit_perceptron_plain
from repro_torch.core import fit, fit_lookahead
from repro_torch.data import DATASETS, load_dataset, permuted, preprocess_for
from repro_torch.data.preprocess import l2_normalize
from repro_torch.kernels import baselines as kb
from repro_torch.kernels import partings
from repro_torch.kernels.streamsvm_scan import single_plan

RTOL_W, ATOL_W = 2e-4, 2e-5
CPU = "cpu"


def _sep_data(n=2000, d=10, margin=1.5, seed=0):
    """The reference tests' draw (tests/test_baselines_data.py)."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=d)
    w /= np.linalg.norm(w)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = np.sign(X @ w).astype(np.float32)
    X += margin * y[:, None] * w[None, :] * 0.5
    return l2_normalize(X), y


def _imbalanced(n=2000, d=20, seed=9):
    """All-positive rows, 5 % positive labels (the reference's bias case)."""
    rng = np.random.default_rng(seed)
    X = np.abs(rng.normal(size=(n, d))).astype(np.float32)
    s = X @ rng.normal(size=d)
    y = np.where(s > np.quantile(s, 0.95), 1.0, -1.0).astype(np.float32)
    return l2_normalize(X), y


CASES = {
    "separable": lambda: _sep_data(),
    "overlapping": lambda: _sep_data(margin=0.0, seed=4),
    "d20": lambda: _sep_data(n=1500, d=20, margin=0.5, seed=5),
    "imbalanced": lambda: _imbalanced(),
}


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


def _acc(w, X, y, b=0.0):
    return float(np.mean(np.sign(X @ np.asarray(w, np.float64) + b) == y)) * 100.0


# ---------------------------------------------------------------------------
# Each baseline against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(CASES))
def test_perceptron_matches_the_reference(case):
    X, y = CASES[case]()
    wr, mr = rb.fit_perceptron(jnp.asarray(X), jnp.asarray(y))
    w, m = tb.fit_perceptron(X, y, device=CPU)
    assert m.dtype == torch.int32 and m.shape == () and w.dtype == torch.float32
    assert int(m) == int(mr)
    _close(w, wr, RTOL_W, ATOL_W)


@pytest.mark.parametrize("k", [1, 20, 7])
@pytest.mark.parametrize("case", sorted(CASES))
def test_pegasos_matches_the_reference(case, k):
    X, y = CASES[case]()
    lam = 1.0 / (10.0 * len(y))  # Table 1's lambda = 1 / (C N) at C = 10
    if case == "separable":
        lam = 1e-4  # the reference test's
    assert k != 7 or len(y) % k != 0  # the trailing partial step is dropped
    wr = rb.fit_pegasos(jnp.asarray(X), jnp.asarray(y), lam, k=k)
    w = tb.fit_pegasos(X, y, lam, k=k, device=CPU)
    assert w.shape == (X.shape[1],) and w.dtype == torch.float32
    _close(w, wr, RTOL_W, ATOL_W)


def _walk_emulation(X, y, lam, k, dtype=np.float64):
    """P2's walk (``single_kernel<WS, PEG>``) in numpy (float64, or float32
    throughout, coarser than the kernel, which carries |w|^2 in double):
    blocks of ``walk_rows(k)`` rows (whole steps), lane t's
    g_t = <w_r, y_t x_t> and p_t (the factors of the steps from the last
    round's to t's), a round at the lowest step with a violation
    (p_t g_t < 1) or whose projection binds, |w|^2 carried by recursion
    within a block and recomputed from w at each block's start, then the
    block's deferred pass: its steps replayed on w in order (factor,
    violations, scale), which in exact arithmetic equals the recorded decay
    and alpha's ``decay w + sum alpha y x`` (checked here, in float64). The
    step scalars are the reference's f32 ones. Returns w, each row's
    violation, its margin p_t g_t as the walk computed it, and the steps
    whose round projected."""
    n = X.shape[0] // k * k
    X, y = X[:n].astype(dtype), y[:n].astype(dtype)
    one = dtype(1)
    rb = kb.walk_rows(k)
    factor, coef, radius = kb.pegasos_scalars(lam, k, n // k)
    f, a, R = factor.astype(dtype), -coef.astype(dtype), dtype(radius)
    w = np.zeros(X.shape[1], dtype)
    flags, margins = np.zeros(n, bool), np.zeros(n, dtype)
    projected = []
    for r0 in range(0, n, rb):
        Z = y[r0:r0 + rb, None] * X[r0:r0 + rb]
        idx = np.arange(Z.shape[0])
        step, first = (r0 + idx) // k, idx // k * k
        lead = idx == first
        G, g, wsq = Z @ Z.T, Z @ w, w @ w
        alpha, decay, j0 = np.zeros(len(idx), dtype), one, 0
        scales = np.ones(len(idx), dtype)
        while True:
            Q = np.cumprod(np.where(lead & (idx >= j0), f[step], one))
            p = np.where(first > 0, Q[np.maximum(first - 1, 0)], one)
            viol = (idx >= j0) & (p * g < 1)
            margins[r0 + idx[idx >= j0]] = (p * g)[idx >= j0]
            c = f[step] * p
            bind = (idx >= j0) & lead & (R / np.maximum(np.sqrt(c * c * wsq), dtype(1e-12)) < 1)
            hit = viol | bind
            if not hit.any():
                break
            s0 = int(np.argmax(hit)) // k * k
            V = viol & (idx >= s0) & (idx < s0 + k)
            cs, ak = c[s0], a[step[s0]]
            u = G[V].sum(0)
            wsq = cs * cs * wsq + 2 * cs * ak * g[V].sum() + ak * ak * u[V].sum()
            scale = min(one, R / max(np.sqrt(wsq), dtype(1e-12)))
            g = scale * (cs * g + ak * u)
            alpha = scale * (cs * alpha + ak * V)
            decay = scale * cs * decay
            wsq = scale * scale * wsq
            scales[s0:s0 + k] = scale
            flags[r0 + idx[V]] = True
            if scale < 1:
                projected.append(int(step[s0]))
            j0 = s0 + k
        deferred = Q[-1] * (decay * w + alpha @ Z)  # the block's last steps' factors
        nv = np.where(flags[r0 + idx], -y[r0 + idx], dtype(0))  # -(viol y), as the plain's
        for s0 in range(0, len(idx), k):  # the deferred pass: the block's steps in order
            rows = slice(s0, s0 + k)
            s = (nv[rows, None] * X[r0 + s0:r0 + s0 + k]).sum(0)
            w = (f[step[s0]] * w - a[step[s0]] * s) * scales[s0]
        if dtype == np.float64:
            np.testing.assert_allclose(w, deferred, rtol=1e-12, atol=1e-12 * np.abs(w).max())
    return w, flags, margins, projected


WALK_CASES = {"d2": (2048, 2), "d23": (1600, 23), "ragged": (1001, 23)}  # 1001: not 32k rows


@pytest.mark.parametrize("lam", ["table1", "large"])
@pytest.mark.parametrize("k", [1, 3, 20])
@pytest.mark.parametrize("case", sorted(WALK_CASES))
def test_pegasos_walk_algebra_matches_the_reference(case, k, lam):
    """The walk's algebra (P2's kernel at k <= 32) against the reference:
    the same violations row for row as the reference's step loop (the plain
    version's flags; its w is the reference's), w within rtol 1e-5 of the
    reference's f32 w (atol 1e-5 max|w|: the f32 sweep's own rounding), and
    within 1e-12 of the float64 replay of the reference's steps on those
    decisions. Table 1's lambda (1 / (10 N)) projects at step 0 and on most
    later violations; 5e-4 projects at step 0 and again in later blocks,
    then no more."""
    n, d = WALK_CASES[case]
    rng = np.random.default_rng(n + d)
    X = l2_normalize(rng.normal(size=(n, d)).astype(np.float32))
    y = np.sign(X @ rng.normal(size=d) + 0.3 * rng.normal(size=n)).astype(np.float32)
    lam = {"table1": 1.0 / (10.0 * n), "large": 5e-4}[lam]
    nk = n // k * k
    wr = np.asarray(rb.fit_pegasos(jnp.asarray(X), jnp.asarray(y), lam, k=k), np.float64)
    fp = torch.zeros(nk, dtype=torch.uint8)
    wp = kb.pegasos_scan_plain(torch.as_tensor(X[:nk]), torch.as_tensor(y[:nk]), lam, k, flags=fp)
    _close(wp, wr, RTOL_W, ATOL_W)
    w, flags, _, projected = _walk_emulation(X, y, lam, k)
    fp = fp.numpy().astype(bool)
    assert np.array_equal(flags, fp), np.flatnonzero(flags != fp)[:5]
    _close(w, wr, 1e-5, 1e-5 * np.abs(wr).max())
    factor, coef, radius = kb.pegasos_scalars(lam, k, nk // k)
    w64 = np.zeros(d)
    for t in range(nk // k):
        s = (fp[t * k:(t + 1) * k] * y[t * k:(t + 1) * k])[:, None] * X[t * k:(t + 1) * k]
        w64 = float(factor[t]) * w64 - float(coef[t]) * s.astype(np.float64).sum(0)
        w64 *= min(1.0, float(radius) / max(np.linalg.norm(w64), 1e-12))
    _close(w, w64, 1e-12, 1e-12 * np.abs(w64).max())
    assert projected[0] == 0 and max(projected) * k >= kb.walk_rows(k)


@pytest.mark.parametrize("case", ["overlapping", "imbalanced"])
def test_batch_l2svm_matches_the_reference(case):
    X, y = CASES[case]()
    wr, objr = rb.fit_batch_l2svm(jnp.asarray(X), jnp.asarray(y), 10.0, iters=800)
    w, obj = tb.fit_batch_l2svm(X, y, 10.0, iters=800, device=CPU)
    assert obj.shape == () and w.dtype == obj.dtype == torch.float32
    _close(w, wr, 1e-4, 1e-4 * float(np.abs(np.asarray(wr)).max()))
    _close(obj, objr, 1e-4)


@pytest.mark.parametrize("C,n,seed", [(10.0, 1500, 2), (1.0, 800, 6)])
def test_cvm_matches_the_reference(C, n, seed):
    X, y = _sep_data(n=n, seed=seed, margin=0.8)
    ref = rb.fit_cvm(X, y, C=C, eps=1e-3, max_passes=12, solver_iters=500)
    got = tb.fit_cvm(X, y, C=C, eps=1e-3, max_passes=12, solver_iters=500, device=CPU)
    assert set(got) == set(ref)
    assert got["passes"] == ref["passes"] >= 2
    np.testing.assert_array_equal(got["core_idx"].numpy(), ref["core_idx"])
    assert got["w"].dtype == torch.float64
    _close(got["w"], ref["w"], 1e-9)
    _close(got["r"], ref["r"], 1e-9)
    assert len(got["w_per_pass"]) == len(ref["w_per_pass"])
    for a, b in zip(got["w_per_pass"], ref["w_per_pass"]):
        _close(a, b, 1e-9)


def _numpy_shim(argmax, argmin):
    """numpy with ``argmax`` / ``argmin`` replaced, for the reference's module."""
    shim = types.SimpleNamespace(**{k: getattr(np, k) for k in dir(np) if not k.startswith("__")})
    shim.argmax, shim.argmin = argmax, argmin
    return shim


def _search_state():
    """Called by a shimmed argmax / argmin (through its lambda): the locals
    of the reference's search that called it, and the row it processes."""
    f, k = sys._getframe(3).f_locals, sys._getframe(4).f_locals["k"]
    return f, k


@pytest.fixture
def reference_ties(monkeypatch):
    """The reference's LASVM with its argmax / argmin breaking float64 ties
    as the port does (``first_extreme`` within ``search_bound``, from the
    reference's own rows and w); nothing else changes."""
    def first(v, largest):
        f, _ = _search_state()
        X, w = f["X"], f["w"]
        bound = search_bound(X.shape[1], float(np.sqrt((X * X).sum(1).max())),
                             float(np.linalg.norm(w)))
        e = v.max() if largest else v.min()
        return int(np.flatnonzero(v >= e - 2 * bound if largest else v <= e + 2 * bound)[0])

    monkeypatch.setattr(rlasvm, "np", _numpy_shim(lambda v: first(np.asarray(v), True),
                                                  lambda v: first(np.asarray(v), False)))


def _lasvm_searches(monkeypatch, X, y, C, n):
    """Both packages' LASVM over X[:n], y[:n], each search recorded per row
    k as {side: (candidate rows, their gradients, the pick, w)}: the
    reference's through recording argmax / argmin (its picks unchanged),
    the port's through a recording ``first_extreme``. Returns
    ``(ref, port)``: for each, row k's list of searches."""
    ref, port = {}, {}

    def rec(v, largest):
        f, k = _search_state()
        rows = f["up" if largest else "dn"]
        i = int(np.argmax(v) if largest else np.argmin(v))
        side = "up" if largest else "dn"
        if largest:
            ref.setdefault(k, []).append({})
        ref[k][-1][side] = (rows, np.asarray(v, np.float64), int(rows[i]), f["w"].copy())
        return i

    real = tb.lasvm.first_extreme

    def rec_port(V, bound):
        e, idx = real(V, bound)
        f = sys._getframe(1).f_locals
        Sv, search = f["Sv"].numpy(), {}
        for row, side, sign in ((0, "up", 1.0), (1, "dn", -1.0)):
            if float(e[row]) > -np.inf:
                ok = np.isfinite(V[row].numpy())
                search[side] = (Sv[ok], sign * V[row].numpy()[ok], int(Sv[int(idx[row])]),
                                f["w"].numpy().copy())
        port.setdefault(f["k"], []).append(search)
        return e, idx

    with monkeypatch.context() as m:
        m.setattr(rlasvm, "np", _numpy_shim(lambda v: rec(v, True), lambda v: rec(v, False)))
        rb.fit_lasvm(X[:n], y[:n], C=C)
    with monkeypatch.context() as m:
        m.setattr(tb.lasvm, "first_extreme", rec_port)
        tb.fit_lasvm(X[:n], y[:n], C=C, device=CPU)
    return ref, port


def _lasvm_parting(monkeypatch, X, y, C):
    """Where the port's LASVM first parts from the reference's (bisecting the
    rows: a prefix agrees where n_sv is equal and w within rtol 1e-9), and
    whether it parts at a search whose two picks are a float64 rounding tie:
    the reference's own gradients of its pick a and the port's pick b differ
    by at most 4 ``search_bound`` (each run misplaces each gradient by at
    most one bound, and the port ties within two) plus what the runs' w
    make of the two rows, |<x_a - x_b, w_ref - w_port>|. Only the side a
    step uses is compared (PROCESS uses the row that pairs with k). None
    where the whole pass agrees."""
    X64 = X.astype(np.float64)

    def agree(n):
        (wr, sr), (wp, sp) = rb.fit_lasvm(X[:n], y[:n], C=C), tb.fit_lasvm(X[:n], y[:n], C=C,
                                                                         device=CPU)
        return sr == sp and np.allclose(wp.numpy(), wr, rtol=1e-9, atol=1e-12)

    n = len(y)
    if agree(n):
        return None
    lo, hi = 0, n
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if agree(mid) else (lo, mid)
    k = lo
    ref, port = _lasvm_searches(monkeypatch, X, y, C, k + 1)
    r_s, p_s = ref.get(k, []), port.get(k, [])
    if len(r_s) != 2 or not 1 <= len(p_s) <= 2:
        return dict(row=k, tie=False, why=f"searches: reference {len(r_s)}, port {len(p_s)}")
    uses = (["dn"] if y[k] > 0 else ["up"], ["up", "dn"])  # PROCESS, REPROCESS
    for phase, (r, p) in enumerate(zip(r_s, (p_s[0], p_s[-1]))):
        for side in uses[phase]:
            rows, v, a, w_ref = r[side]
            b, w_port = p[side][2], p[side][3]
            if a == b:
                continue
            if b not in rows:
                return dict(row=k, tie=False, why=f"the port's pick {b} is no candidate")
            va, vb = v[list(rows).index(a)], v[list(rows).index(b)]
            bound = (4 * search_bound(X.shape[1], float(np.sqrt((X64 * X64).sum(1).max())),
                                      float(np.linalg.norm(w_ref)))
                     + abs(float((X64[a] - X64[b]) @ (w_ref - w_port))))
            return dict(row=k, phase=("PROCESS", "REPROCESS")[phase], side=side, picks=(a, b),
                        gap=abs(va - vb), bound=bound, tie=abs(va - vb) <= bound)
    return dict(row=k, tie=False, why="every pick agrees: a step parts")


@pytest.mark.parametrize("case,C", [("separable", 10.0), ("d20", 1.0), ("imbalanced", 1.0),
                                    ("overlapping", 100.0)])
def test_lasvm_against_the_unpatched_reference(monkeypatch, case, C):
    X, y = CASES[case]()
    X, y = X[:800], y[:800]
    part = _lasvm_parting(monkeypatch, X, y, C)
    assert part is None or part["tie"], part


@pytest.mark.parametrize("return_bias", [False, True])
@pytest.mark.parametrize("case,C", [("separable", 10.0), ("d20", 1.0), ("imbalanced", 1.0),
                                    ("overlapping", 100.0)])
def test_lasvm_matches_the_reference(reference_ties, case, C, return_bias):
    X, y = CASES[case]()
    X, y = X[:800], y[:800]
    ref = rb.fit_lasvm(X, y, C=C, return_bias=return_bias)
    got = tb.fit_lasvm(X, y, C=C, return_bias=return_bias, device=CPU)
    assert len(got) == len(ref) == (3 if return_bias else 2)
    assert got[-1] == ref[-1]  # n_sv
    assert got[0].dtype == torch.float64
    _close(got[0], ref[0], 1e-9, 1e-12)
    if return_bias:
        _close(got[1], ref[1], 1e-9)


def test_lasvm_tie_rule():
    g = torch.tensor([0.5, 0.5 + 1e-12, -3.0, 0.5 - 1e-6, 0.4], dtype=torch.float64)
    bound = search_bound(20, 1.0, 1.0)  # 22 u (1 + 1): 4.9e-15
    e, idx = tb.lasvm.first_extreme(torch.stack([g, -g]), bound)
    assert idx.tolist() == [1, 2] and e.tolist() == [0.5 + 1e-12, 3.0]  # 1e-12: no tie here
    g[1] = 0.5 + 2e-15  # within 2 bounds: a tie, the first in S wins
    assert int(tb.lasvm.first_extreme(g, bound)[1]) == 0
    g[1] = 0.5 + 1e-14  # beyond
    assert int(tb.lasvm.first_extreme(g, bound)[1]) == 1


# ---------------------------------------------------------------------------
# The kernels' plain versions, their plans and their decisions
# ---------------------------------------------------------------------------


def test_plain_flags_record_each_rows_decision():
    X, y = _sep_data(n=300, margin=0.0, seed=1)
    Xt, yt = torch.as_tensor(X), torch.as_tensor(y)
    flags = torch.zeros(300, dtype=torch.uint8)
    w, m = kb.perceptron_scan(Xt, yt, flags=flags)
    assert int(flags.sum()) == int(m) and flags[0] == 1  # w = 0: the first row is a mistake
    w64 = (torch.as_tensor(X, dtype=torch.float64) * (flags * yt)[:, None].double()).sum(0)
    _close(w, w64, 1e-5, 1e-6)  # w is the sum of the mistaken signed rows
    for k in (1, 6):
        n = 300 // k * k
        vflags = torch.zeros(n, dtype=torch.uint8)
        kb.pegasos_scan(Xt[:n], yt[:n], 1e-3, k, flags=vflags)
        assert 0 < int(vflags.sum()) < n
    with pytest.raises(ValueError):
        kb.perceptron_scan(Xt, yt, flags=torch.zeros(299, dtype=torch.uint8))
    with pytest.raises(ValueError):
        kb.pegasos_scan(Xt[:299], yt[:299], 1e-3, 6)  # 299 rows are not whole steps


def test_pegasos_scalars_are_the_references_f32_steps():
    lam = np.float32(1.0 / (10.0 * 4000))
    factor, coef, radius = kb.pegasos_scalars(lam, 20, 200)
    t = jnp.arange(200, dtype=jnp.float32)
    eta = 1.0 / (jnp.asarray(lam) * (t + 1.0))
    np.testing.assert_array_equal(factor, np.asarray(1.0 - eta * jnp.asarray(lam)))
    np.testing.assert_array_equal(coef, np.asarray(-eta / 20))
    assert radius == np.float32(1.0 / jnp.sqrt(jnp.asarray(lam)))
    assert factor.dtype == coef.dtype == np.float32


@pytest.mark.parametrize("d,k", [(2, 1), (784, 1), (784, 20), (300, 20), (21, 7), (4096, 20),
                                 (20_000, 1)])
def test_pegasos_plan_fits_the_budget(d, k):
    plan = kb.pegasos_plan(d, k)
    total = sum(plan["smem"].values())
    assert total <= kb.SMEM_PER_BLOCK
    staged = sum(kb.pegasos_smem(d, k, True).values())
    size = lambda p: sum(p["smem"].values())
    if k <= kb.PEGASOS_WALK_MAX_K:
        # The walk in B4's layout for D, with the warps' |w|^2 sums beside.
        b4 = single_plan(d)
        assert plan["layout"] == "walk" and plan["rows"] == 32 // k * k
        assert (plan["chunk"], plan["w_in_smem"]) == (b4["chunk"], b4["w_in_smem"])
        assert total == sum(b4["smem"].values()) + 8 * kb.PEGASOS_WARPS + 12 * 32
    else:
        # Staged (a ring of two steps) wherever it fits, else in place.
        assert plan["staged"] == (plan["layout"] == "staged") == (staged <= kb.SMEM_PER_BLOCK)
        assert plan["smem"]["stream_ring"] == (kb.PEGASOS_RING * k * d * 4 if plan["staged"]
                                               else 0)
    # Every Table 1 width stages at both of the paper's k.
    if d <= 784:
        assert staged <= kb.SMEM_PER_BLOCK
    # Every layout: the walk's three (B4's) where k <= 32, then the step form,
    # each where it fits. A budget of a layout's own bytes takes the first
    # layout the plan may take that fits it, so the staged layout's bytes
    # keep it where no walk is planned below them, and a word less goes on.
    layouts = kb.pegasos_layouts(d, k)
    assert [p["layout"] for p in layouts if p["layout"] != "walk"] == (
        ["staged"] * (staged <= kb.SMEM_PER_BLOCK) + ["in place"])
    assert all(p["rows"] == 32 // k * k for p in layouts if p["layout"] == "walk")
    walks = [(-(-d // 4) * 4, True), (kb.SINGLE_DC, True), (kb.SINGLE_DC, False)]
    assert [(p["chunk"], p["w_in_smem"]) for p in layouts if p["layout"] == "walk"] == [
        (c, ws) for c, ws in walks
        if sum(kb.walk_smem(d, chunk=c, w_in_smem=ws).values()) <= kb.SMEM_PER_BLOCK]
    takes = [p for p in layouts if p["layout"] != "walk" or k <= kb.PEGASOS_WALK_MAX_K]
    assert plan == takes[0]
    for budget in [size(p) for p in layouts] + [staged - 4]:
        want = next(p for p in takes if size(p) <= budget)
        assert kb.pegasos_plan(d, k, smem_budget=budget) == want
    if k > kb.PEGASOS_WALK_MAX_K:
        if staged <= kb.SMEM_PER_BLOCK:
            assert kb.pegasos_plan(d, k, smem_budget=staged)["staged"]
        assert kb.pegasos_plan(d, k, smem_budget=staged - 4)["layout"] == "in place"


def test_pegasos_plan_refuses_a_step_beyond_shared_memory():
    with pytest.raises(ValueError):
        kb.pegasos_plan(8, 60_000)


def test_entry_points_raise_without_a_card_unless_asked_for_the_cpu():
    X, y = _sep_data(n=64)
    calls = (
        lambda **kw: tb.fit_perceptron(X, y, **kw),
        lambda **kw: tb.fit_pegasos(X, y, 1e-3, k=2, **kw),
        lambda **kw: tb.fit_batch_l2svm(X, y, 1.0, iters=3, **kw),
        lambda **kw: tb.fit_cvm(X, y, 1.0, max_passes=2, solver_iters=3, **kw),
        lambda **kw: tb.fit_lasvm(X[:10], y[:10], 1.0, **kw),
    )
    for call in calls:
        call(device="cpu")
        if not torch.cuda.is_available():
            with pytest.raises((RuntimeError, AssertionError)):
                call()
    # CPU tensors stay on the CPU without device=
    w, m = tb.fit_perceptron(torch.as_tensor(X), torch.as_tensor(y))
    assert w.device.type == "cpu"


def test_plain_entry_points_equal_the_dispatching_ones_on_the_cpu():
    X, y = _sep_data(n=500, margin=0.2, seed=8)
    for a, b in zip(fit_perceptron_plain(X, y, device=CPU), tb.fit_perceptron(X, y, device=CPU)):
        assert torch.equal(a, b)
    assert torch.equal(fit_pegasos_plain(X, y, 1e-3, 20, device=CPU),
                       tb.fit_pegasos(X, y, 1e-3, 20, device=CPU))


def test_importing_the_baselines_loads_no_jax():
    code = ("import sys; import repro_torch.baselines, repro_torch.kernels.baselines; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'repro.'))]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


# ---------------------------------------------------------------------------
# The reference tests' properties (tests/test_baselines_data.py), in the port
# ---------------------------------------------------------------------------


def test_perceptron_separable():
    X, y = _sep_data()
    w, m = tb.fit_perceptron(X, y, device=CPU)
    assert _acc(w.numpy(), X, y) > 97.0


def test_pegasos_reasonable():
    X, y = _sep_data()
    w = tb.fit_pegasos(X, y, lam=1e-4, k=20, device=CPU)
    assert _acc(w.numpy(), X, y) > 95.0


def test_batch_l2svm_is_strongest():
    X, y = _sep_data(margin=0.8, seed=1)
    wb, obj = tb.fit_batch_l2svm(X, y, 10.0, iters=800, device=CPU)
    wp, _ = tb.fit_perceptron(X, y, device=CPU)
    assert _acc(wb.numpy(), X, y) >= _acc(wp.numpy(), X, y) - 1.0
    assert np.isfinite(float(obj))


def test_cvm_multipass_converges():
    X, y = _sep_data(n=1500, seed=2)
    res = tb.fit_cvm(X, y, C=10.0, eps=1e-3, max_passes=12, solver_iters=500, device=CPU)
    assert _acc(res["w"].numpy(), X, y) > 95.0
    assert res["passes"] >= 2  # CVM cannot return in a single pass


def test_lasvm_small():
    X, y = _sep_data(n=800, seed=3)
    w, nsv = tb.fit_lasvm(X, y, C=10.0, device=CPU)
    assert _acc(w.numpy(), X, y) > 95.0
    assert 0 < nsv < 800


def test_lasvm_bias_on_imbalanced():
    X, y = _imbalanced()
    w, b, _ = tb.fit_lasvm(X, y, C=1.0, return_bias=True, device=CPU)
    assert _acc(w.numpy(), X, y, b) > 90.0


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_dataset_spec(name):
    Xtr, ytr, Xte, yte = load_dataset(name, seed=0)
    spec = {
        "synthetic_a": (20000, 200, 2), "synthetic_b": (20000, 200, 3),
        "synthetic_c": (20000, 200, 5), "waveform": (4000, 1000, 21),
        "mnist01": (12665, 2115, 784), "mnist89": (11800, 1983, 784),
        "ijcnn": (35000, 91701, 22), "w3a": (44837, 4912, 300),
    }[name]
    assert Xtr.shape == (spec[0], spec[2])
    assert Xte.shape == (spec[1], spec[2])
    assert set(np.unique(ytr)) <= {-1.0, 1.0}
    np.testing.assert_array_equal(Xtr, load_dataset(name, seed=0)[0])  # determinism


def test_preprocess_unit_norm():
    Xtr, _, Xte, _ = load_dataset("waveform")
    a, b = preprocess_for("waveform", Xtr, Xte)
    np.testing.assert_allclose(np.linalg.norm(a, axis=1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(b, axis=1), 1.0, rtol=1e-5)


# ---------------------------------------------------------------------------
# The slice as a whole: Table 1's row for waveform through both packages
# ---------------------------------------------------------------------------


def test_table1_row_on_waveform_matches_the_reference(reference_ties):
    """Table 1's protocol (benchmarks/table1.py) on waveform's first 500 rows
    of one stream order: the seven columns' held-out accuracies through both
    packages, each within 0.1 points (1 of the 1,000 test rows)."""
    n, C = 500, 10.0
    ref = jload_dataset("waveform", seed=0)
    port = load_dataset("waveform", seed=0)
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a, b)
    Xtr, Xte = preprocess_for("waveform", port[0], port[2])
    jXtr, jXte = jpreprocess_for("waveform", ref[0], ref[2])
    np.testing.assert_array_equal(Xtr, jXtr)
    yte = port[3]
    Xp, yp = permuted(Xtr, port[1], seed=0)
    jXp, jyp = jpermuted(jXtr, ref[1], seed=0)
    np.testing.assert_array_equal(Xp, jXp)
    Xp, yp = Xp[:n], yp[:n]
    Xj, yj = jnp.asarray(Xp), jnp.asarray(yp)
    lam = 1.0 / (C * n)

    wl, bl, _ = tb.fit_lasvm(Xp, yp, C=1.0, return_bias=True, device=CPU)
    jwl, jbl, _ = rb.fit_lasvm(Xp, yp, C=1.0, return_bias=True)
    port_acc = {
        "batch": _acc(tb.fit_batch_l2svm(Xp, yp, C, iters=800, device=CPU)[0].numpy(), Xte, yte),
        "perceptron": _acc(tb.fit_perceptron(Xp, yp, device=CPU)[0].numpy(), Xte, yte),
        "pegasos1": _acc(tb.fit_pegasos(Xp, yp, lam, k=1, device=CPU).numpy(), Xte, yte),
        "pegasos20": _acc(tb.fit_pegasos(Xp, yp, lam, k=20, device=CPU).numpy(), Xte, yte),
        "lasvm": _acc(wl.numpy(), Xte, yte, bl),
        "algo1": _acc(fit(Xp, yp, C, device=CPU).w.numpy(), Xte, yte),
        "algo2": _acc(fit_lookahead(Xp, yp, C, 10, device=CPU).w.numpy(), Xte, yte),
    }
    ref_acc = {
        "batch": _acc(rb.fit_batch_l2svm(Xj, yj, C, iters=800)[0], Xte, yte),
        "perceptron": _acc(rb.fit_perceptron(Xj, yj)[0], Xte, yte),
        "pegasos1": _acc(rb.fit_pegasos(Xj, yj, lam, k=1), Xte, yte),
        "pegasos20": _acc(rb.fit_pegasos(Xj, yj, lam, k=20), Xte, yte),
        "lasvm": _acc(jwl, Xte, yte, jbl),
        "algo1": _acc(jfit(Xj, yj, C).w, Xte, yte),
        "algo2": _acc(jfit_lookahead(Xj, yj, C, 10).w, Xte, yte),
    }
    for col, a in port_acc.items():
        assert abs(a - ref_acc[col]) <= 0.1 + 1e-9, (col, a, ref_acc[col])
        assert a > 50.0, (col, a)  # each column learns something


def test_parting_helpers_find_the_first_parting_row():
    """A decision flipped at one row is found there and, far from the
    threshold, is not certified as a tie."""
    X, y = _sep_data(n=400, margin=0.0, seed=11)
    Xt, yt = torch.as_tensor(X), torch.as_tensor(y)
    fa = torch.zeros(400, dtype=torch.uint8)
    kb.perceptron_scan_plain(Xt, yt, flags=fa)
    assert partings.perceptron_parting(Xt, yt, fa, fa.clone()) is None
    fb = fa.clone()
    fb[250] ^= 1
    part = partings.perceptron_parting(Xt, yt, fa, fb)
    assert part["row"] == 250 and not part["tie"] and part["bound"] < 1e-4
    assert (part["margin"] <= 0) == bool(fa[250])  # the exact margin decides as run a did

    lam, k = 1e-3, 4
    fa = torch.zeros(400, dtype=torch.uint8)
    w_end = kb.pegasos_scan_plain(Xt, yt, lam, k, flags=fa)
    assert partings.pegasos_parting(Xt, yt, lam, k, fa, fa.clone(), None) is None
    fb = fa.clone()
    fb[301] ^= 1
    states = lambda t: (kb.pegasos_scan_plain(Xt[: t * k], yt[: t * k], lam, k),)
    part = partings.pegasos_parting(Xt, yt, lam, k, fa, fb, states)
    assert part["row"] == 301 and part["step"] == 75 and not part["tie"]
    assert (part["margin"] < 1.0) == bool(fa[301])
    assert torch.isfinite(w_end).all()
    # Run a as P2's walk (blocks of 32 rows): the walk's terms widen its bound.
    walk = partings.pegasos_parting(Xt, yt, lam, k, fa, fb, states, walk_rows=32)
    assert walk["row"] == 301 and walk["margin"] == part["margin"] and not walk["tie"]
    assert part["bound"] < walk["bound"] < 1e-3


@pytest.mark.parametrize("k", [1, 3, 20])
def test_pegasos_walk_bound_covers_an_f32_walk(k):
    """``pegasos_parting(walk_rows=)``'s bound for the walk's run holds an
    f32 walk's margins (``_walk_emulation`` in float32, each run of it a
    prefix of the sweep) to the exact margins at the float64 replay of the
    same decisions: at every eleventh row, flipped in a copy of the flags so
    that the two runs part there. Table 1's lambda on mnist-like widths
    (D = 300), where the margins are large and the corrections many."""
    rng = np.random.default_rng(k)
    n, d = 640, 300
    X = l2_normalize(rng.normal(size=(n, d)).astype(np.float32))
    y = np.sign(X @ rng.normal(size=d) + 0.3 * rng.normal(size=n)).astype(np.float32)
    lam = 1.0 / (10.0 * n)
    nk = n // k * k
    _, fa, m32, _ = _walk_emulation(X, y, lam, k, np.float32)
    Xt, yt = torch.as_tensor(X[:nk]), torch.as_tensor(y[:nk])
    fa = torch.as_tensor(fa, dtype=torch.uint8)
    prefix = lambda t: torch.as_tensor(_walk_emulation(X[:t * k], y[:t * k], lam, k, np.float32)[0]
                                       if t > 0 else np.zeros(d, np.float32))
    states = lambda t: (prefix(t),)
    checked = 0
    for j in range(5, nk, 11):
        fb = fa.clone()
        fb[j] ^= 1
        part = partings.pegasos_parting(Xt, yt, lam, k, fa, fb, states, walk_rows=kb.walk_rows(k))
        assert part["row"] == j
        assert abs(float(m32[j]) - part["margin"]) <= part["bound"], (j, part, float(m32[j]))
        checked += 1
    assert checked > 50


@pytest.mark.parametrize("width", [1, 2, 3, 21, 300, 784])
def test_lasvm_dots_sum_in_a_fixed_pairwise_order(width):
    """LASVM's dot products are summed in one pairwise order, each step an
    exactly rounded float64 operation (so the card gives the host CPU's
    bits): equal bit for bit to a numpy emulation of that order, and within
    float64 rounding of the exact sums."""
    rng = np.random.default_rng(width)
    A, B = rng.normal(size=(5, width)), rng.normal(size=(5, width))
    got = tb.lasvm.dots(torch.from_numpy(A), torch.from_numpy(B)).numpy()
    P = A * B
    P = np.pad(P, ((0, 0), (0, (1 << max(width - 1, 0).bit_length()) - width)))
    while P.shape[1] > 1:
        P = P[:, : P.shape[1] // 2] + P[:, P.shape[1] // 2 :]
    assert np.array_equal(got, P[:, 0])
    exact = np.array([float(sum(map(__import__("fractions").Fraction, a * b))) for a, b in zip(A, B)])
    assert np.allclose(got, exact, rtol=0, atol=(width + 2) * 2.0**-53 * np.abs(A * B).sum(1).max())


@pytest.mark.parametrize("width", [1, 2, 32, 1024])
def test_lasvm_dots_on_host_rows_equal_the_device_form(width):
    """The pair's kernel entries are summed on the host over numpy rows, the
    gradients in place over a tensor buffer (``halve``): both give the
    torch sums' bits."""
    rng = np.random.default_rng(width)
    A, B = rng.normal(size=(3, width)), rng.normal(size=(3, width))
    want = tb.lasvm.dots(torch.from_numpy(A), torch.from_numpy(B)).numpy()
    assert np.array_equal(tb.lasvm.dots(A, B), want)
    Q = torch.from_numpy(A * B)
    assert np.array_equal(tb.lasvm.halve(Q).numpy(), want)
