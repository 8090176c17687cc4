"""The kernelized bank of the port (B5 + R1) against the JAX reference.

The same seeded numpy inputs go through ``repro.core.fit_kernel_bank`` (its
Gram in Pallas interpret mode), the numpy oracle ``repro.kernels.ref.
fit_kernel_bank_ref`` and the port on the CPU, which runs the plain versions
of B5 and R1. The slot trajectory is part of the contract: ``idx``, ``m``
and the gathered ``points`` are held exactly; ``coef``, ``q``, ``r`` and
``xi2`` to the reference's own tolerances (rtol 1e-4 / atol 1e-5; ``xi2``
rtol 1e-3 / atol 1e-6 under "smallest-coef", as tests/test_kernel_bank.py
holds the reference to its oracle).

The streams are unit-norm rows with gamma 1, where kernel values spread
over (e^-4, 1]. Where most values underflow towards 0 (rows far apart
against gamma), the "farthest-point" scores of many slots tie to the last
bit and the reference disagrees with its own oracle; ROADMAP.md section C
records that regime.

Within the port: ``s_tile`` chunking is bit-exact, and with S >= N the bank
is the dense ``fit_kernelized`` per model.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import KernelBank as JKernelBank
from repro.core import fit_kernel_bank as jfit_kernel_bank
from repro.core import kernel_bank_decision as jkernel_bank_decision
from repro.core import save_kernel_bank as jsave_kernel_bank
from repro.kernels import predict_kernel_bank as jpredict_kernel_bank
from repro.kernels.ref import fit_kernel_bank_ref
from repro.serve.bank_server import BankServer as JBankServer
from repro_torch.convert import kernel_bank_from_numpy, kernel_bank_to_numpy
from repro_torch.core import (
    KernelBank,
    fit_kernel_bank,
    fit_kernelized,
    kernel_bank_decision,
    linear_kernel,
    rbf_kernel,
    save_kernel_bank,
)
from repro_torch.core.kernel_bank import _kdiag
from repro_torch.kernels import ops, predict_kernel_bank
from repro_torch.kernels.gram import GRAM_SMEM, row_norms
from repro_torch.kernels.kernel_bank import (
    kernel_bank_rows,
    kernel_bank_rows_plain,
    rows_layouts,
    rows_plan,
    staged_smem,
)
from repro_torch.kernels.streamsvm_scan import SMEM_PER_BLOCK
from repro_torch.serve import BankServer

TIE_REL = 1e-5  # ids are compared where the margins are separated by more than this * max|score|


def _data(b, n, d, seed, sign0=0.2):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    Y = np.sign(rng.normal(size=(b, n))).astype(np.float32)
    Y[Y == 0] = 1.0
    mask = rng.random((b, n)) < sign0
    mask[:, 0] = False  # row 0 seeds every model
    Y[mask] = 0.0
    cs = np.linspace(0.5, 8.0, b).astype(np.float32)
    return X, Y, cs


def _port(X, Y, cs, **kw):
    return fit_kernel_bank(torch.as_tensor(X), torch.as_tensor(Y), torch.as_tensor(cs), **kw)


def _assert_bank(got, want, *, xi2_rtol=1e-3):
    """got: a port KernelBank; want: the 7 leaves of the reference's."""
    got = kernel_bank_to_numpy(got)
    idx, coef, points, q, r, xi2, m = (np.asarray(v) for v in want)
    np.testing.assert_array_equal(got[0], idx)
    np.testing.assert_array_equal(got[6], m)
    np.testing.assert_array_equal(got[2], points)
    np.testing.assert_allclose(got[1], coef, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[3], q, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[4], r, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[5], xi2, rtol=xi2_rtol, atol=1e-6)


CASES = list(itertools.product(["rbf", "linear"], ["smallest-coef", "farthest-point"],
                               [4, 8, 16], [8, 32]))


@pytest.mark.parametrize("kernel,eviction,s,block_n", CASES)
def test_fit_kernel_bank_vs_reference_and_oracle(kernel, eviction, s, block_n):
    X, Y, cs = _data(3, 100, 8, seed=s + block_n)  # N = 100 is ragged for both block_n
    kw = dict(kernel=kernel, gamma=1.0, coreset_size=s, eviction=eviction)
    got = _port(X, Y, cs, block_n=block_n, **kw)
    assert got.idx.dtype == torch.int32 and got.m.dtype == torch.int32
    xi2_rtol = 1e-3 if eviction == "smallest-coef" else 1e-4
    _assert_bank(got, fit_kernel_bank_ref(X, Y, cs, **kw), xi2_rtol=xi2_rtol)
    want = jfit_kernel_bank(jnp.asarray(X), jnp.asarray(Y), jnp.asarray(cs), block_n=block_n, **kw)
    _assert_bank(got, tuple(want), xi2_rtol=xi2_rtol)


def _growing(n, s, sign0=0.2):
    """A linear stream whose norms grow 1 % a row, so every new row lies
    outside each model's ball and every model absorbs well past S rows."""
    X, Y, cs = _data(3, n, 16, seed=s, sign0=sign0)
    return (X * 1.01 ** np.arange(n)[:, None]).astype(np.float32), Y, cs


@pytest.mark.parametrize("eviction", ["smallest-coef", "farthest-point"])
@pytest.mark.parametrize("s,n", [(129, 400), (256, 600)])
def test_fit_kernel_bank_beyond_128_slots_vs_reference_and_oracle(eviction, s, n):
    """Core sets past R1's four register slots a lane (S = 129: eight a
    lane; S = 256: all eight full), evicting, held as the small ones are."""
    X, Y, cs = _growing(n, s)
    kw = dict(kernel="linear", gamma=1.0, coreset_size=s, eviction=eviction)
    got = _port(X, Y, cs, block_n=64, **kw)
    assert (got.m > s).all() and ((got.idx >= 0).sum(1) == s).all()  # full, and evicting
    xi2_rtol = 1e-3 if eviction == "smallest-coef" else 1e-4
    _assert_bank(got, fit_kernel_bank_ref(X, Y, cs, **kw), xi2_rtol=xi2_rtol)
    want = jfit_kernel_bank(jnp.asarray(X), jnp.asarray(Y), jnp.asarray(cs), block_n=64, **kw)
    _assert_bank(got, tuple(want), xi2_rtol=xi2_rtol)


@pytest.mark.parametrize("eviction", ["smallest-coef", "farthest-point"])
def test_bf16_stream_vs_reference(eviction):
    """bf16 rounds the streamed tile only: K_cs is k(rounded tile, f32
    points), K_tt k(rounded, rounded), and the core sets stay f32."""
    X, Y, cs = _data(3, 90, 16, seed=31)
    kw = dict(kernel="rbf", gamma=1.0, coreset_size=8, eviction=eviction, block_n=32,
              stream_dtype="bf16")
    got = _port(X, Y, cs, **kw)
    want = jfit_kernel_bank(jnp.asarray(X), jnp.asarray(Y), jnp.asarray(cs), **kw)
    _assert_bank(got, tuple(want))
    # The gathered points come from the f32 stream, not the rounded one.
    live = got.idx >= 0
    assert torch.equal(got.points[live], torch.as_tensor(X)[got.idx[live].long()])
    f32 = _port(X, Y, cs, **{**kw, "stream_dtype": None})
    assert not torch.equal(got.q, f32.q)


# ---------------------------------------------------------------------------
# The tie regime: the reference's own draws under "farthest-point"
# ---------------------------------------------------------------------------

U32 = 2.0**-24  # f32 unit roundoff


def _reference_draws(b, n, d, seed, unit=False):
    """tests/test_kernel_bank.py::_bank_data(zeros=True)'s draws: N(0, 1)
    rows (unit-norm if ``unit``), 20 % inert signs, row 0 live."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    Y = np.sign(rng.normal(size=(b, n))).astype(np.float32)
    Y[Y == 0] = 1.0
    mask = rng.random(size=(b, n)) < 0.2
    mask[:, 0] = False
    Y[mask] = 0.0
    if unit:
        X /= np.linalg.norm(X, axis=1, keepdims=True)
    return X, Y, np.linspace(0.5, 8.0, b).astype(np.float32)


def _prefix_states(fit, Y):
    """fit(Ym) for Ym = Y with the rows from t on made inert, t = 0..N: the
    state after the stream's first t rows (inert rows move no state), at one
    shape, so the reference traces once."""
    out = []
    for t in range(Y.shape[1] + 1):
        Ym = Y.copy()
        Ym[:, t:] = 0.0
        out.append(tuple(np.asarray(v) for v in fit(Ym)))
    return out


def _same_state(a, b, bi):
    idx, coef, _, q, r, xi2, m = range(7)
    return (np.array_equal(a[idx][bi], b[idx][bi]) and a[m][bi] == b[m][bi]
            and np.allclose(a[coef][bi], b[coef][bi], rtol=1e-4, atol=1e-5)
            and all(np.isclose(a[k][bi], b[k][bi], rtol=1e-4, atol=1e-5) for k in (q, r, xi2)))


def _choice(pre, post, bi, row):
    """The slot that row ``row`` went into, or None if it was not absorbed."""
    if post[6][bi] == pre[6][bi]:
        return None
    return int(np.flatnonzero(post[0][bi] == row)[0])


def _decisions_f64(X, Y, cs, gamma, state, bi, row):
    """Row ``row``'s two decisions for model ``bi`` from ``state`` (before the
    row), in float64, each beside the error bound of its f32 evaluation.

    One f32 evaluation of k(a, b) = exp(-gamma d^2) errs by at most
    gamma (D + 2) u (|a| + |b|)^2 k in d^2's three D-term sums, plus exp's
    rounding: ``dk`` takes twice that. A score q - 2 sign(c_s) (Kbb c)_s +
    Kbb_ss then errs by 2 sum_t |c_t| dk_st + dk_ss plus its own summation,
    (S + 4) u times the magnitudes summed, also taken twice; d^2 likewise."""
    idx, coef = state[0][bi], state[1][bi].astype(np.float64)
    q, r, xi2 = (float(state[k][bi]) for k in (3, 4, 5))
    s_size, d = idx.shape[0], X.shape[1]
    live = idx >= 0
    P = np.where(live[:, None], X[np.clip(idx, 0, None)], 0.0).astype(np.float64)
    x = X[row].astype(np.float64)
    pn, xn = np.linalg.norm(P, axis=1), np.linalg.norm(x)

    def k(a, b):
        return np.exp(-gamma * ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1))

    def dk(na, nb, kk):
        return 2.0 * (gamma * (d + 2) * U32 * (na[:, None] + nb[None, :]) ** 2 + 2 * U32) * kk

    both = live[:, None] & live[None, :]
    kv = np.where(live, k(x[None], P)[0], 0.0)
    kbb = np.where(both, k(P, P), 0.0)
    dkv = np.where(live, dk(np.array([xn]), pn, kv[None])[0], 0.0)
    dkbb = np.where(both, dk(pn, pn, kbb), 0.0)
    c_inv = 1.0 / float(cs[bi])
    d2 = q - 2.0 * float(Y[bi, row]) * (coef @ kv) + 1.0 + xi2 + c_inv
    dist = np.sqrt(max(d2, 1e-12))
    d2_err = 2 * np.abs(coef) @ dkv + 2 * (s_size + 4) * U32 * (
        abs(q) + 2 * np.abs(coef) @ kv + 1.0 + xi2 + c_inv)
    score = np.where(live, q - 2.0 * np.sign(coef) * (kbb @ coef) + np.diag(kbb), -np.inf)
    score_err = 2 * dkbb @ np.abs(coef) + np.diag(dkbb) + 2 * (s_size + 4) * U32 * (
        abs(q) + 2 * kbb @ np.abs(coef) + 1.0)
    return dict(dist_minus_r=dist - r, dist_err=d2_err / (2 * dist) + 2 * U32 * r,
                score=score, score_err=score_err, free=~live)


def _partings(X, Y, cs, gamma, a, b):
    """Per model, the first row after which the prefix states ``a`` and ``b``
    differ, with the decision that differs and its float64 margin beside its
    bound, evaluated from each side's state before the row."""
    out = []
    for bi in range(Y.shape[0]):
        t = next((t for t in range(1, Y.shape[1] + 1) if not _same_state(a[t], b[t], bi)), None)
        if t is None:
            continue
        row = t - 1
        ca, cb = _choice(a[row], a[t], bi, row), _choice(b[row], b[t], bi, row)
        for pre in (a[row], b[row]):
            f = _decisions_f64(X, Y, cs, gamma, pre, bi, row)
            if (ca is None) != (cb is None):
                kind, gap, tol = "absorb", abs(f["dist_minus_r"]), f["dist_err"]
            elif ca != cb and not f["free"].any():
                j = int(np.argmin(f["score"]))  # the float64 minimum: both picks lie within
                kind = "slot"                   # their two evaluations' errors of it
                gap, tol = max((f["score"][s] - f["score"][j], f["score_err"][s] + f["score_err"][j])
                               for s in (ca, cb))
            else:
                kind, gap, tol = "other", np.inf, 0.0  # a free slot or the same decision
            out.append(dict(model=bi, row=row, kind=kind, slots=(ca, cb), gap=gap, tol=tol))
    return out


TIE_DRAWS = [  # (seed, D, unit-norm, gamma, S, block_n)
    (4, 11, False, 0.6, 4, 8),  # tests/test_kernel_bank.py::test_bounded_buffer_matches_ref's
    (8, 11, False, 0.6, 8, 16),  # draws and shapes, under "farthest-point"
    (16, 11, False, 0.6, 16, 8),
    (4, 16, True, 2.0, 4, 8),  # unit-norm rows with gamma 2
]


@pytest.mark.parametrize("seed,d,unit,gamma,s,block_n", TIE_DRAWS)
def test_farthest_point_ties_on_the_reference_draws(seed, d, unit, gamma, s, block_n):
    """Where most RBF values underflow towards 0, many farthest-point scores
    agree to a few ulps and an argmin (or a dist >= r) is decided by
    rounding: the reference and its own oracle part there (ROADMAP.md
    section C lists the rows). The port is held to both up to the first row
    where either parts from it: the states before it are equal (idx and m
    exactly), and the decision that differs there is a tie within the f32
    error of its evaluation: both slots' float64 scores lie within their
    errors of the float64 minimum, or |dist - r| within the error of dist."""
    X, Y, cs = _reference_draws(3, 57, d, seed, unit)
    kw = dict(kernel="rbf", gamma=gamma, coreset_size=s, eviction="farthest-point")
    port = _prefix_states(
        lambda Ym: kernel_bank_to_numpy(_port(X, Ym, cs, block_n=block_n, seed_check=False, **kw)), Y)
    oracle = _prefix_states(lambda Ym: fit_kernel_bank_ref(X, Ym, cs, **kw), Y)
    ref = _prefix_states(lambda Ym: jfit_kernel_bank(jnp.asarray(X), jnp.asarray(Ym), jnp.asarray(cs),
                                                     block_n=block_n, seed_check=False, **kw), Y)
    for other in (oracle, ref):
        for p in _partings(X, Y, cs, gamma, port, other):
            assert p["kind"] != "other" and p["gap"] <= p["tol"], p


def test_continuation_with_inert_first_rows():
    """seed_check=False: a model whose first rows are inert seeds on its first
    live row; a model with no live row is the merge identity."""
    X, Y, cs = _data(4, 70, 8, seed=41)
    Y[1, :9] = 0.0
    Y[2, :] = 0.0
    Y[3, 0] = 0.0
    kw = dict(kernel="rbf", gamma=1.0, coreset_size=8, block_n=16)
    with pytest.raises(ValueError, match=r"Y\[:, 0\]"):
        _port(X, Y, cs, **kw)
    got = _port(X, Y, cs, seed_check=False, **kw)
    _assert_bank(got, fit_kernel_bank_ref(X, Y, cs, kernel="rbf", gamma=1.0, coreset_size=8))
    want = jfit_kernel_bank(jnp.asarray(X), jnp.asarray(Y), jnp.asarray(cs), seed_check=False, **kw)
    _assert_bank(got, tuple(want))
    assert int(got.m[2]) == 0 and float(got.q[2]) == 0.0 and float(got.r[2]) == 0.0
    assert bool((got.idx[2] == -1).all()) and int(got.m[1]) >= 1
    assert int(got.idx[1][got.idx[1] >= 0].min()) >= 9


@pytest.mark.parametrize("s_tile", [1, 3, 8])
@pytest.mark.parametrize("eviction", ["smallest-coef", "farthest-point"])
def test_s_tile_is_bit_exact(s_tile, eviction):
    X, Y, cs = _data(3, 90, 6, seed=76)
    kw = dict(coreset_size=8, gamma=0.8, block_n=32, eviction=eviction)
    base = _port(X, Y, cs, **kw)
    tiled = _port(X, Y, cs, s_tile=s_tile, **kw)
    for name, a, b in zip(KernelBank._fields, base, tiled):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("kernel", ["rbf", "linear"])
@pytest.mark.parametrize("block_n", [8, 32])
def test_full_buffer_is_the_dense_fit(kernel, block_n):
    b, n = 3, 41
    X, Y, cs = _data(b, n, 12, seed=7, sign0=0.0)
    gamma = 0.7
    kb = _port(X, Y, cs, kernel=kernel, gamma=gamma, coreset_size=n + 5, block_n=block_n)
    fn = rbf_kernel(gamma) if kernel == "rbf" else linear_kernel
    for bi in range(b):
        dense = fit_kernelized(torch.as_tensor(X), torch.as_tensor(Y[bi]), float(cs[bi]), fn)
        alpha = torch.zeros(n)
        live = kb.idx[bi] >= 0
        alpha[kb.idx[bi][live].long()] = kb.coef[bi][live]
        torch.testing.assert_close(alpha, dense.alpha, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(kb.q[bi], dense.q, rtol=1e-4, atol=1e-6)
        torch.testing.assert_close(kb.r[bi], dense.r, rtol=1e-4, atol=1e-6)
        torch.testing.assert_close(kb.xi2[bi], dense.xi2, rtol=1e-3, atol=1e-6)
        assert int(kb.m[bi]) == int(dense.m)


@pytest.mark.parametrize("eviction", ["smallest-coef", "farthest-point"])
def test_full_buffer_beyond_128_slots_is_the_dense_fit(eviction):
    """S >= N past R1's register slots (S = 300: its slots sit in a device
    scratch on the card): nothing is evicted, whatever the policy, and each model is
    fit_kernelized's."""
    n = 280
    X, Y, cs = _growing(n, 7, sign0=0.0)
    kb = _port(X, Y, cs, kernel="linear", coreset_size=300, eviction=eviction, block_n=64)
    for bi in range(3):
        dense = fit_kernelized(torch.as_tensor(X), torch.as_tensor(Y[bi]), float(cs[bi]),
                               linear_kernel)
        alpha = torch.zeros(n)
        live = kb.idx[bi] >= 0
        alpha[kb.idx[bi][live].long()] = kb.coef[bi][live]
        assert int(kb.m[bi]) == int(dense.m) == int(live.sum()) > 128
        torch.testing.assert_close(alpha, dense.alpha, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(kb.q[bi], dense.q, rtol=1e-4, atol=1e-6)
        torch.testing.assert_close(kb.r[bi], dense.r, rtol=1e-4, atol=1e-6)
        torch.testing.assert_close(kb.xi2[bi], dense.xi2, rtol=1e-3, atol=1e-6)


def test_preflight_passes_any_core_set_size():
    """The preflight holds B5's and R1's launches to the budget each on its
    own, and R1 takes the layout rows_plan picks under that budget: the
    staged layout where it fits (S = 256 for 3 models: 2 models per CTA,
    140,320 B at the card's limit), else the first port's layouts, which
    take no shared memory (S = 256 under GRAM_SMEM; S = 300 and 9,000 pad
    past the staged layout's 256 slots). So fits at S = 256 and 300 pass at
    exactly GRAM_SMEM and are refused one byte below it, by B5's tiles."""
    assert ops.kernel_engine_vmem_bytes(3, 10, coreset_size=256) == {
        "gram_tiles": GRAM_SMEM, "row_recursion": 140_320}
    for s in (256, 300, 9000):
        assert ops.kernel_engine_vmem_bytes(3, 10, coreset_size=s, smem_budget=GRAM_SMEM) == {
            "gram_tiles": GRAM_SMEM, "row_recursion": 0}
    for s in (300, 9000):
        assert ops.kernel_engine_vmem_bytes(3, 10, coreset_size=s) == {
            "gram_tiles": GRAM_SMEM, "row_recursion": 0}
    X, Y, cs = _data(3, 40, 10, seed=2)
    for s in (256, 300):
        kb = fit_kernel_bank(X, Y, cs, coreset_size=s, block_n=16, vmem_budget_bytes=GRAM_SMEM,
                             device="cpu")
        assert int(kb.m.min()) >= 1
        with pytest.raises(ValueError, match=str(GRAM_SMEM - 1)):
            fit_kernel_bank(X, Y, cs, coreset_size=s, block_n=16,
                            vmem_budget_bytes=GRAM_SMEM - 1, device="cpu")


@pytest.mark.parametrize("s", [1, 16, 64, 129, 256, 300, 9000])
def test_rows_plan_fits_every_budget(s):
    """rows_plan over budgets from GRAM_SMEM to the card's 232,448 B (every
    97th byte and the staged layout's exact bytes, and one below): its
    bytes never exceed the budget; it stages (2 models per CTA) exactly
    where the staged layout fits (S padded to at most 256); else the first
    port's layouts (registers to S = 256, then wide) with no shared memory.
    So the preflight never refuses R1 at a budget B5 passes, for 600 models
    or 3."""
    for b in (600, 3):
        for far in (False, True):
            staged = sum(staged_smem(s, farthest=far).values())
            budgets = set(range(GRAM_SMEM, SMEM_PER_BLOCK + 1, 97)) | {SMEM_PER_BLOCK}
            budgets |= {staged + dv for dv in (0, -1)
                        if GRAM_SMEM <= staged + dv <= SMEM_PER_BLOCK}
            seen = set()
            for budget in sorted(budgets):
                plan = rows_plan(b, s, farthest=far, smem_budget=budget)
                nbytes = sum(plan["smem"].values())
                assert nbytes <= budget
                if s <= 256 and staged <= budget:
                    assert plan["layout"] == "staged" and plan["models_per_cta"] == 2
                    assert nbytes == staged and plan["ctas"] == -(-b // 2)
                else:
                    assert plan == rows_plan(b, s, farthest=far, smem_budget=0)
                    assert plan["layout"] == ("registers" if s <= 256 else "wide")
                    assert nbytes == 0
                by = ops.kernel_engine_vmem_bytes(
                    b, 10, coreset_size=s, eviction="farthest-point" if far else "smallest-coef",
                    smem_budget=budget)
                assert by == {"gram_tiles": GRAM_SMEM, "row_recursion": nbytes}
                seen.add(plan["layout"])
            assert ("staged" in seen) == (s <= 129 or (s == 256 and not far))


def test_rows_plan_at_the_kernel_bank_pass():
    """Phase 6b's tiles (B = 600, S = 64) at the card's limit: the staged
    layout, 300 CTAs of 2 models, 35,872 B a CTA for smallest-coef and
    70,688 B with farthest-point's Kbb slabs; under a budget below that the
    registers layout. S = 256 stages smallest-coef only (farthest-point's
    slabs would need 532,480 B), and S = 300 takes the wide layout."""
    for far, nbytes in ((False, 35_872), (True, 70_688)):
        plan = rows_plan(600, 64, farthest=far)
        assert plan["layout"] == "staged" and plan["ctas"] == 300
        assert sum(plan["smem"].values()) == nbytes
        assert [p["layout"] for p in rows_layouts(600, 64, farthest=far)] == [
            "staged", "registers"]
        assert rows_plan(600, 64, farthest=far, smem_budget=nbytes - 1)["layout"] == "registers"
    assert rows_plan(600, 256)["layout"] == "staged"
    assert [p["layout"] for p in rows_layouts(600, 256, farthest=True)] == ["registers"]
    assert [p["layout"] for p in rows_layouts(600, 300)] == ["wide"]


def test_kdiag_is_the_gram_diagonal():
    rng = np.random.default_rng(73)
    X = torch.as_tensor(rng.normal(size=(37, 6)).astype(np.float32))
    X[5] = X[19]
    assert torch.equal(_kdiag(X, "rbf"), torch.ones(37))
    assert torch.equal(torch.diagonal(ops.gram(X, X, epilogue="rbf", gamma=0.7)), _kdiag(X, "rbf"))
    torch.testing.assert_close(torch.diagonal(ops.gram(X, X)), _kdiag(X, "linear"),
                               rtol=1e-6, atol=1e-6)


def test_rows_wrapper_runs_the_plain_version_on_the_cpu():
    X, Y, cs = _data(2, 16, 5, seed=9)
    Xt = torch.as_tensor(X)
    k_cs = torch.zeros(16, 2, 4)
    k_tt = ops.gram(Xt, Xt, epilogue="rbf", gamma=1.0)
    states = []
    for fn in (kernel_bank_rows, kernel_bank_rows_plain):
        st = [torch.full((2, 4), -1, dtype=torch.int32), torch.zeros(2, 4), torch.zeros(2),
              torch.zeros(2), torch.zeros(2), torch.zeros(2, dtype=torch.int32)]
        c_inv = 1.0 / torch.as_tensor(cs)
        fn(k_cs, k_tt, torch.as_tensor(Y), *st, c_inv, c_inv, base=0, n_valid=16)
        states.append(st)
    for a, b in zip(*states):
        assert torch.equal(a, b)
    assert int(states[0][5].min()) >= 1
    with pytest.raises(ValueError, match="k_tt"):
        kernel_bank_rows(k_cs, k_tt[:3], torch.as_tensor(Y), *states[0], c_inv, c_inv,
                         base=0, n_valid=16)


def test_fit_kernel_bank_validation():
    X, Y, cs = _data(2, 10, 4, seed=1)
    for kw, what in ((dict(kernel="poly"), "kernel"), (dict(eviction="lru"), "eviction"),
                     (dict(variant="x"), "variant"), (dict(coreset_size=0), "coreset_size"),
                     (dict(s_tile=0), "s_tile")):
        with pytest.raises(ValueError, match=what):
            _port(X, Y, cs, **kw)
    with pytest.raises(ValueError, match=r"\(B, N\)"):
        _port(X, Y[:, :-1], cs)
    with pytest.raises(ValueError, match=r"\(B, N\)"):
        _port(X, Y[0], cs)
    Ybad = Y.copy()
    Ybad[1, 0] = 0.0
    Yb4 = np.concatenate([Ybad, Ybad])
    Yb4[3, 0] = 0.0
    with pytest.raises(ValueError) as err:
        _port(X, Yb4, 1.0)
    assert "Y[:, 0]" in str(err.value) and "[1, 3]" in str(err.value)
    with pytest.raises(TypeError, match="DeviceMesh"):  # mesh= takes a DeviceMesh (A10)
        _port(X, Y, cs, mesh=object())
    with pytest.raises(ValueError, match="breakdown"):  # below B5's 16,640 B of tiles
        _port(X, Y, cs, vmem_budget_bytes=16_639)


# ---------------------------------------------------------------------------
# Serving: predict_kernel_bank, checkpoints across packages, BankServer
# ---------------------------------------------------------------------------


def _served(seed=5, b=4, n=64, d=10, s=12, gamma=0.5):
    X, Y, cs = _data(b, n, d, seed=seed)
    kb = _port(X, Y, cs, kernel="rbf", gamma=gamma, coreset_size=s, block_n=16)
    Q = np.random.default_rng(seed + 100).normal(size=(23, d)).astype(np.float32)
    Q /= np.linalg.norm(Q, axis=1, keepdims=True)
    return kb, Q, gamma


def _score_atol(coef, scale=1.0):
    """Margins are sums of S coef * K terms: each K within the Gram bound of
    test_torch_gram.py (unit-norm rows: 2 gamma 2 (D + 1) u + 1e-6 < 1e-5),
    then an S-term sum; so |coef|_1 * 1e-5 per model."""
    return np.abs(np.asarray(coef)).sum(-1)[None, :] * 1e-5 * scale


def _separated(sorted_scores, rel=TIE_REL):
    tol = rel * np.abs(sorted_scores).max()
    gaps = sorted_scores[..., :-1] - sorted_scores[..., 1:]
    inf = np.full(gaps[..., :1].shape, np.inf)
    return np.minimum(np.concatenate([inf, gaps], -1), np.concatenate([gaps, inf], -1)) > tol


def test_predict_kernel_bank_vs_reference_all_epilogues():
    kb, Q, gamma = _served()
    _, C, P = kernel_bank_to_numpy(kb)[:3]
    jkw = dict(kernel="rbf", gamma=gamma)
    got = predict_kernel_bank(torch.as_tensor(Q), kb.points, kb.coef, **jkw).numpy()
    want = np.asarray(jpredict_kernel_bank(jnp.asarray(Q), jnp.asarray(P), jnp.asarray(C), **jkw))
    assert np.all(np.abs(got - want) <= _score_atol(C))
    cls, margin = predict_kernel_bank(torch.as_tensor(Q), kb.points, kb.coef, epilogue="ovr",
                                      n_classes=2, **jkw)
    jcls, jmargin = jpredict_kernel_bank(jnp.asarray(Q), jnp.asarray(P), jnp.asarray(C),
                                         epilogue="ovr", n_classes=2, **jkw)
    grp = -np.sort(-want.reshape(len(Q), 2, 2), axis=-1)
    sep = _separated(grp)[..., 0]
    assert np.array_equal(cls.numpy()[sep], np.asarray(jcls)[sep]) and sep.sum() > 30
    np.testing.assert_allclose(margin.numpy(), np.asarray(jmargin), rtol=0, atol=1e-5)
    vals, ids = predict_kernel_bank(torch.as_tensor(Q), kb.points, kb.coef, epilogue="topk",
                                    k=3, **jkw)
    jvals, jids = jpredict_kernel_bank(jnp.asarray(Q), jnp.asarray(P), jnp.asarray(C),
                                       epilogue="topk", k=3, **jkw)
    sep = _separated(-np.sort(-want, axis=1))[:, :3]
    assert np.array_equal(ids.numpy()[sep], np.asarray(jids)[sep]) and sep.sum() > 50
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), rtol=0, atol=1e-5)
    assert ids.dtype == torch.int32 and cls.dtype == torch.int32


def test_predict_kernel_bank_ties_go_to_the_lowest_id():
    points = torch.zeros(4, 2, 3)
    coef = torch.zeros(4, 2)  # every score is 0
    Q = torch.ones(5, 3)
    _, ids = predict_kernel_bank(Q, points, coef, epilogue="topk", k=3)
    assert ids.tolist() == [[0, 1, 2]] * 5
    cls, _ = predict_kernel_bank(Q, points, coef, epilogue="ovr", n_classes=2)
    assert cls.tolist() == [[0, 0]] * 5


def test_predict_kernel_bank_validation():
    kb, Q, _ = _served()
    Qt = torch.as_tensor(Q)
    bad = [
        ((Qt[:, :-1], kb.points, kb.coef), dict(kernel="rbf"), "feature axis"),
        ((Qt, kb.points, kb.coef[:-1]), dict(kernel="rbf"), r"\(B, S\)"),
        ((Qt, kb.points, kb.coef), dict(kernel="poly"), "kernel"),
        ((Qt, kb.points, kb.coef), dict(epilogue="ovr", n_classes=3), "n_classes"),
        ((Qt, kb.points, kb.coef), dict(epilogue="topk", k=99), "topk"),
        ((Qt, kb.points, kb.coef), dict(epilogue="argmax"), "epilogue"),
        ((Qt, kb.points, kb.coef), dict(n_classes=2), "requires epilogue='ovr'"),
        ((Qt, kb.points, kb.coef), dict(k=2), "requires epilogue='topk'"),
        ((Qt, kb.points, kb.coef), dict(q_block=0), "q_block"),
        ((Qt, kb.points, kb.coef), dict(point_norms=torch.ones(5)), "point_norms"),
    ]
    for args, kw, what in bad:
        with pytest.raises(ValueError, match=what):
            predict_kernel_bank(*args, **kw)
    # Norms computed once by the caller give the bits of norms computed per call.
    b, s, d = kb.points.shape
    norms = row_norms(kb.points.reshape(b * s, d))
    assert torch.equal(predict_kernel_bank(Qt, kb.points, kb.coef, point_norms=norms),
                       predict_kernel_bank(Qt, kb.points, kb.coef))


def test_checkpoints_cross_packages(tmp_path):
    kb, Q, gamma = _served(seed=17)
    leaves = kernel_bank_to_numpy(kb)
    jkb = JKernelBank(*(jnp.asarray(v) for v in leaves))
    want = np.asarray(jkernel_bank_decision(jkb, jnp.asarray(Q), kernel="rbf", gamma=gamma))
    # repro writes, the port serves
    jsave_kernel_bank(str(tmp_path / "j"), jkb, kernel="rbf", gamma=gamma, meta={"n_classes": 2})
    srv = BankServer.from_checkpoint(str(tmp_path / "j"), q_block=16, device="cpu")
    assert srv.kernel == "rbf" and srv.gamma == gamma and srv.bank_shape == tuple(kb.points.shape)
    got = srv.score(Q)
    assert np.all(np.abs(got - want) <= _score_atol(leaves[1]))
    assert np.array_equal(got, kernel_bank_decision(kb, torch.as_tensor(Q), kernel="rbf",
                                                    gamma=gamma).numpy())
    # the port writes, repro serves
    save_kernel_bank(str(tmp_path / "p"), kb, kernel="rbf", gamma=gamma, meta={"n_classes": 2})
    jsrv = JBankServer.from_checkpoint(str(tmp_path / "p"), q_block=16)
    assert jsrv.kernel == "rbf" and jsrv.gamma == gamma
    assert np.all(np.abs(np.asarray(jsrv.score(Q)) - got) <= _score_atol(leaves[1]))
    back = kernel_bank_from_numpy(tuple(np.asarray(v) for v in jkb), device="cpu")
    for a, b in zip(back, kb):
        assert torch.equal(a, b)


def test_bank_server_kernel_mode(tmp_path):
    kb, Q, gamma = _served(seed=19)
    path = str(tmp_path / "kb")
    save_kernel_bank(path, kb, kernel="rbf", gamma=gamma, meta={"n_classes": 2})
    srv = BankServer.from_checkpoint(path, q_block=16, device="cpu")
    direct = kernel_bank_decision(kb, torch.as_tensor(Q), kernel="rbf", gamma=gamma).numpy()
    assert np.array_equal(srv.score(Q), direct)  # bit for bit
    assert srv.stats.finished == 1 and srv.stats.steps == 2  # 23 rows / 16
    ovr = BankServer.from_checkpoint(path, epilogue="ovr", q_block=16, device="cpu")
    assert ovr.n_classes == 2
    cls, _ = ovr.score(Q)
    assert np.array_equal(cls, direct.reshape(-1, 2, 2).argmax(-1))

    # A hot swap between steps keeps the queued rows: rows scored after it
    # see the new bank.
    kb2 = kb._replace(coef=-kb.coef)
    reqs = [srv.submit(Q[i : i + 8]) for i in range(0, 23, 8)]
    srv.step()
    assert srv.pending_rows() == 7
    srv.swap_bank(kb2, kernel="rbf", gamma=gamma)
    srv.run()
    assert all(r.done for r in reqs) and srv.stats.bank_swaps == 1
    assert np.array_equal(reqs[0].result, direct[:8]) and np.array_equal(reqs[1].result, direct[8:16])
    assert np.array_equal(reqs[2].result, -direct[16:])


def test_bank_server_kernel_errors_match_the_reference():
    kb, Q, gamma = _served(seed=23)
    jkb = JKernelBank(*(jnp.asarray(v) for v in kernel_bank_to_numpy(kb)))
    small = kb._replace(idx=kb.idx[:, :4], coef=kb.coef[:, :4], points=kb.points[:, :4])
    jsmall = JKernelBank(*(jnp.asarray(v) for v in kernel_bank_to_numpy(small)))
    lin = np.zeros((3, 10), np.float32)
    cases = [
        (lambda S, bank, s: S(bank), "kernel="),
        (lambda S, bank, s: S(lin, kernel="rbf"), "KernelBank"),
        (lambda S, bank, s: S(bank, kernel="rbf", gamma=gamma).swap_bank(lin), "KernelBank"),
        (lambda S, bank, s: S(bank, kernel="rbf", gamma=gamma).swap_bank(s), "hot-swap"),
        (lambda S, bank, s: S(lin).swap_bank(bank), "KernelBank"),
        (lambda S, bank, s: S(bank, kernel="rbf", gamma=gamma).swap_bank(bank, kernel="linear"),
         "kernel='linear'"),
        (lambda S, bank, s: S(bank, kernel="rbf", gamma=gamma).swap_bank(bank, gamma=2 * gamma),
         "gamma"),
    ]
    for make, what in cases:
        msgs = []
        for S, bank, s in ((JBankServer, jkb, jsmall),
                           (lambda *a, **k: BankServer(*a, device="cpu", **k), kb, small)):
            with pytest.raises(ValueError, match=what) as err:
                make(S, bank, s)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]
