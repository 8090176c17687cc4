"""``repro_torch.kernels.partings.stream_parting``: where two runs of
Algorithm 1 or 2 for one model first part, and whether that is an f32 tie.

One run is the entry point on the CPU (``fit`` / ``fit_lookahead``, which run
B4's and B3's plain versions there); the other a direct single-model loop in
f32 (``_direct``) that either follows the same rules, breaks a flush's exact
tie on the other side, or is wrong (a push threshold or a step off): only
the tie is certified.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import fit, fit_lookahead
from repro_torch.kernels.partings import stream_parting

C = 10.0
C_INV = float(1.0 / torch.tensor(C, dtype=torch.float32))


def _direct(Z, lookahead, *, last_on_ties=False, s_half=0.5, push_scale=1.0):
    """Algorithm 2 (``lookahead`` L; None: Algorithm 1) for one model in f32
    with direct distances, as ``run(nv)`` over the first nv signed rows:
    a row with d >= push_scale * r is pushed, a full window flushed
    farthest-first (``last_on_ties``: the highest slot wins an exact tie),
    each absorbed point moving the centre by s = s_half (1 - r / d)."""
    L = 1 if lookahead is None else lookahead

    def run(nv):
        Zt = torch.as_tensor(Z[:nv], dtype=torch.float32)
        w, r, xi2, m = Zt[0].clone(), torch.tensor(0.0), torch.tensor(C_INV), 1
        win = []

        def flush():
            nonlocal w, r, xi2
            while win:
                bd = torch.stack([torch.sqrt(((w - p) ** 2).sum() + xi2 + C_INV) for p in win])
                k = (len(bd) - 1 - int(torch.argmax(bd.flip(0))) if last_on_ties
                     else int(torch.argmax(bd)))
                if lookahead is not None and bd[k] < r:
                    break
                s = s_half * (1.0 - r / bd[k])
                w, r = (1 - s) * w + s * win.pop(k), r + 0.5 * (bd[k] - r)
                xi2 = xi2 * (1 - s) ** 2 + s * s * C_INV
            win.clear()

        for z in Zt[1:]:
            if torch.sqrt(((w - z) ** 2).sum() + xi2 + C_INV) >= push_scale * r:
                win.append(z)
                m += 1
                if len(win) >= L:
                    flush()
        flush()
        return w, r, xi2, m

    return run


def _entry(X, y, lookahead):
    Xt, yt = torch.as_tensor(X), torch.as_tensor(y)
    if lookahead is None:
        return lambda nv: tuple(fit(Xt[:nv], yt[:nv], C, device="cpu"))
    return lambda nv: tuple(fit_lookahead(Xt[:nv], yt[:nv], C, lookahead, device="cpu"))


def _stream(n, d, seed, mirrored=False):
    """Random signed rows; ``mirrored``: row 0 on the first axis and the
    rows after it in mirror pairs (x, v) and (x, -v), which the first flush
    meets at exactly equal distances."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = np.where(rng.random(n) < 0.5, -1.0, 1.0).astype(np.float32)
    if mirrored:
        X[0] = 0.0
        X[0, 0], y[0] = 1.0, 1.0
        X[2::2, 0], X[2::2, 1:] = X[1:-1:2, 0], -X[1:-1:2, 1:]
        y[2::2] = y[1:-1:2]
    return X, y, y[:, None] * X


@pytest.mark.parametrize("lookahead", [None, 4])
def test_runs_that_agree_do_not_part(lookahead):
    X, y, Z = _stream(300, 5, seed=1)
    part = stream_parting(_entry(X, y, lookahead), _direct(Z, lookahead), torch.as_tensor(Z),
                          C_INV, C_INV, lookahead)
    assert part is None


def test_a_flush_tie_broken_the_other_way_is_certified():
    X, y, Z = _stream(201, 3, seed=2, mirrored=True)
    part = stream_parting(_entry(X, y, 4), _direct(Z, 4, last_on_ties=True), torch.as_tensor(Z),
                          C_INV, C_INV, 4)
    assert part is not None and part["kind"] == "flush" and part["tie"]
    assert part["margin"] == 0.0 and part["row"] in (1, 3)  # the first flush's farthest pair


@pytest.mark.parametrize("lookahead", [None, 4])
def test_a_wrong_step_is_not_a_tie(lookahead):
    X, y, Z = _stream(300, 5, seed=3)
    part = stream_parting(_entry(X, y, lookahead), _direct(Z, lookahead, s_half=0.45),
                          torch.as_tensor(Z), C_INV, C_INV, lookahead)
    assert part is not None and not part["tie"]
    assert part["kind"] == "state" and part["row"] < 40  # the first update or flush


@pytest.mark.parametrize("lookahead", [None, 4])
def test_a_wrong_push_test_is_not_a_tie(lookahead):
    X, y, Z = _stream(300, 5, seed=4)
    part = stream_parting(_entry(X, y, lookahead), _direct(Z, lookahead, push_scale=1.05),
                          torch.as_tensor(Z), C_INV, C_INV, lookahead)
    assert part is not None and part["kind"] == "push" and not part["tie"]
    assert part["margin"] > part["bound"]  # run a pushed, decided by float64


def _pushes(run, n):
    """Run a's pushing rows by brute force: every prefix's m."""
    m = [int(run(nv)[3]) for nv in range(1, n + 1)]
    return [nv for nv in range(1, n) if m[nv] != m[nv - 1]]


@pytest.mark.parametrize("case", ["flush_tie", "wrong_push"])
def test_given_pushes_give_the_same_certificate(case):
    """``pushes_a`` (run a's pushing rows, known to the caller) skips the
    bisection over run a's m and changes nothing of the result."""
    if case == "flush_tie":
        X, y, Z = _stream(201, 3, seed=2, mirrored=True)
        runs, L = (_entry(X, y, 4), _direct(Z, 4, last_on_ties=True)), 4
    else:
        X, y, Z = _stream(120, 5, seed=4)
        runs, L = (_entry(X, y, None), _direct(Z, None, push_scale=1.05)), None
    want = stream_parting(*runs, torch.as_tensor(Z), C_INV, C_INV, L)
    got = stream_parting(*runs, torch.as_tensor(Z), C_INV, C_INV, L,
                         pushes_a=_pushes(runs[0], len(y)))
    assert got == want and want is not None


@pytest.mark.parametrize("lookahead", [None, 3])
def test_a_lane_with_its_signs_zeroed_is_its_prefix_run(lookahead):
    """The premise of chip_smoke.py's C5 certificates: in B6 train's plain
    version a lane whose signs are zeroed past row nv ends in the state of
    the prefix run n_valid=nv (partial window flushed), bit for bit, beside
    lanes cut elsewhere."""
    from repro_torch.kernels.streamsvm_scan import (
        streamsvm_scan_lookahead_many_ring_plain,
        streamsvm_scan_many_ring_plain,
    )

    rng = np.random.default_rng(5)
    n, d, bp = 300, 6, 8
    X = rng.normal(size=(n, d)).astype(np.float32)
    X = torch.as_tensor(X / np.linalg.norm(X, axis=1, keepdims=True))
    y = torch.as_tensor(np.where(rng.random(n) < 0.5, -1.0, 1.0).astype(np.float32))
    cuts = [0, 1, 17, 40, 41, 255, 256, 299]
    Y = y[None, :].repeat(bp, 1)
    for j, c in enumerate(cuts):
        Y[j, c:] = 0.0
    c_inv = torch.full((bp,), C_INV)
    W0 = Y[:, :1] * X[:1]
    args = (W0, torch.zeros(bp), c_inv.clone(), c_inv, torch.ones(bp, dtype=torch.int32), c_inv)
    kw = {} if lookahead is None else dict(
        lookahead=torch.full((bp,), lookahead, dtype=torch.int32), lookahead_max=lookahead)
    fn = (streamsvm_scan_many_ring_plain if lookahead is None
          else streamsvm_scan_lookahead_many_ring_plain)
    Xp = torch.nn.functional.pad(X[1:], (0, 0, 0, 512 - (n - 1)))
    Yp = torch.nn.functional.pad(Y[:, 1:], (0, 512 - (n - 1)))
    whole = fn(Xp, Yp, *args, n_valid=n - 1, **kw)
    full = y[None, :].repeat(bp, 1)
    Yf = torch.nn.functional.pad(full[:, 1:], (0, 512 - (n - 1)))
    for j, c in enumerate(cuts):
        nv = max(c - 1, 0)  # bank rows: the stream's rows 1..c-1
        pre = fn(Xp, Yf, W0[j : j + 1].repeat(bp, 1), *args[1:], n_valid=nv, **kw)
        for a, b in zip(whole, pre):
            assert torch.equal(a[j], b[j]), (j, c)
