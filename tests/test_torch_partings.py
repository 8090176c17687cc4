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
