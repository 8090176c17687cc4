"""M1 and the port's Sec 4.3 multi-ball against the JAX reference.

The same seeded numpy inputs go through ``repro.core.multiball`` (its
per-row ``lax.scan``) and the port on the CPU, which runs M1's plain
version. Slot counts ``m`` and ``active`` are held exactly; w, r and xi2
within the engine tolerance, rtol 2e-4 / atol 2e-5 (f32 sums over D in
another order). Within the port, the blocked plain version (a block's
distances at once, the first acting row applied, only the changed slots'
table entries computed again) equals a row-at-a-time loop bit for bit.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.core import fit, fit_multiball, to_single_ball
from repro_torch.core.multiball import MultiBall, decision_function
from repro_torch.kernels import multiball as mb_kernel
from repro_torch.kernels.multiball import (
    BLOCK_ROWS,
    GRID_HEAD_BYTES,
    HEAD_BYTES,
    cta_plan,
    grid_smem,
    multiball_layouts,
    multiball_plan,
    multiball_scan,
    multiball_scan_plain,
    multiball_smem,
    pitch,
    sq_dist,
)
from repro_torch.kernels.streamsvm_scan import SMEM_PER_BLOCK

TOL = dict(rtol=2e-4, atol=2e-5)


def _data(n, d, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = np.sign(rng.normal(size=n) + 1.5 * X[:, 0]).astype(np.float32)
    y[y == 0] = 1
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    return X, y


def edge_stream(n, d, seed):
    """A quiet cloud (norm ~0.05 sqrt(D)) with loud rows (unit directions,
    each 3x the last) on the first and last scan row of every other block
    from block 2 on: updates on block edges, blocks without any, and (L >=
    2) pair merges. Scan row p is stream row p + 1 (row 0 seeds)."""
    rng = np.random.default_rng(seed)
    X = 0.05 * rng.normal(size=(n, d))
    y = np.where(rng.random(n) < 0.5, -1.0, 1.0)
    scale = 1.0
    for b in range(2, (n - 1) // BLOCK_ROWS, 2):
        for p in (BLOCK_ROWS * b, BLOCK_ROWS * b + BLOCK_ROWS - 1):
            v = rng.normal(size=d)
            X[p + 1] = scale * v / np.linalg.norm(v)
            scale *= 3.0
    return X.astype(np.float32), y.astype(np.float32)


def _start(X, y, L, slack0):
    """fit_multiball's state after row 0, on the device of X."""
    dev, d = X.device, X.shape[1]
    w = torch.zeros((L, d), device=dev)
    w[0] = y[0] * X[0]
    r, xi2 = torch.zeros(L, device=dev), torch.zeros(L, device=dev)
    xi2[0] = slack0
    m = torch.zeros(L, dtype=torch.int32, device=dev)
    m[0] = 1
    act = torch.zeros(L, dtype=torch.bool, device=dev)
    act[0] = True
    return [w, r, xi2, m, act]


def _row_loop(X, y, L, c_inv, slack0):
    """M1's recursion one row at a time: every distance and the whole pair
    table computed afresh for each row, the same decision rule."""
    X, y = torch.as_tensor(X), torch.as_tensor(y)
    w, r, xi2, m, act = _start(X, y, L, slack0)
    wp = pitch(X.shape[1])
    W = F.pad(w, (0, wp - X.shape[1]))
    s0 = torch.tensor(slack0)
    for i in range(1, len(X)):
        x = y[i] * F.pad(X[i], (0, wp - X.shape[1]))
        s_row = sq_dist(W, x[None])
        dist = torch.sqrt(torch.clamp((s_row + xi2) + c_inv, min=1e-12))
        if bool((act & (dist <= r)).any()):
            continue
        mb_kernel.absorb(W, r, xi2, m, act, sq_dist(W[:, None], W[None]), s_row, x, s0)
    return [W[:, : X.shape[1]], r, xi2, m, act]


def _spy_actions(monkeypatch):
    """Record (slots written, every slot active before) for each update the
    plain version applies."""
    seen, orig = [], mb_kernel.absorb

    def spy(W, r, xi2, m, act, *rest):
        full = bool(act.all())
        ch = orig(W, r, xi2, m, act, *rest)
        seen.append((len(ch), full))
        return ch

    monkeypatch.setattr(mb_kernel, "absorb", spy)
    return seen


def _reference(X, y, c, L, variant):
    import jax.numpy as jnp
    from repro.core.multiball import fit_multiball as jfit_multiball

    return jfit_multiball(jnp.asarray(X), jnp.asarray(y), c, n_balls=L, variant=variant)


def _assert_close(got, ref):
    np.testing.assert_array_equal(got.m.numpy(), np.asarray(ref.m))
    np.testing.assert_array_equal(got.active.numpy(), np.asarray(ref.active))
    for a, b in zip((got.w, got.r, got.xi2), (ref.w, ref.r, ref.xi2)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("d", [5, 16, 33])
@pytest.mark.parametrize("variant", ["exact", "paper-listing"])
@pytest.mark.parametrize("L", [1, 2, 3, 4, 8])
def test_fit_multiball_matches_the_reference(L, variant, d):
    for seed, n in ((L * 100 + d, 200), (L * 100 + d + 1, 600)):
        X, y = _data(n, d, seed)
        got = fit_multiball(X, y, 10.0, n_balls=L, variant=variant, device="cpu")
        _assert_close(got, _reference(X, y, 10.0, L, variant))


@pytest.mark.parametrize("L", [2, 4])
def test_readouts_match_the_reference(L):
    import jax.numpy as jnp
    from repro.core.multiball import decision_function as jdecision
    from repro.core.multiball import to_single_ball as jto_single_ball

    X, y = _data(500, 12, L)
    ref = _reference(X, y, 10.0, L, "exact")
    got = fit_multiball(X, y, 10.0, n_balls=L, device="cpu")
    one, jone = to_single_ball(got), jto_single_ball(ref)
    assert int(one.m) == int(jone.m)
    for a, b in zip((one.w, one.r, one.xi2), (jone.w, jone.r, jone.xi2)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    for mode in ("merged", "piecewise"):
        np.testing.assert_allclose(decision_function(got, X, mode=mode).numpy(),
                                   np.asarray(jdecision(ref, jnp.asarray(X), mode=mode)),
                                   rtol=1e-4, atol=1e-4)


def test_to_single_ball_folds_only_active_slots():
    """Inactive slots hold zeros; they fold as copies of the first active
    slot with m = 0, so a half-filled state folds to its active balls'."""
    X, y = _data(3, 7, 0)  # 2 scanned rows: slots 0 and 1 (or fewer) of 4 active
    got = fit_multiball(X, y, 10.0, n_balls=4, device="cpu")
    assert not bool(got.active[3])
    one = to_single_ball(got)
    assert int(one.m) == int(got.m[got.active].sum())


def test_one_slot_is_algorithm_1():
    X, y = _data(1500, 8, 0)
    got = fit_multiball(X, y, 10.0, n_balls=1, device="cpu")
    ball = fit(X, y, 10.0, device="cpu")
    assert int(got.m[0]) == int(ball.m)
    np.testing.assert_allclose(got.w[0].numpy(), ball.w.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(got.r[0]), float(ball.r), rtol=1e-5)


@pytest.mark.parametrize("L,d,seed", [(1, 16, 1), (2, 33, 2), (3, 30, 3), (8, 33, 8)])
@pytest.mark.parametrize("stream", ["random", "edges"])
def test_blocked_plain_equals_a_row_loop(L, d, seed, stream, monkeypatch):
    """Bit for bit in every leaf; on the edge stream the updates fall on a
    block's first and last rows, some blocks have none, and with L >= 2
    both merges (B and C) are taken."""
    X, y = (_data(300, d, seed) if stream == "random" else edge_stream(300, d, seed))
    c = 10.0 if stream == "random" else 1e4
    c_inv = float(np.float32(1.0 / c))
    want = _row_loop(X, y, L, c_inv, c_inv)
    seen = _spy_actions(monkeypatch)
    got = _start(torch.as_tensor(X), torch.as_tensor(y), L, c_inv)
    multiball_scan_plain(torch.as_tensor(X[1:]), torch.as_tensor(y[1:]), *got, c_inv, c_inv)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    if L > 1:
        assert any(n == 2 for n, _ in seen), "no pair merge (C) taken"
        assert any(n == 1 and full for n, full in seen), "no point merge (B) taken"


def test_edge_stream_puts_updates_on_block_edges(monkeypatch):
    X, y = edge_stream(300, 33, 2)
    rows = []
    orig = mb_kernel.absorb

    def spy(W, r, xi2, m, act, P, s_row, x, slack0):
        rows.append(x[:33].clone())
        return orig(W, r, xi2, m, act, P, s_row, x, slack0)

    monkeypatch.setattr(mb_kernel, "absorb", spy)
    fit_multiball(X, y, 1e4, n_balls=2, device="cpu")
    yx = torch.as_tensor(y[1:, None] * X[1:])
    pos = [int(torch.nonzero((yx == x).all(1))[0]) for x in rows]
    blocks = {p // BLOCK_ROWS for p in pos}
    assert {2, 4, 6, 8} <= {p // BLOCK_ROWS for p in pos if p % BLOCK_ROWS == 0}
    assert {2, 4, 6, 8} <= {p // BLOCK_ROWS for p in pos if p % BLOCK_ROWS == BLOCK_ROWS - 1}
    assert {3, 5, 7} <= set(range(10)) - blocks


def test_sq_dist_is_the_kernels_order():
    """8 interleaved chains of 4-column pieces, combined by the xor tree;
    padding D to 32 changes nothing."""
    rng = np.random.default_rng(0)
    a = torch.as_tensor(rng.normal(size=(3, 70)).astype(np.float32))
    b = torch.as_tensor(rng.normal(size=(5, 1, 70)).astype(np.float32))
    got = sq_dist(a, b)
    sq = F.pad((a - b) * (a - b), (0, 26)).reshape(5, 3, 3, 8, 4)
    chains = []
    for k in range(8):
        acc = torch.zeros(5, 3)
        for u in range(3):
            for e in range(4):
                acc = acc + sq[:, :, u, k, e]
        chains.append(acc)
    p = chains
    want = ((p[0] + p[4]) + (p[2] + p[6])) + ((p[1] + p[5]) + (p[3] + p[7]))
    assert torch.equal(got, want)
    assert torch.equal(sq_dist(F.pad(a, (0, 26)), F.pad(b, (0, 26))), got)


@pytest.mark.parametrize("L", [2, 4, 8])
def test_full_size_beyond_path_matches_the_reference(L):
    """benchmarks/beyond.py's path: mnist89 (11,800 x 784), C = 10."""
    import jax.numpy as jnp
    from repro.core.multiball import decision_function as jdecision
    from repro.data import load_dataset, preprocess_for

    Xtr, ytr, Xte, yte = load_dataset("mnist89")
    Xtr, Xte = preprocess_for("mnist89", Xtr, Xte)
    ref = _reference(Xtr, ytr, 10.0, L, "exact")
    got = fit_multiball(Xtr, ytr, 10.0, n_balls=L, device="cpu")
    np.testing.assert_array_equal(got.m.numpy(), np.asarray(ref.m))
    np.testing.assert_array_equal(got.active.numpy(), np.asarray(ref.active))
    acc = float((np.sign(decision_function(got, Xte).numpy()) == yte).mean())
    jacc = float((np.sign(np.asarray(jdecision(ref, jnp.asarray(Xte)))) == yte).mean())
    assert acc == jacc


def test_plan_takes_the_first_layout_that_fits():
    # mnist89's width: the grid, one CTA an SM, as many rows as fit.
    plan = multiball_plan(8, 784)
    assert plan["layout"] == "grid" and plan["n_ctas"] == 132 and plan["windows"] is None
    fixed = GRID_HEAD_BYTES + 4 * (9 * 800 + 64 + 40)
    assert plan["rows"] == (SMEM_PER_BLOCK - fixed) // (4 * 808) == 62
    assert sum(plan["smem"].values()) == fixed + 62 * 4 * 808 <= SMEM_PER_BLOCK
    # D = 4,096: the state takes 8 padded centers and the acting row, and 5
    # rows fit beside them.
    assert multiball_plan(8, 4096)["rows"] == 5
    # Every layout a budget reaches, each launched by its own bytes: the
    # grid, then the one-CTA layouts below the grid's bytes for one row.
    for L, d in ((1, 30), (8, 784), (3, 33)):
        plans = multiball_layouts(L, d)
        assert [(p["layout"], p["x_smem"], p["tables_smem"]) for p in plans] == [
            ("grid", True, True), ("cta", False, True), ("cta", False, False)]
        for p in plans:
            assert multiball_plan(L, d, smem_budget=sum(p["smem"].values())) == p
        assert sum(plans[1]["smem"].values()) < sum(grid_smem(d, L, 1).values())
    # Under any budget the last layout runs (the head alone).
    assert multiball_plan(8, 784, smem_budget=0)["smem"] == multiball_smem(
        784, 8, x_smem=False, tables_smem=False)
    # 300 slots: the tables alone pass the card's limit, and the grid's state.
    assert not any(p["tables_smem"] for p in multiball_layouts(300, 16))


def test_grid_plan_rows_and_windows_at_mnist89():
    """11,799 rows on 132 CTAs: as many rows as fit (62 at L = 8, 70 at L =
    1) take 2 windows, evened out to 45 rows a CTA; a budget of 3 rows a CTA
    takes 30 windows of 132 x 3."""
    for L, fit in ((1, 70), (8, 62)):
        assert multiball_plan(L, 784)["rows"] == fit
        plan = multiball_plan(L, 784, n=11_799)
        assert (plan["n_ctas"], plan["rows"], plan["windows"]) == (132, 45, 2)
        assert plan["smem"] == grid_smem(784, L, 45)
        assert plan["smem"]["rows"] == 45 * 4 * (800 + L)
        small = multiball_plan(L, 784, n=11_799, smem_budget=sum(grid_smem(784, L, 3).values()))
        assert (small["layout"], small["rows"], small["windows"]) == ("grid", 3, 30)
        # Forcing a grid by its own bytes gives it back.
        assert multiball_plan(L, 784, n=11_799, smem_budget=sum(plan["smem"].values())) == plan
    # Fewer CTAs: more windows, the rows evened out; fewer rows than CTAs:
    # one row a CTA, one window.
    plan = multiball_plan(8, 784, n=11_799, n_ctas=7)
    assert (plan["rows"], plan["windows"]) == (61, 28)
    assert multiball_plan(2, 784, n=100)["rows"] == 1
    with pytest.raises(ValueError, match="n_ctas"):
        multiball_plan(2, 784, n=100, n_ctas=0)


@pytest.mark.parametrize("L,d,want", [
    (72, 768, [(True, True), (True, False), (False, True), (False, False)]),
    (300, 16, [(True, False), (False, False)]),
    (1, 65_536, [(False, True), (False, False)]),
])
def test_one_cta_layouts_where_the_grid_does_not_fit(L, d, want):
    """The grid needs the state replica and one row; where they pass the
    card's limit, the plan takes the one-CTA layouts as before."""
    assert sum(grid_smem(d, L, 1).values()) > SMEM_PER_BLOCK
    plans = multiball_layouts(L, d, n=11_799)
    assert [(p["layout"], p["x_smem"], p["tables_smem"]) for p in plans] == [
        ("cta",) + xt for xt in want]
    assert plans == [cta_plan(L, d, *xt) for xt in want]
    assert multiball_plan(L, d, n=11_799) == plans[0]


def test_wrapper_validation_and_dispatch():
    X, y = _data(40, 6, 0)
    st = _start(torch.as_tensor(X), torch.as_tensor(y), 3, 0.1)
    with pytest.raises(ValueError, match="w .L, D."):
        multiball_scan(torch.as_tensor(X), torch.as_tensor(y), st[0][:, :5], *st[1:], 0.1, 0.1)
    with pytest.raises(ValueError, match="r must be"):
        multiball_scan(torch.as_tensor(X), torch.as_tensor(y), st[0], st[1][:2], *st[2:], 0.1,
                       0.1)
    with pytest.raises(ValueError, match="cuda or cpu"):
        multiball_scan(torch.as_tensor(X).to("meta"), torch.as_tensor(y), *st, 0.1, 0.1)
    before = multiball_scan.launches
    multiball_scan(torch.as_tensor(X[1:]), torch.as_tensor(y[1:]), *st, 0.1, 0.1)
    assert multiball_scan.launches == before  # a CPU tensor runs the plain version
    with pytest.raises(ValueError, match="variant"):
        fit_multiball(X, y, 1.0, variant="nope", device="cpu")
    with pytest.raises(ValueError, match="n_balls"):
        fit_multiball(X, y, 1.0, n_balls=0, device="cpu")
    assert isinstance(fit_multiball(X, y, 1.0, n_balls=2, device="cpu"), MultiBall)


def test_without_cuda_a_call_without_device_cpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    X, y = _data(40, 6, 0)
    with pytest.raises((RuntimeError, AssertionError)):
        fit_multiball(X, y, 1.0)
