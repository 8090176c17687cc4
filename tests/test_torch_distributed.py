"""The port's sharded fits on torch.distributed, gloo ranks on the CPU.

W = 2 and W = 3 ranks are spawned, each with the whole seeded stream; they
join a gloo process group through a file under the test's tmp_path and
build DeviceMeshes over it. Every rank runs the sharded entry points and
saves what it got; the test then holds:

* every rank's result to every other rank's, bit for bit;
* the result to the port's per-range single-process fits of
  ``shard_ranges`` (ragged ranges padded with inert rows), folded by the
  port's ``meb.fold_merge`` / ``fold_kernel_banks`` with dead shards
  skipped, bit for bit;
* the result to the reference's per-range fits folded by
  ``repro.core.meb.fold_merge`` within the engine tolerance (rtol 2e-4,
  atol 2e-5 on weights), with ``m`` exact (no multi-device XLA flag: the
  reference's folds run on one device);
* the result to the reference's own mesh path (``fit_sharded``,
  ``fit_bank_sharded``, ``fit_kernel_bank_sharded`` on a CPU mesh of W
  devices forced by ``XLA_FLAGS``, run in a subprocess): ``m`` and ``idx``
  exact, floats within the engine tolerance (the reference folds the
  kernel bank inside jit, the port eagerly: the last ulp of q / xi2 may
  differ).

JAX is imported inside the tests and the reference's subprocess, so the
spawned ranks import only the port. Each child is joined with a timeout: a
hung rank or reference run fails its test.
"""
import multiprocessing
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.core import (
    Ball,
    fit,
    fit_bank,
    fit_bank_sharded,
    fit_c_grid,
    fit_chunked_many,
    fit_kernel_bank,
    fit_kernel_bank_sharded,
    fit_kernel_bank_shards,
    fit_lookahead,
    fit_sharded,
    fold_kernel_banks,
    fold_merge,
    merge_banks,
    shard_ranges,
    stack_banks,
)
from repro_torch.core.kernel_bank import _fit_kernel_bank

B, D, N, N_EVEN, S = 4, 6, 61, 60, 8
JOIN_S = 240  # a rank that has not finished by then is hung
REFERENCE_S = 300  # the reference's mesh run, JAX's compiles included
TOL = dict(rtol=2e-4, atol=2e-5)  # the engine tolerance
GRID = (0.5, 2.0, 8.0)


def _stream(n=N, seed=0, b=B, d=D):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    y = np.sign(rng.normal(size=n) + X[:, 0]).astype(np.float32)
    y[y == 0] = 1.0
    Y = np.sign(rng.normal(size=(b, n))).astype(np.float32)
    Y[Y == 0] = 1.0
    cs = np.linspace(0.5, 8.0, b).astype(np.float32)
    return X, y, Y, cs


def _leaves(x):
    return [v.detach().cpu().numpy() for v in x]


def _rank_main(rank, world, path):
    """One rank: join the group, run every sharded entry point, save."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{path}/store", rank=rank,
                            world_size=world)
    try:
        mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
        # A second layout of the same ranks: axis "a" has the world's shards,
        # "b" one; ("a", "b") gathers over both axes in turn.
        mesh2 = init_device_mesh("cpu", (world, 1), mesh_dim_names=("a", "b"))
        X, y, Y, cs = _stream()
        Xt, yt, Yt, cst = (torch.from_numpy(v) for v in (X, y, Y, cs))
        out = {}
        out["sharded"] = _leaves(fit_sharded(Xt[:N_EVEN], yt[:N_EVEN], 4.0, mesh))
        out["sharded_la"] = _leaves(fit_sharded(Xt[:N_EVEN], yt[:N_EVEN], 4.0, mesh,
                                                lookahead=3))
        out["bank"] = _leaves(fit_bank_sharded(Xt, Yt, cst, mesh))
        out["bank_la"] = _leaves(fit_bank_sharded(Xt, Yt, cst, mesh, variant="lookahead",
                                                  lookahead=3))
        out["bank_2d"] = _leaves(fit_bank_sharded(Xt, Yt, cst, mesh2, axis=("a", "b")))
        prior = fit_bank(Xt[:20], Yt[:, :20], cst, device="cpu")
        out["bank_prior"] = _leaves(fit_bank_sharded(Xt[20:], Yt[:, 20:], cst, mesh, prior))
        out["c_grid"] = _leaves(fit_c_grid(Xt, yt, torch.tensor(GRID), mesh=mesh))
        # Resume on another shard count: chunk 1 over one shard (axis "b"),
        # chunk 2 over the world's (axis "a").
        first = fit_chunked_many([(Xt[:30], Yt[:, :30])], cst, mesh=mesh2, shard_axis="b")
        out["chunked"] = _leaves(fit_chunked_many([(Xt[30:], Yt[:, 30:])], cst, mesh=mesh2,
                                                  shard_axis="a", resume=first).ball)
        kw = dict(kernel="rbf", gamma=1.0, coreset_size=S, block_n=16)
        out["kbank"] = _leaves(fit_kernel_bank(Xt, Yt, cst, mesh=mesh, **kw))
        out["kbank_fp"] = _leaves(fit_kernel_bank_sharded(Xt, Yt, cst, mesh,
                                                          eviction="farthest-point", **kw))
        out["kshards"] = _leaves(fit_kernel_bank_shards(Xt, Yt, cst, mesh, **kw))
        # 4 rows: over 3 shards the ranges are (0, 2), (2, 4), (4, 4).
        out["dead"] = _leaves(fit_bank_sharded(Xt[:4], Yt[:, :4], cst, mesh))
        out["kdead"] = _leaves(fit_kernel_bank_shards(Xt[:4], Yt[:, :4], cst, mesh, **kw))
        with open(f"{path}/rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _spawn(world, path):
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, world, str(path))) for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_S)
    hung = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    assert not hung, f"ranks {hung} did not finish within {JOIN_S} s"
    assert [p.exitcode for p in procs] == [0] * world, [p.exitcode for p in procs]
    outs = []
    for r in range(world):
        with open(path / f"rank{r}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    return outs


def _padded(X, Y, lo, hi, shard_n):
    pad = shard_n - (hi - lo)
    Xs = F.pad(torch.from_numpy(X[lo:hi]), (0, 0, 0, pad))
    Ys = None if Y is None else F.pad(torch.from_numpy(Y[..., lo:hi]), (0, pad))
    return Xs, Ys


def _ranges(n, world):
    shard_n = -(-n // world)
    return shard_n, [(lo, hi) for lo, hi in shard_ranges(n, world)]


def _fold_bank(X, Y, cs, world, prior=None, **kw):
    """The port's per-range single-process bank fits, folded in order."""
    shard_n, ranges = _ranges(X.shape[0], world)
    banks = [fit_bank(*_padded(X, Y, lo, hi, shard_n), torch.from_numpy(cs), device="cpu", **kw)
             for lo, hi in ranges if lo < hi]
    folded = fold_merge(stack_banks(banks))
    return folded if prior is None else merge_banks(prior, folded)


def _kernel_shards(X, Y, cs, world, **kw):
    shard_n, ranges = _ranges(X.shape[0], world)
    out = []
    for lo, hi in ranges:
        if lo >= hi:
            out.append(None)
            continue
        kb = _fit_kernel_bank(*_padded(X, Y, lo, hi, shard_n), torch.from_numpy(cs), 1.0,
                              variant="exact", s_tile=None, stream_dtype=None, device="cpu", **kw)
        out.append(kb._replace(idx=torch.where(kb.idx >= 0, kb.idx + lo, kb.idx)))
    return out


def _bit_equal(got, want):
    want = _leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _near_reference(got, ref):
    w, r, xi2, m = got
    rw, rr, rxi2, rm = (np.asarray(v) for v in ref)
    np.testing.assert_allclose(w, rw, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(r, rr, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(xi2, rxi2, rtol=1e-3, atol=1e-6)
    np.testing.assert_array_equal(m, rm)


@pytest.fixture(scope="module", params=[2, 3], ids=["W2", "W3"])
def ranks(request, tmp_path_factory):
    world = request.param
    return world, _spawn(world, tmp_path_factory.mktemp(f"gloo{world}"))


def test_every_rank_holds_the_same_bits(ranks):
    world, outs = ranks
    for other in outs[1:]:
        assert other.keys() == outs[0].keys()
        for key in outs[0]:
            for a, b in zip(outs[0][key], other[key]):
                np.testing.assert_array_equal(a, b, err_msg=key)


def test_sharded_single_model_equals_the_folded_ranges(ranks):
    world, outs = ranks
    X, y, _, _ = _stream()
    _, ranges = _ranges(N_EVEN, world)
    for key, la in (("sharded", 1), ("sharded_la", 3)):
        balls = [fit(X[lo:hi], y[lo:hi], 4.0, device="cpu") if la == 1
                 else fit_lookahead(X[lo:hi], y[lo:hi], 4.0, la, device="cpu")
                 for lo, hi in ranges]
        _bit_equal(outs[0][key], fold_merge(Ball(*(torch.stack(v) for v in zip(*balls)))))


@pytest.mark.parametrize("key,kw", [
    ("bank", {}),
    ("bank_la", dict(variant="lookahead", lookahead=3)),
    ("bank_2d", {}),
])
def test_bank_sharded_equals_the_folded_ranges_and_the_reference(ranks, key, kw):
    from repro.core import fit_bank as jfit_bank
    from repro.core.meb import fold_merge as jfold_merge
    import jax.numpy as jnp

    world, outs = ranks
    X, _, Y, cs = _stream()
    _bit_equal(outs[0][key], _fold_bank(X, Y, cs, world, **kw))
    shard_n, ranges = _ranges(N, world)
    refs = [jfit_bank(*(jnp.asarray(v.numpy()) for v in _padded(X, Y, lo, hi, shard_n)),
                      jnp.asarray(cs), **kw) for lo, hi in ranges if lo < hi]
    stacked = type(refs[0])(*(jnp.stack(v) for v in zip(*refs)))
    _near_reference(outs[0][key], jfold_merge(stacked))


# The reference's mesh path on W forced CPU devices: argv path, W, N_EVEN, S;
# reads path/stream.npz, writes path/reference.pkl (leaves as numpy).
_MESH_REFERENCE = r"""
import pickle, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.core import fit_bank_sharded, fit_sharded
from repro.core.distributed import fit_kernel_bank_sharded

path, world, n_even, s = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
data = np.load(f"{path}/stream.npz")
X, y, Y, cs = (jnp.asarray(data[k]) for k in ("X", "y", "Y", "cs"))
assert jax.device_count() == world, jax.devices()
mesh = jax.make_mesh((world,), ("data",))
kw = dict(kernel="rbf", gamma=1.0, coreset_size=s, block_n=16)
out = {
    "sharded": fit_sharded(X[:n_even], y[:n_even], 4.0, mesh),
    "sharded_la": fit_sharded(X[:n_even], y[:n_even], 4.0, mesh, lookahead=3),
    "bank": fit_bank_sharded(X, Y, cs, mesh),
    "bank_la": fit_bank_sharded(X, Y, cs, mesh, variant="lookahead", lookahead=3),
    "kbank": fit_kernel_bank_sharded(X, Y, cs, mesh, **kw),
    "kbank_fp": fit_kernel_bank_sharded(X, Y, cs, mesh, eviction="farthest-point", **kw),
}
with open(f"{path}/reference.pkl", "wb") as f:
    pickle.dump({k: [np.asarray(v) for v in val] for k, val in out.items()}, f)
"""


@pytest.fixture(scope="module")
def mesh_reference(ranks, tmp_path_factory):
    """The reference's sharded fits on its own mesh path, W forced CPU
    devices (W of the ranks), on the same stream."""
    world, _ = ranks
    path = tmp_path_factory.mktemp(f"mesh{world}")
    X, y, Y, cs = _stream()
    np.savez(path / "stream.npz", X=X, y=y, Y=Y, cs=cs)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={world}",
               PYTHONPATH=str(Path(__file__).resolve().parents[1] / "src"))
    run = subprocess.run([sys.executable, "-c", _MESH_REFERENCE, str(path), str(world),
                          str(N_EVEN), str(S)], env=env, capture_output=True, text=True,
                         timeout=REFERENCE_S)
    assert run.returncode == 0, f"stdout:{run.stdout[-2000:]}\nstderr:{run.stderr[-4000:]}"
    with open(path / "reference.pkl", "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("key", ["sharded", "sharded_la", "bank", "bank_la"])
def test_sharded_fits_match_the_references_mesh_path(ranks, mesh_reference, key):
    """fit_sharded (Algorithm 1 and 2) and fit_bank_sharded (B1, B3) on W
    ranks against the reference's shard_map over W devices: m exact, w, r
    and xi2 within the engine tolerance."""
    _, outs = ranks
    (w, r, xi2, m), (rw, rr, rxi2, rm) = outs[0][key], mesh_reference[key]
    np.testing.assert_array_equal(m, rm)
    for got, want in ((w, rw), (r, rr), (xi2, rxi2)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("key", ["kbank", "kbank_fp"])
def test_kernel_bank_sharded_matches_the_references_mesh_path(ranks, mesh_reference, key):
    """fit_kernel_bank_sharded, both evictions, on W ranks against the
    reference's: idx and m exact, coef, points, q, r and xi2 within the
    engine tolerance (the reference folds inside jit)."""
    _, outs = ranks
    got, want = outs[0][key], mesh_reference[key]
    assert len(got) == len(want) == 7
    idx, coef, points, q, r, xi2, m = got
    ridx, rcoef, rpoints, rq, rr, rxi2, rm = want
    np.testing.assert_array_equal(idx, ridx)
    np.testing.assert_array_equal(m, rm)
    for a, b in ((coef, rcoef), (points, rpoints), (q, rq), (r, rr), (xi2, rxi2)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, **TOL)


def test_bank_sharded_folds_a_prior_last(ranks):
    world, outs = ranks
    X, _, Y, cs = _stream()
    prior = fit_bank(X[:20], Y[:, :20], cs, device="cpu")
    _bit_equal(outs[0]["bank_prior"], _fold_bank(X[20:], Y[:, 20:], cs, world, prior=prior))


def test_c_grid_and_a_chunked_resume_on_another_shard_count(ranks):
    world, outs = ranks
    X, y, Y, cs = _stream()
    Yg = np.broadcast_to(y, (len(GRID), N)).copy()
    _bit_equal(outs[0]["c_grid"], _fold_bank(X, Yg, np.asarray(GRID, np.float32), world))
    first = _fold_bank(X[:30], Y[:, :30], cs, 1)
    _bit_equal(outs[0]["chunked"], _fold_bank(X[30:], Y[:, 30:], cs, world, prior=first))


@pytest.mark.parametrize("key,eviction", [("kbank", "smallest-coef"),
                                          ("kbank_fp", "farthest-point")])
def test_kernel_bank_sharded_equals_the_folded_ranges(ranks, key, eviction):
    world, outs = ranks
    X, _, Y, cs = _stream()
    kw = dict(kernel="rbf", coreset_size=S, block_n=16, eviction=eviction)
    shards = [kb for kb in _kernel_shards(X, Y, cs, world, **kw) if kb is not None]
    _bit_equal(outs[0][key], fold_kernel_banks(shards, kernel="rbf", gamma=1.0,
                                                eviction=eviction))


def test_kernel_bank_shards_gather_without_folding(ranks):
    from repro.core import fit_kernel_bank as jfit_kernel_bank
    import jax.numpy as jnp

    world, outs = ranks
    X, _, Y, cs = _stream()
    kw = dict(kernel="rbf", coreset_size=S, block_n=16, eviction="smallest-coef")
    shards = _kernel_shards(X, Y, cs, world, **kw)
    got = outs[0]["kshards"]
    shard_n, ranges = _ranges(N, world)
    for i, (kb, (lo, hi)) in enumerate(zip(shards, ranges)):
        _bit_equal([leaf[i] for leaf in got], kb)
        ref = jfit_kernel_bank(*(jnp.asarray(v.numpy()) for v in _padded(X, Y, lo, hi, shard_n)),
                               jnp.asarray(cs), kernel="rbf", gamma=1.0, coreset_size=S,
                               block_n=16)
        idx = np.asarray(ref.idx)
        np.testing.assert_array_equal(got[0][i], np.where(idx >= 0, idx + lo, idx))
        np.testing.assert_array_equal(got[6][i], np.asarray(ref.m))
        np.testing.assert_allclose(got[1][i], np.asarray(ref.coef), rtol=2e-4, atol=2e-5)


def test_shards_past_the_data_are_skipped(ranks):
    """4 rows: 3 ranks leave the last shard without rows; it fits nothing,
    gathers as an empty kernel bank and stays out of the fold."""
    world, outs = ranks
    X, _, Y, cs = _stream()
    _bit_equal(outs[0]["dead"], _fold_bank(X[:4], Y[:, :4], cs, world))
    kw = dict(kernel="rbf", coreset_size=S, block_n=16, eviction="smallest-coef")
    shards = _kernel_shards(X[:4], Y[:, :4], cs, world, **kw)
    assert (shards[-1] is None) == (world == 3)
    for i, kb in enumerate(shards):
        got = [leaf[i] for leaf in outs[0]["kdead"]]
        if kb is not None:
            _bit_equal(got, kb)
            continue
        np.testing.assert_array_equal(got[0], -1)
        assert not got[1].any() and not got[2].any() and int(got[6].sum()) == 0


def test_shard_ranges_is_the_references():
    from repro.core.distributed import shard_ranges as jshard_ranges

    for n in (0, 1, 4, 7, 61, 100):
        for k in (1, 2, 3, 8):
            assert shard_ranges(n, k) == jshard_ranges(n, k)
    with pytest.raises(ValueError):
        shard_ranges(4, 0)


def test_mesh_must_be_a_device_mesh():
    X, y, Y, cs = _stream()
    for call in (lambda: fit_sharded(X, y, 1.0, object(), device="cpu"),
                 lambda: fit_bank_sharded(X, Y, cs, "data", device="cpu"),
                 lambda: fit_kernel_bank_shards(X, Y, cs, None, device="cpu")):
        with pytest.raises(TypeError, match="DeviceMesh"):
            call()
