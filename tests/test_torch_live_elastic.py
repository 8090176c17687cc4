"""The port's elastic live loop (``n_stream_shards``, ``mesh=``) on the CPU.

* Per-range (no mesh), against the reference's per-range path under a
  ``ShardFaults`` plan with a lost shard, a straggler, a flaky shard and a
  poisoned shard: ``rows_lost``, ``ranges_reissued`` and the other durable
  stats equal, the banks within the engine tolerance (rtol 2e-4, atol 2e-5)
  with ``m`` and ``idx`` exact.
* Port against port, bit for bit: the hand-built per-range referent, ragged
  chunks, crashes, the shard faults, ``run_chaos`` against
  ``chaos_reference``, and the adoption of the checkpoint's shard count.
* 2 gloo ranks spawned on the CPU run the loop SPMD over a DeviceMesh: every
  rank holds the same bits, the mesh path equals the per-range path bit for
  bit, and a run killed on the 2 ranks resumes without a mesh bit-exactly,
  with ``remeshes == 1``.
"""
import multiprocessing
import pickle

import numpy as np
import pytest
import torch

from repro_torch.core import (
    fit_bank,
    fit_kernel_bank,
    fold_kernel_banks,
    fold_merge,
    merge_banks,
    merge_kernel_banks,
    shard_ranges,
    stack_banks,
)
from repro_torch.live import (
    ArraySource,
    ShardFaults,
    chaos_reference,
    chaos_schedule,
    run_chaos,
    run_live_with_restarts,
)
from repro_torch.runtime import InjectedFailure, StragglerPolicy
from test_torch_live_loop import (  # the sizes, stream and loop factory of the single-shard tests
    BANK_KINDS,
    CHUNK,
    CS,
    KERNEL_KW,
    N_CHUNKS,
    TOL,
    _bank_eq,
    _kw,
    _make,
    _served_scores,
    _stream,
)

_NOSLEEP = lambda s: None
JOIN_S = 240  # a rank that has not finished by then is hung
KILL = ("post_train", 5)  # where the 2-rank run is killed


def _elastic_referent(X, Y, kind, n_shards, drop=None):
    """K = 1 elastic referent: each chunk's ``shard_ranges`` fit fresh, fold
    in ascending order, and the prior merges in last; ``drop`` maps a chunk
    to shard ids whose range is masked out. The stream offset advances by
    the full chunk."""
    drop = drop or {}
    merge_kw = dict(kernel="rbf", gamma=KERNEL_KW["gamma"])
    cs = torch.from_numpy(CS)
    ref, rows = None, 0
    for i in range(-(-X.shape[0] // CHUNK)):
        Xc = torch.from_numpy(X[i * CHUNK:(i + 1) * CHUNK])
        Yc = torch.from_numpy(Y[:, i * CHUNK:(i + 1) * CHUNK])
        n = int(Xc.shape[0])
        banks = []
        for j, (lo, hi) in enumerate(shard_ranges(n, n_shards)):
            if lo >= hi or j in drop.get(i, ()):
                continue
            if kind == "kernel":
                b = fit_kernel_bank(Xc[lo:hi], Yc[:, lo:hi], cs, kernel="rbf",
                                    gamma=KERNEL_KW["gamma"],
                                    coreset_size=KERNEL_KW["coreset_size"],
                                    block_n=KERNEL_KW["block_n"], seed_check=False)
                b = b._replace(idx=torch.where(b.idx >= 0, b.idx + lo, b.idx))
            else:
                b = fit_bank(Xc[lo:hi], Yc[:, lo:hi], cs, None)
            banks.append(b)
        if banks:
            if kind == "kernel":
                folded = fold_kernel_banks(banks, **merge_kw)
                folded = folded._replace(
                    idx=torch.where(folded.idx >= 0, folded.idx + rows, folded.idx))
                ref = folded if ref is None else merge_kernel_banks(ref, folded, **merge_kw)
            else:
                folded = banks[0] if len(banks) == 1 else fold_merge(stack_banks(banks))
                ref = folded if ref is None else merge_banks(ref, folded)
        rows += n
    return ref


# ---------------------------------------------------------------------------
# per-range, against the reference
# ---------------------------------------------------------------------------

FAULTS = dict(lost={2: (1,)}, slow={5: (1.0, 1.0, 10.0)}, flaky={(3, 0): 2, (7, 2): -1})


@pytest.mark.parametrize("kind", BANK_KINDS)
def test_per_range_faults_match_the_reference(tmp_path, kind):
    import jax.numpy as jnp
    from repro.live import ArraySource as RefArraySource
    from repro.live import LiveBank as RefLiveBank
    from repro.live import ShardFaults as RefShardFaults
    from repro.runtime import StragglerPolicy as RefStragglerPolicy

    X, Y = _stream()
    ref = RefLiveBank(RefArraySource(X, Y, CHUNK), jnp.asarray(CS), ckpt_dir=str(tmp_path / "r"),
                      bank_kind=kind, n_stream_shards=3, shard_faults=RefShardFaults(**FAULTS),
                      straggler_policy=RefStragglerPolicy(), **_kw(kind, {}))
    ref_stats = ref.run()
    live = _make(ArraySource(X, Y, CHUNK), tmp_path / "p", bank_kind=kind, n_stream_shards=3,
                 shard_faults=ShardFaults(**FAULTS), straggler_policy=StragglerPolicy())
    stats = live.run()
    assert stats.rows_lost == ref_stats.rows_lost == 10  # the poisoned shard's range
    assert stats.ranges_reissued == ref_stats.ranges_reissued == 2
    assert stats.shard_retries == ref_stats.shard_retries == 4
    got, want = stats.durable(), ref_stats.durable()
    mass, ref_mass = got.pop("merge_dropped_mass"), want.pop("merge_dropped_mass")
    assert got == want
    assert mass == pytest.approx(ref_mass, rel=TOL["rtol"], abs=TOL["atol"])
    for name, x, y in zip(live.serving_bank()._fields, live.serving_bank(), ref.serving_bank()):
        y = np.asarray(y)
        if np.issubdtype(y.dtype, np.integer):
            np.testing.assert_array_equal(x.numpy(), y, err_msg=name)
        else:
            np.testing.assert_allclose(x.numpy(), y, err_msg=name, **TOL)


# ---------------------------------------------------------------------------
# per-range, port against port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_shards,n_rows", [(4, N_CHUNKS * CHUNK), (5, 3 * CHUNK + 7)])
@pytest.mark.parametrize("kind", BANK_KINDS)
def test_elastic_matches_per_range_referent(tmp_path, kind, n_shards, n_rows):
    """Each chunk is n_shards fresh range fits folded ascending, the prior
    merged last, bit for bit; a ragged 7-row last chunk over 5 shards has
    ranges (2, 2, 2, 1) and an empty tail shard."""
    X, Y = _stream()
    X, Y = X[:n_rows], Y[:, :n_rows]
    live = _make(ArraySource(X, Y, CHUNK), tmp_path / "c", bank_kind=kind, n_sub_banks=1,
                 rotate_every=10**9, swap_every=1, n_stream_shards=n_shards)
    stats = live.run()
    assert _bank_eq(live.serving_bank(), _elastic_referent(X, Y, kind, n_shards))
    assert stats.rows_ingested == n_rows
    assert stats.rows_lost == stats.ranges_reissued == 0


@pytest.mark.parametrize("kind", BANK_KINDS)
def test_elastic_crash_equivalence(tmp_path, kind):
    X, Y = _stream()
    clean = _make(ArraySource(X, Y, CHUNK), tmp_path / "a", bank_kind=kind, n_stream_shards=3)
    ref_stats = clean.run()
    crashy = _make(ArraySource(X, Y, CHUNK), tmp_path / "b", bank_kind=kind, n_stream_shards=3,
                   failpoints=[("fetch", 1), ("post_train", 3), ("mid_checkpoint", 5),
                               ("post_swap", 7)])
    stats = run_live_with_restarts(crashy, sleep=_NOSLEEP)
    assert stats.restarts == 4
    assert _bank_eq(crashy.serving_bank(), clean.serving_bank())
    assert torch.equal(_served_scores(crashy.serving_bank()), _served_scores(clean.serving_bank()))
    assert stats.durable() == ref_stats.durable()


@pytest.mark.parametrize("kind", BANK_KINDS)
def test_flaky_shard_within_budget_invisible(tmp_path, kind):
    X, Y = _stream()
    clean = _make(ArraySource(X, Y, CHUNK), tmp_path / "a", bank_kind=kind, n_stream_shards=3)
    ref_stats = clean.run()
    faulty = _make(ArraySource(X, Y, CHUNK), tmp_path / "b", bank_kind=kind, n_stream_shards=3,
                   shard_faults=ShardFaults(flaky={(1, 0): 2}))
    stats = faulty.run()
    assert _bank_eq(faulty.serving_bank(), clean.serving_bank())
    assert stats.shard_retries == 2
    assert stats.rows_lost == 0 and stats.ranges_reissued == 0
    assert stats.durable() == ref_stats.durable()


@pytest.mark.parametrize("kind", BANK_KINDS)
def test_lost_and_straggler_reissue_deterministic(tmp_path, kind):
    X, Y = _stream()

    def make(name, **kw):
        return _make(ArraySource(X, Y, CHUNK), tmp_path / name, bank_kind=kind,
                     n_stream_shards=3,
                     shard_faults=ShardFaults(lost={2: (1,)}, slow={5: (1.0, 1.0, 10.0)}),
                     straggler_policy=StragglerPolicy(), **kw)

    smooth = make("a")
    ref_stats = smooth.run()
    assert ref_stats.ranges_reissued == 2
    assert ref_stats.rows_lost == 0 and ref_stats.shard_ranges_lost == 0
    crashy = make("b", failpoints=[("post_train", 2), ("fetch", 5)])
    stats = run_live_with_restarts(crashy, sleep=_NOSLEEP)
    assert stats.restarts == 2
    assert _bank_eq(crashy.serving_bank(), smooth.serving_bank())
    assert stats.durable() == ref_stats.durable()


@pytest.mark.parametrize("kind", BANK_KINDS)
def test_poison_shard_masked_with_loss_recorded(tmp_path, kind):
    X, Y = _stream()
    live = _make(ArraySource(X, Y, CHUNK), tmp_path / "c", bank_kind=kind, n_sub_banks=1,
                 rotate_every=10**9, swap_every=1, n_stream_shards=4,
                 shard_faults=ShardFaults(flaky={(2, 1): ShardFaults.POISON}))
    stats = live.run()
    assert stats.rows_lost == CHUNK // 4 and stats.shard_ranges_lost == 1
    assert stats.shard_retries == 2
    assert stats.rows_ingested == N_CHUNKS * CHUNK
    assert _bank_eq(live.serving_bank(), _elastic_referent(X, Y, kind, 4, drop={2: {1}}))


def test_all_shards_dead_chunk_masked(tmp_path):
    X, Y = _stream()
    live = _make(ArraySource(X, Y, CHUNK), tmp_path / "c", n_sub_banks=1, rotate_every=10**9,
                 swap_every=1, n_stream_shards=3, shard_faults=ShardFaults(lost={1: (0, 1, 2)}))
    stats = live.run()
    assert stats.rows_lost == CHUNK and stats.shard_ranges_lost == 3
    assert stats.ranges_reissued == 0
    assert _bank_eq(live.serving_bank(),
                    _elastic_referent(X, Y, "linear", 3, drop={1: {0, 1, 2}}))


def test_resume_adopts_checkpoint_shards_rejects_explicit_mismatch(tmp_path):
    X, Y = _stream()
    _make(ArraySource(X, Y, CHUNK), tmp_path / "c", n_stream_shards=3).run(max_chunks=4)
    with pytest.raises(ValueError, match="n_stream_shards=3"):
        _make(ArraySource(X, Y, CHUNK), tmp_path / "c", n_stream_shards=2).run()
    resumed = _make(ArraySource(X, Y, CHUNK), tmp_path / "c")
    stats = resumed.run()
    assert resumed.n_stream_shards == 3 and stats.remeshes == 0
    clean = _make(ArraySource(X, Y, CHUNK), tmp_path / "ref", n_stream_shards=3)
    ref_stats = clean.run()
    assert _bank_eq(resumed.serving_bank(), clean.serving_bank())
    assert stats.durable() == ref_stats.durable()


def _chaos_make_live(X, Y, kind, base_dir, name, n_shards):
    def make_live(mesh, failpoints, faults):
        return _make(ArraySource(X, Y, CHUNK), base_dir / name, bank_kind=kind, mesh=mesh,
                     n_stream_shards=n_shards, shard_faults=faults, failpoints=failpoints,
                     straggler_policy=StragglerPolicy())
    return make_live


@pytest.mark.parametrize("seed,kill_phases", [(11, ("fetch", "post_train")), (41, None)])
@pytest.mark.parametrize("kind", BANK_KINDS)
def test_chaos_without_mesh_bit_exact(tmp_path, kind, seed, kill_phases):
    """Seeded kills and shard faults over a 4-shard stream, no mesh: the
    recovered bank, served scores and durable stats equal the crash-free
    reference's bit for bit (seed 41 draws its kills from every phase:
    mid_checkpoint and post_swap, each on a chunk where it fires)."""
    X, Y = _stream()
    kw = {} if kill_phases is None else {"kill_phases": kill_phases}
    sched = chaos_schedule(seed, n_chunks=N_CHUNKS, n_shards=4, kills=3, lost_chunks=1,
                           flaky_chunks=1, poison_chunks=1, slow_chunks=1, **kw)
    chaos = run_chaos(_chaos_make_live(X, Y, kind, tmp_path, "chaos", 4), sched)
    ref = chaos_reference(_chaos_make_live(X, Y, kind, tmp_path, "ref", 4), sched)
    assert chaos.stats.restarts == 3
    assert _bank_eq(chaos.serving_bank(), ref.serving_bank())
    assert torch.equal(_served_scores(chaos.serving_bank()), _served_scores(ref.serving_bank()))
    assert chaos.stats.durable() == ref.stats.durable()
    assert chaos.stats.rows_lost > 0


def test_chaos_schedule_matches_the_reference():
    from repro.live import chaos_schedule as ref_schedule

    for seed in (0, 5, 11):
        kw = dict(n_chunks=12, n_shards=4, kills=4)
        got, want = chaos_schedule(seed, **kw), ref_schedule(seed, **kw)
        assert (got.kills, got.lost, got.flaky, got.slow) == (want.kills, want.lost, want.flaky,
                                                              want.slow)
    with pytest.raises(ValueError, match="n_shards >= 2"):
        chaos_schedule(0, n_chunks=4, n_shards=1)


# ---------------------------------------------------------------------------
# SPMD over a DeviceMesh: 2 gloo ranks
# ---------------------------------------------------------------------------


def _leaves(bank):
    return [v.numpy() for v in bank]


def _rank_main(rank, world, path):
    """One rank: join the group, run the clean loop on the mesh and the loop
    killed at KILL, for both bank kinds; save what each rank holds."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{path}/store", rank=rank,
                            world_size=world)
    try:
        mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
        X, Y = _stream()
        out = {}
        for kind in BANK_KINDS:
            live = _make(ArraySource(X, Y, CHUNK), f"{path}/{kind}_mesh", bank_kind=kind,
                         mesh=mesh)
            stats = live.run()
            out[kind, "mesh"] = (_leaves(live.serving_bank()), stats.durable(),
                                 live.n_stream_shards)
            live = _make(ArraySource(X, Y, CHUNK), f"{path}/{kind}_kill", bank_kind=kind,
                         mesh=mesh, failpoints=[KILL])
            try:
                live.run()
            except InjectedFailure:
                out[kind, "killed"] = (_leaves(live.serving_bank()), live.chunk_idx)
        with open(f"{path}/rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    path = tmp_path_factory.mktemp("mesh")
    world = 2
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
    assert [p.exitcode for p in procs] == [0] * world
    outs = []
    for r in range(world):
        with open(path / f"rank{r}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    return path, outs


@pytest.mark.parametrize("kind", BANK_KINDS)
def test_mesh_ranks_equal_the_per_range_path(tmp_path, mesh_runs, kind):
    """Every rank of the SPMD loop holds the same bits, and they are the
    per-range path's (n_stream_shards=2, no mesh) bank and durable stats."""
    _, outs = mesh_runs
    leaves, stats, shards = outs[0][kind, "mesh"]
    assert shards == 2
    for other in outs[1:]:
        o_leaves, o_stats, _ = other[kind, "mesh"]
        assert all(np.array_equal(a, b) for a, b in zip(leaves, o_leaves))
        assert o_stats == stats
    X, Y = _stream()
    ref = _make(ArraySource(X, Y, CHUNK), tmp_path / "ref", bank_kind=kind, n_stream_shards=2)
    ref_stats = ref.run()
    assert all(np.array_equal(a, b) for a, b in zip(leaves, _leaves(ref.serving_bank())))
    assert stats == ref_stats.durable()


@pytest.mark.parametrize("kind", BANK_KINDS)
def test_kill_on_two_ranks_then_resume_without_a_mesh(tmp_path, mesh_runs, kind):
    """A run killed on both ranks at KILL resumes in one process with no
    mesh, adopting the checkpoint's 2 logical shards: bit-identical to the
    clean per-range run, with one remesh counted."""
    path, outs = mesh_runs
    killed = [o[kind, "killed"] for o in outs]
    assert all(k[1] == KILL[1] for k in killed)
    assert all(np.array_equal(a, b) for a, b in zip(killed[0][0], killed[1][0]))
    X, Y = _stream()
    resumed = _make(ArraySource(X, Y, CHUNK), path / f"{kind}_kill", bank_kind=kind)
    stats = resumed.run()
    assert resumed.n_stream_shards == 2 and stats.remeshes == 1
    ref = _make(ArraySource(X, Y, CHUNK), tmp_path / "ref", bank_kind=kind, n_stream_shards=2)
    ref_stats = ref.run()
    assert _bank_eq(resumed.serving_bank(), ref.serving_bank())
    assert torch.equal(_served_scores(resumed.serving_bank()), _served_scores(ref.serving_bank()))
    assert stats.durable() == ref_stats.durable()
