"""Chaos harness for the elastic live loop — seeded fault schedules + runner.

``chaos_schedule(seed, ...)`` draws one deterministic schedule of everything
that can go wrong around a LiveBank:

  - process KILLS: ``(phase, chunk)`` failpoints raising ``InjectedFailure``
    at the loop's phase boundaries (including the torn-tmp
    ``mid_checkpoint`` crash);
  - per-shard fetch faults: device-loss (``lost``), transient (``flaky``),
    poison, and straggler (``slow``) plans packaged as a
    ``sources.ShardFaults``;

and ``run_chaos`` drives a loop through it, relaunching after every kill and
switching to the next mesh in ``meshes`` on relaunch (remesh-on-restart:
e.g. a mesh of 2 ranks, then none).

The chaos CONTRACT, held for both bank kinds: kills and remeshes are
INVISIBLE. The final bank, served scores and
durable LiveStats of the chaos run are bit-identical (f32) to
``chaos_reference`` — the same stream and the same ShardFaults plan, but no
kills and a single (or no) mesh. Shard faults themselves are structural
(they decide which ranges train and how work is re-issued), so they appear
identically in both runs; what chaos adds on top must change nothing.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Set, Tuple

import numpy as np

from ..runtime.fault_tolerance import InjectedFailure
from .loop import PHASES, LiveBank
from .sources import ShardFaults

# a LiveBank factory: make_live(mesh, failpoints, shard_faults) -> LiveBank.
# Every call must address the same stream and the same ckpt_dir; run_chaos
# passes the SHARED failpoint set (kills fire once per run, not per process)
# and the shared ShardFaults instance (attempt counters span relaunches).
MakeLive = Callable[[object, Set[Tuple[str, int]], ShardFaults], LiveBank]


@dataclasses.dataclass(frozen=True)
class ChaosSchedule:
    """One seeded draw of kills + shard faults (see ``chaos_schedule``)."""

    seed: int
    kills: Tuple[Tuple[str, int], ...]
    lost: Dict[int, Tuple[int, ...]]
    flaky: Dict[Tuple[int, int], int]
    slow: Dict[int, Tuple[float, ...]]

    def shard_faults(self) -> ShardFaults:
        """A FRESH ShardFaults over this schedule's plans (attempt counters
        zeroed) — build one per RUN: the chaos run and its reference each
        get their own, while relaunches within a run share run_chaos's."""
        return ShardFaults(lost=self.lost, flaky=self.flaky, slow=self.slow)


def chaos_schedule(
    seed: int,
    *,
    n_chunks: int,
    n_shards: int,
    kills: int = 4,
    kill_phases: Sequence[str] = PHASES,
    lost_chunks: int = 2,
    flaky_chunks: int = 2,
    poison_chunks: int = 1,
    slow_chunks: int = 1,
    flaky_budget: int = 2,
) -> ChaosSchedule:
    """Draw a deterministic chaos schedule from ``seed``.

    ``kills`` distinct (phase, chunk) process kills; ``lost_chunks`` chunks
    each lose 1..n_shards-1 devices (never all — rebalance needs a
    survivor); ``flaky_chunks`` chunks get one shard failing 1..flaky_budget
    times before delivering (keep ``flaky_budget`` <= the loop's shard
    retry budget or the fault decays into a poison — the replay-stability
    caveat of ``ShardFaults``); ``poison_chunks`` chunks get one shard
    failing forever (masked out past the budget); ``slow_chunks`` chunks get
    a 10x straggler in their per-shard heartbeat times. Fault categories
    land on DISTINCT chunks so each outcome is independently attributable.
    """
    if n_shards < 2:
        raise ValueError(
            f"chaos_schedule needs n_shards >= 2 (lost/straggler shards "
            f"must leave a survivor): got {n_shards}"
        )
    n_fault_chunks = lost_chunks + flaky_chunks + poison_chunks + slow_chunks
    if n_fault_chunks > n_chunks:
        raise ValueError(
            f"{n_fault_chunks} fault chunks requested but the stream has "
            f"only {n_chunks}"
        )
    rng = np.random.default_rng(seed)

    kill_set: Set[Tuple[str, int]] = set()
    while len(kill_set) < kills:
        kill_set.add((
            str(rng.choice(list(kill_phases))),
            int(rng.integers(0, n_chunks)),
        ))

    fault_chunks = rng.choice(n_chunks, size=n_fault_chunks, replace=False)
    cursor = 0

    lost: Dict[int, Tuple[int, ...]] = {}
    for c in fault_chunks[cursor:cursor + lost_chunks]:
        k = int(rng.integers(1, n_shards))  # 1 .. n_shards-1 lost
        shards = rng.choice(n_shards, size=k, replace=False)
        lost[int(c)] = tuple(int(j) for j in sorted(shards))
    cursor += lost_chunks

    flaky: Dict[Tuple[int, int], int] = {}
    for c in fault_chunks[cursor:cursor + flaky_chunks]:
        shard = int(rng.integers(0, n_shards))
        flaky[(int(c), shard)] = int(rng.integers(1, flaky_budget + 1))
    cursor += flaky_chunks

    for c in fault_chunks[cursor:cursor + poison_chunks]:
        shard = int(rng.integers(0, n_shards))
        flaky[(int(c), shard)] = ShardFaults.POISON
    cursor += poison_chunks

    slow: Dict[int, Tuple[float, ...]] = {}
    for c in fault_chunks[cursor:cursor + slow_chunks]:
        times = rng.uniform(0.8, 1.2, size=n_shards)
        times[int(rng.integers(0, n_shards))] *= 10.0  # one clear straggler
        slow[int(c)] = tuple(float(t) for t in times)

    return ChaosSchedule(
        seed=int(seed), kills=tuple(sorted(kill_set)),
        lost=lost, flaky=flaky, slow=slow,
    )


def run_chaos(
    make_live: MakeLive,
    schedule: ChaosSchedule,
    *,
    meshes: Sequence[object] = (None,),
    max_chunks: Optional[int] = None,
) -> LiveBank:
    """Drive ``make_live`` through ``schedule`` to completion.

    Every kill crashes ``run()`` with an InjectedFailure; run_chaos then
    relaunches — resuming from the last durable StreamCheckpoint — on the
    NEXT mesh in ``meshes`` (the last mesh repeats once the list is
    exhausted: a run under ``meshes=(mesh8, mesh4, None)`` executes the
    8 -> 4 -> single-device elastic schedule). The failpoint set and
    ShardFaults instance are shared across relaunches, so each kill fires
    exactly once and per-shard attempt counters span processes, exactly
    like a real fleet. Returns the final LiveBank after a clean run.
    """
    faults = schedule.shard_faults()
    failpoints: Set[Tuple[str, int]] = set(schedule.kills)
    meshes = list(meshes) or [None]
    mesh_i = 0
    live = make_live(meshes[mesh_i], failpoints, faults)
    fired = 0
    while True:
        try:
            live.run(max_chunks=max_chunks)
            return live
        except InjectedFailure:
            fired += 1
            if fired > len(schedule.kills):
                raise  # a failpoint re-fired: the shared-set contract broke
            restarts = live.stats.restarts + 1
            if mesh_i + 1 < len(meshes):
                mesh_i += 1  # remesh-on-restart
                live = make_live(meshes[mesh_i], failpoints, faults)
            live.stats.restarts = restarts


def chaos_reference(
    make_live: MakeLive,
    schedule: ChaosSchedule,
    *,
    mesh: object = None,
    max_chunks: Optional[int] = None,
) -> LiveBank:
    """The crash-free referent: the SAME shard-fault plan, NO kills, one
    mesh (default none — pure per-range execution). Point ``make_live`` at
    a separate ckpt_dir from the chaos run's."""
    live = make_live(mesh, set(), schedule.shard_faults())
    live.run(max_chunks=max_chunks)
    return live
