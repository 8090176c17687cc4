"""repro_torch.live — fault-tolerant continuous train->serve loop with drift
repair.

``LiveBank`` closes the trainer/server loop into an always-on system, for
linear Ball banks and kernelized core-set banks (``bank_kind="kernel"``):
see loop.py for the K-sub-bank drift-repair contract, the crash-recovery
protocol and the elastic sharded-training contract (``n_stream_shards=``,
``mesh=`` as SPMD ranks); sources.py for the replayable-chunk-source and
per-shard fault-plan contracts; chaos.py for the seeded kill/fault/remesh
harness that shows crashes and remeshes are invisible.
"""
from .chaos import ChaosSchedule, chaos_reference, chaos_schedule, run_chaos
from .loop import PHASES, LiveBank, LiveStats, run_live_with_restarts
from .sources import ArraySource, FlakySource, ShardFaults, TransientSourceError

__all__ = [
    "ArraySource",
    "ChaosSchedule",
    "FlakySource",
    "LiveBank",
    "LiveStats",
    "PHASES",
    "ShardFaults",
    "TransientSourceError",
    "chaos_reference",
    "chaos_schedule",
    "run_chaos",
]
