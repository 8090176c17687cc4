"""LiveBank — the always-on ingest -> train -> fold -> hot-swap loop.

Closes the loop between the one-pass trainer (``core.fit_bank``, kernel B1,
or B6 with ``bank_resident="hbm"``) and the serving engine
(``serve.BankServer``, kernel B2): consume an unbounded stream of
``(X_chunk, y_chunk)`` chunks, train each into the active sub-bank, fold
the sub-banks with the bank-wide Sec-4.3 merge, and hot-swap the merged
bank into a running server on a cadence: checkpointed, restartable, and
drift-repairing.

``bank_kind="kernel"`` runs the same loop in RKHS: chunks train through
``core.fit_kernel_bank`` (kernels B5 and R1) into bounded (B, S) core-set
sub-banks, each arriving chunk Sec-4.3-merges into the active slot's prior
state (``merge_kernel_banks``: exact while the live slots fit S, then a
lossy top-k re-compression whose dropped |coef| mass is audited in
``LiveStats.merge_dropped_mass``), retirement re-merges kernel epochs, and
the serving fold goes through ``fold_kernel_banks`` over the live slots,
oldest first; the server scores it through B5. Everything else (cadences,
checkpoints, crash equivalence) does not depend on the bank kind.

K-sub-bank drift-repair contract
--------------------------------
A single greedy ball absorbs every point into an ever-growing radius, so
early data shapes the center forever and late drift is diluted. The repair
keeps a small cover of balls instead of one:

  - the stream is cut into epochs of ``rotate_every`` chunks; each epoch
    trains its own fresh sub-bank;
  - the serving bank is the Sec-4.3 fold of the <= K live sub-banks,
    oldest first (``core.fold_banks``), exact in the augmented space
    because epochs touch disjoint examples;
  - when all K slots are full, the oldest sub-bank is retired:
    ``retire="merge"`` re-merges the two oldest into one (no example's
    influence is dropped), ``retire="drop"`` forgets the oldest epoch
    (bounded memory of the last ~K * rotate_every chunks).

Fault tolerance
---------------
Every fold commits an atomic checkpoint (``checkpoint/ckpt.py``: a crash at
any instant leaves the previous or the new checkpoint, never a torn mix).
``run()`` always resumes from the last durable checkpoint, and the source
is addressed by absolute chunk index (``sources.py``), so a crash at any
phase boundary replays to a bit-identical bank: train, fold and swap are
pure functions of (checkpoint state, chunk index), and every step of them
repeats its bits run to run, on the CPU and on the card (the kernels have
no atomics; the folds are element-wise, batched products and a stable
sort). Flaky fetches retry under a ``runtime.RetryPolicy``; chunks that
exhaust the budget are quarantined (recorded, skipped). An attached
``BankServer`` keeps answering with the last good bank while the trainer
crashes and recovers, and ``LiveStats.bank_age_chunks`` says how stale it
is. The checkpoint format is the JAX package's (same meta keys, same leaf
order), so either package resumes from the other's live checkpoints.

Elastic sharded training
------------------------
``n_stream_shards`` is the LOGICAL shard count, durable in every
checkpoint: each chunk is ceil-split into that many contiguous ranges
(``core.shard_ranges``), each range fits fresh, the fits fold in
ascending-range order through the eager Sec-4.3 merges, and the active
slot's prior state merges in last. That structure never depends on where
the fits run:

  - without a mesh (the main path), one process fits the ranges one after
    another. Lost or straggling shards have their ranges re-issued to the
    survivors (``runtime.rebalance_ranges``, counted in
    ``ranges_reissued``); a shard whose fetch faults exhaust the per-shard
    retry budget is masked out, its rows recorded in ``rows_lost`` /
    ``shard_ranges_lost``;
  - with ``mesh=`` (a ``torch.distributed`` DeviceMesh) the loop runs SPMD:
    every rank of the default process group runs the same loop over the
    same source. A clean chunk whose logical shard count equals the mesh's
    shard count is one sharded fit (``core.fit_bank_sharded`` for linear,
    ``core.fit_kernel_bank_shards`` for kernel: each rank fits its range
    and the fits are gathered); any other chunk runs the per-range path
    whole on every rank, with no communication. Both give the same bits on
    every rank. Rank 0 alone writes the checkpoints, with a barrier after
    each commit (and after each resume) so that no rank runs ahead of a
    durable state, and rank 0 alone owns the server.

A checkpoint restores onto this process's device (``ckpt.restore(device=)``)
whatever layout wrote it; a resumed loop that did not set
``n_stream_shards`` adopts the checkpoint's, which makes a resume on another
mesh, or on none, bit-exact (``remeshes`` counts such resumes). The chaos
harness (``chaos.py``) drives kills, shard faults and remeshes and holds
the result to the crash-free run bit for bit.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from .._device import as_tensor, pick_device
from ..checkpoint import ckpt
from ..core.distributed import (
    _mesh_groups,
    fit_bank_sharded,
    fit_kernel_bank_shards,
    shard_ranges,
)
from ..core.kernel_bank import KernelBank, fit_kernel_bank
from ..core.meb import (
    Ball,
    fold_banks,
    fold_kernel_banks,
    fold_merge,
    merge_banks,
    merge_kernel_banks,
    nonfinite_rows,
    stack_banks,
)
from ..core.multiball import fit_bank
from ..runtime.fault_tolerance import (
    DeviceLostError,
    InjectedFailure,
    RetryPolicy,
    StragglerPolicy,
    default_live_retryable,
    rebalance_ranges,
    runtime_device_errors,
)
from .sources import TransientSourceError

# _fetch() sentinels: stream exhausted / chunk abandoned after retries
_END = object()
_QUARANTINED = object()
# "server has no kernel attribute" sentinel for duck-typed swap targets
_NO_KERNEL_ATTR = object()

PHASES = (
    "fetch", "post_train", "post_rotate", "post_fold", "post_swap",
    "mid_checkpoint", "post_checkpoint",
)


@dataclasses.dataclass
class LiveStats:
    """Trainer-side staleness/health surface, mirroring serve.ServerStats.

    Durable counters (restored from the checkpoint on restart, so a crashy
    run's final accounting matches the uninterrupted run's): chunks/rows
    ingested, folds, swaps, rotations, retirements, checkpoints, the
    quarantined chunk ids, ``last_swap_chunk``, and, for kernelized loops,
    ``merge_dropped_mass``: the total |coef| mass every 2S->S kernel-merge
    re-compression has discarded (chunk continuation merges, retire merges
    and counted serving folds; exactly 0.0 while the live slots always fit
    S).

    The elastic loop adds durable loss/repair accounting, derived from the
    deterministic shard-fault plan, so a crash replay re-derives it:

    ``rows_lost``          stream rows masked out because their shard's
                           fetch faults exhausted the shard retry budget.
    ``shard_ranges_lost``  how many assigned ranges those rows spanned.
    ``ranges_reissued``    lost/straggler shard ranges re-issued to
                           survivors via ``runtime.rebalance_ranges``.
    ``folds_quarantined``  serving folds refused by the non-finite publish
                           guard (NaN/Inf model rows): the server kept the
                           last good bank.

    Volatile counters (facts about this process's life, never restored):
    ``restarts``, ``retries``, ``shard_retries`` (per-shard fetch retries
    burned), and ``remeshes`` (resumes whose mesh differed from the mesh
    that wrote the checkpoint). ``bank_age_chunks`` is the staleness
    signal: chunks ingested since the served bank was last swapped.
    """

    chunks_ingested: int = 0
    rows_ingested: int = 0
    folds: int = 0
    swaps: int = 0
    rotations: int = 0
    retirements: int = 0
    checkpoints: int = 0
    quarantined: List[int] = dataclasses.field(default_factory=list)
    last_swap_chunk: int = -1
    merge_dropped_mass: float = 0.0
    rows_lost: int = 0
    shard_ranges_lost: int = 0
    ranges_reissued: int = 0
    folds_quarantined: int = 0
    bank_age_chunks: int = 0
    restarts: int = 0
    retries: int = 0
    shard_retries: int = 0
    remeshes: int = 0

    _DURABLE = (
        "chunks_ingested", "rows_ingested", "folds", "swaps", "rotations",
        "retirements", "checkpoints", "quarantined", "last_swap_chunk",
        "merge_dropped_mass", "rows_lost", "shard_ranges_lost",
        "ranges_reissued", "folds_quarantined",
    )

    def durable(self) -> dict:
        return {k: getattr(self, k) for k in self._DURABLE}

    def load_durable(self, d: dict) -> None:
        for k in self._DURABLE:
            if k in d:
                setattr(self, k, d[k])


def _lift_ids(bank: KernelBank, offset: int) -> KernelBank:
    """Core-set ids shifted by ``offset`` (free slots, -1, stay free)."""
    return bank._replace(idx=torch.where(bank.idx >= 0, bank.idx + offset, bank.idx))


def _slot(stacked, i: int):
    """Entry ``i`` of a bank stacked on a leading axis."""
    return type(stacked)(*(x[i] for x in stacked))


def read_slots(path: str, manifest: dict, device) -> Tuple[List[int], list]:
    """A live checkpoint's slots, restored onto ``device``: each slot's birth
    chunk, and its sub-bank (Ball or KernelBank by the meta's
    ``bank_kind``), None for a dead slot.

    The leaf order is the state dict's (sorted keys, then NamedTuple field
    order): birth (K,), live (K,), then the stacked sub-bank leaves. The
    restore target is built on the meta device (shapes and dtypes only), so
    nothing is allocated twice; placement is the restore call's, whatever
    layout wrote the file.
    """
    sub_cls = KernelBank if manifest["meta"].get("bank_kind", "linear") == "kernel" else Ball
    if len(manifest["shapes"]) != 2 + len(sub_cls._fields):
        raise ValueError(
            f"live checkpoint at {path!r} has {len(manifest['shapes'])} leaves; expected "
            f"birth, live and the {len(sub_cls._fields)} stacked {sub_cls.__name__} leaves "
            "a live loop writes"
        )
    head = ckpt.zeros_like_manifest(manifest, 0, 2, device="meta")
    target = {
        "birth": head[0],
        "live": head[1].bool(),
        "sub": sub_cls(*ckpt.zeros_like_manifest(manifest, 2, device="meta")),
    }
    state = ckpt.restore(path, target, device=device)
    live = state["live"].cpu().tolist()
    slots = [_slot(state["sub"], i) if live[i] else None for i in range(len(live))]
    return [int(b) for b in state["birth"].cpu().tolist()], slots


def fold_slots(birth: Sequence[int], slots: Sequence, *, kernel: Optional[str] = None,
               gamma=1.0, eviction: str = "smallest-coef"):
    """The serving fold of the live slots, oldest (birth, slot) first: a
    Ball fold (``fold_banks``), or with ``kernel=`` a KernelBank fold
    (``fold_kernel_banks``). Returns the folded bank (None when no slot is
    live) and the |coef| mass its re-compressions dropped."""
    order = sorted((s for s in range(len(slots)) if slots[s] is not None),
                   key=lambda s: (birth[s], s))
    if not order:
        return None, 0.0
    banks = [slots[s] for s in order]
    if kernel is None:
        return fold_banks(banks), 0.0
    folded, dropped = fold_kernel_banks(banks, return_dropped=True, kernel=kernel, gamma=gamma,
                                        eviction=eviction)
    return folded, float(torch.sum(dropped))


class LiveBank:
    """Continuous train->serve loop over a replayable chunk source.

    source:        ``source(i) -> (X, y) | None``: absolute-chunk-index
                   addressing; must replay (sources.py documents the
                   contract). ``y`` is (n,) shared labels or (B, n) signs.
    cs:            (B,) per-model C values (a scalar broadcasts).
    n_sub_banks:   K rotating sub-bank slots (drift-repair cover size).
    rotate_every:  chunks per sub-bank epoch before rotation.
    swap_every:    chunks between fold + hot-swap pushes.
    retire:        "merge" (re-merge the two oldest, keep everything) or
                   "drop" (forget the oldest epoch) when slots run out.
    ckpt_dir:      checkpoint directory; ``run()`` resumes from it.
    checkpoint_every_folds: folds per checkpoint commit (0 disables: a
                   restart then replays the stream from chunk 0).
    server / server_factory: hot-swap target. ``server_factory(bank)`` is
                   called at the first fold to build one (e.g.
                   ``lambda b: BankServer(b)``); an existing server can be
                   passed, or attached any time with ``attach_server``.
    retry:         RetryPolicy classifying fetch failures (default:
                   TransientSourceError/OSError/TimeoutError retry with
                   capped exponential backoff; others propagate). Chunks
                   exhausting the budget are quarantined and skipped.
    failpoints:    crash-injection hooks for tests: ``(phase, chunk_idx)``
                   pairs (phase in PHASES); each fires once, raising
                   InjectedFailure at that boundary. ``mid_checkpoint``
                   first drops a garbage ``.tmp`` into ckpt_dir: the debris
                   an OS-level crash mid-commit leaves behind. A set passed
                   in is kept by reference, so relaunches sharing it fire
                   each kill once.
    bank_kind:     "linear" (Ball sub-banks via ``core.fit_bank``) or
                   "kernel" (KernelBank sub-banks via
                   ``core.fit_kernel_bank``; each chunk fits fresh with
                   ``seed_check=False`` and Sec-4.3-merges into the active
                   slot; core-set ids are lifted to absolute stream
                   coordinates, so a resume replays bit-exactly).
    kernel/gamma/coreset_size/eviction/s_tile: the kernel engine's knobs,
                   used only when ``bank_kind="kernel"``. The same kernel,
                   gamma and eviction drive every retire merge and serving
                   fold, and are written to the checkpoint meta (the
                   ``save_kernel_bank`` meta contract, so
                   ``BankServer.from_checkpoint`` reads them back).
    mesh / shard_axis: run the loop SPMD over this ``torch.distributed``
                   DeviceMesh (module docstring, "Elastic sharded
                   training"); anything but a DeviceMesh raises TypeError.
                   With a mesh, or n_stream_shards > 1, linear chunks fit
                   fresh and merge into the prior (the shard-count-agnostic
                   semantics an elastic resume needs) instead of continuing
                   the active slot inside the engine.
    n_stream_shards: the LOGICAL shard count; defaults to the mesh's shard
                   count (1 without a mesh). A resumed loop that did not
                   set it adopts the checkpoint's; an explicit value that
                   differs from the checkpoint's raises.
    shard_faults:  a ``sources.ShardFaults`` plan (or a duck-typed
                   equivalent) injecting per-(chunk, shard) device-loss /
                   straggler / fetch faults.
    shard_retry:   RetryPolicy for per-shard fetch faults (default:
                   transient source / OS / timeout / device-lost / torch
                   device errors, 2 retries). Past the budget the shard's
                   ranges are masked out and recorded in ``rows_lost``.
    straggler_policy: ``runtime.StragglerPolicy`` applied to the fault
                   plan's per-shard elapsed times; declared stragglers are
                   re-issued like lost shards.
    rotate_on:     optional ``rotate_on(stats) -> bool`` extra rotation
                   trigger, OR-ed with ``rotate_every``, evaluated after
                   every ingested chunk; keep it a pure function of durable
                   stats so a crash replay re-fires rotations identically.
    strict_finite: a serving fold with NaN/Inf in any model row is never
                   hot-swapped; by default it is quarantined
                   (``folds_quarantined``), ``strict_finite=True`` raises a
                   ValueError naming the rows instead.
    device:        where the sub-banks live and train (None: CUDA);
                   checkpoints restore onto it.
    Engine kwargs (variant/block_n/b_tile/stream_dtype/bank_resident) pass
    straight through to ``core.fit_bank`` (the kernel engine takes all but
    b_tile/bank_resident, which are linear-engine knobs).
    """

    def __init__(
        self,
        source: Callable,
        cs,
        *,
        ckpt_dir: str,
        n_sub_banks: int = 4,
        rotate_every: int = 8,
        swap_every: int = 1,
        retire: str = "merge",
        checkpoint_every_folds: int = 1,
        server=None,
        server_factory: Optional[Callable] = None,
        retry: Optional[RetryPolicy] = None,
        failpoints: Optional[Sequence[Tuple[str, int]]] = None,
        sleep: Callable[[float], None] = time.sleep,
        bank_kind: str = "linear",
        kernel: str = "rbf",
        gamma=1.0,
        coreset_size: int = 64,
        eviction: str = "smallest-coef",
        s_tile: Optional[int] = None,
        # elastic sharded training
        n_stream_shards: Optional[int] = None,
        shard_faults=None,
        shard_retry: Optional[RetryPolicy] = None,
        straggler_policy: Optional[StragglerPolicy] = None,
        # cadence / publish hooks
        rotate_on: Optional[Callable[[LiveStats], bool]] = None,
        strict_finite: bool = False,
        # engine passthrough
        variant: str = "exact",
        block_n: int = 256,
        b_tile: Optional[int] = None,
        stream_dtype=None,
        bank_resident: str = "auto",
        mesh=None,
        shard_axis="data",
        device=None,
    ):
        if bank_kind not in ("linear", "kernel"):
            raise ValueError(
                f"bank_kind must be 'linear' or 'kernel': got {bank_kind!r}"
            )
        if n_sub_banks < 1:
            raise ValueError(f"n_sub_banks must be >= 1: got {n_sub_banks}")
        if rotate_every < 1:
            raise ValueError(f"rotate_every must be >= 1: got {rotate_every}")
        if swap_every < 1:
            raise ValueError(f"swap_every must be >= 1: got {swap_every}")
        if retire not in ("merge", "drop"):
            raise ValueError(
                f"retire must be 'merge' or 'drop': got {retire!r}"
            )
        for fp in failpoints or ():
            if fp[0] not in PHASES:
                raise ValueError(
                    f"unknown failpoint phase {fp[0]!r}; expected one of "
                    f"{PHASES}"
                )
        self.device = pick_device(device)
        self.source = source
        self.cs = as_tensor(cs, self.device, torch.float32).reshape(-1)
        self.n_models = int(self.cs.shape[0])
        self.ckpt_dir = ckpt_dir
        self.k = int(n_sub_banks)
        self.rotate_every = int(rotate_every)
        self.swap_every = int(swap_every)
        self.retire = retire
        self.checkpoint_every_folds = int(checkpoint_every_folds)
        self.server = server
        self.server_factory = server_factory
        self.retry = retry or RetryPolicy(
            retryable=(TransientSourceError, OSError, TimeoutError),
            max_retries=4,
        )
        self._failpoints: Set[Tuple[str, int]] = (
            failpoints if isinstance(failpoints, set)
            else set(failpoints or ())
        )
        self._sleep = sleep
        self.mesh = mesh
        self.shard_axis = shard_axis
        if mesh is not None:
            _mesh_groups(mesh, shard_axis)  # TypeError for anything but a DeviceMesh
        self._shards_explicit = n_stream_shards is not None
        if n_stream_shards is None:
            n_stream_shards = self._mesh_devices() or 1
        if n_stream_shards < 1:
            raise ValueError(
                f"n_stream_shards must be >= 1: got {n_stream_shards}"
            )
        self.n_stream_shards = int(n_stream_shards)
        self.shard_faults = shard_faults
        self.shard_retry = shard_retry or RetryPolicy(
            retryable=(
                TransientSourceError, OSError, TimeoutError, DeviceLostError,
            ) + runtime_device_errors(),
            max_retries=2,
        )
        self.straggler_policy = straggler_policy
        self.rotate_on = rotate_on
        self.strict_finite = bool(strict_finite)
        self.bank_kind = bank_kind
        self.kernel = kernel if bank_kind == "kernel" else None
        self.gamma = float(gamma)
        self.coreset_size = int(coreset_size)
        self.eviction = eviction
        if bank_kind == "kernel":
            # fail fast on a bad kernel config instead of at the first chunk
            if kernel not in ("rbf", "linear"):
                raise ValueError(
                    f"unknown kernel {kernel!r}; expected 'rbf' or 'linear'"
                )
            if eviction not in ("smallest-coef", "farthest-point"):
                raise ValueError(
                    f"unknown eviction {eviction!r}; expected 'smallest-coef'"
                    " or 'farthest-point'"
                )
            if self.coreset_size < 1:
                raise ValueError(
                    f"coreset_size must be >= 1, got {coreset_size}"
                )
            # seed_check=False: a mid-stream chunk has no "row 0 seeds every
            # model" contract (deferred seeding is exact). mesh is not in
            # the engine kwargs: the elastic trainer owns placement.
            self._engine_kw = dict(
                kernel=kernel, gamma=self.gamma,
                coreset_size=self.coreset_size, eviction=eviction,
                variant=variant, block_n=block_n, s_tile=s_tile,
                stream_dtype=stream_dtype, seed_check=False,
                device=self.device,
            )
            self._merge_kw = dict(
                kernel=kernel, gamma=self.gamma, eviction=eviction
            )
        else:
            self._engine_kw = dict(
                variant=variant, block_n=block_n, b_tile=b_tile,
                stream_dtype=stream_dtype, bank_resident=bank_resident,
                device=self.device,
            )
            self._merge_kw = {}
        self.stats = LiveStats()
        self._reset_state()

    # -- state ---------------------------------------------------------------

    def _mesh_devices(self) -> Optional[int]:
        """Shard count across the training axes (None: no mesh)."""
        if self.mesh is None:
            return None
        return _mesh_groups(self.mesh, self.shard_axis)[2]

    def _mesh_shape(self) -> Optional[List[int]]:
        """Per-axis sizes of the training mesh, for the checkpoint meta
        (a json-stable list; None without a mesh)."""
        if self.mesh is None:
            return None
        axes = (self.shard_axis,) if isinstance(self.shard_axis, str) else tuple(self.shard_axis)
        names = self.mesh.mesh_dim_names
        return [int(self.mesh.size(names.index(a))) for a in axes]

    def _leader(self) -> bool:
        """True where this process writes checkpoints and owns the server:
        always without a mesh, on rank 0 of the default group with one."""
        return self.mesh is None or torch.distributed.get_rank() == 0

    def _barrier(self) -> None:
        if self.mesh is not None:
            torch.distributed.barrier()

    def _reset_state(self) -> None:
        self._slots: List[Optional[object]] = [None] * self.k  # Ball|KernelBank
        self._birth: List[int] = [0] * self.k
        self._active: int = 0
        self.chunk_idx: int = 0
        self._folds_since_ckpt: int = 0
        self._last_merged = None
        self._fold_dropped: float = 0.0  # |coef| mass the LAST fold cut
        # reset durable counters without touching volatile ones (restarts,
        # retries, bank_age are facts about this process, not the stream)
        self.stats.load_durable(LiveStats().durable())

    def _state_tree(self) -> dict:
        ref = next(s for s in self._slots if s is not None)
        zero = type(ref)(*(torch.zeros_like(x) for x in ref))
        slots = [s if s is not None else zero for s in self._slots]
        return {
            "birth": torch.tensor(self._birth, dtype=torch.int32),
            "live": torch.tensor([s is not None for s in self._slots], dtype=torch.bool),
            # every sub-bank leaf stacked on a NEW leading K axis: Ball
            # (w (K,B,D), r, xi2, m) or KernelBank (idx (K,B,S), ...)
            "sub": type(ref)(*(torch.stack(xs) for xs in zip(*slots))),
        }

    def _resume_from_disk(self) -> None:
        """Disk is the source of truth at run() entry: reset in-memory state
        and reload the last durable checkpoint (if any): the restart path
        after a crash, and a no-op-equivalent on a fresh start."""
        self._reset_state()
        if ckpt.exists(self.ckpt_dir):
            self._restore()
        self._barrier()  # every rank has read the commit before any moves on

    def _restore(self) -> None:
        manifest = ckpt.load_manifest(self.ckpt_dir)
        meta = manifest["meta"]
        if meta.get("live_k") != self.k or meta.get("n_models") != self.n_models:
            raise ValueError(
                f"checkpoint at {self.ckpt_dir!r} was written by a live loop "
                f"with K={meta.get('live_k')}, B={meta.get('n_models')}; this "
                f"loop is configured K={self.k}, B={self.n_models} — resume "
                "needs a matching configuration"
            )
        ck_kind = meta.get("bank_kind", "linear")
        if ck_kind != self.bank_kind:
            raise ValueError(
                f"checkpoint at {self.ckpt_dir!r} holds bank_kind={ck_kind!r} "
                f"state; this loop is configured bank_kind={self.bank_kind!r}"
                " — linear Ball and kernelized core-set states are not "
                "interchangeable"
            )
        if self.bank_kind == "kernel":
            ck_cfg = {
                key: meta.get(key)
                for key in ("kernel", "gamma", "coreset_size", "eviction")
            }
            cfg = {
                "kernel": self.kernel, "gamma": self.gamma,
                "coreset_size": self.coreset_size, "eviction": self.eviction,
            }
            if ck_cfg != cfg:
                raise ValueError(
                    f"checkpoint at {self.ckpt_dir!r} was written with "
                    f"kernel config {ck_cfg}; this loop is configured {cfg} "
                    "— a resumed kernel stream needs the exact same kernel, "
                    "gamma, coreset size and eviction policy"
                )
        # The LOGICAL shard count is durable: it pins every chunk's fold
        # structure, so it must survive any remesh. An explicit mismatch is
        # a configuration error; an implicit count adopts the checkpoint's.
        ck_shards = int(meta.get("n_stream_shards", 1))
        if self._shards_explicit and ck_shards != self.n_stream_shards:
            raise ValueError(
                f"checkpoint at {self.ckpt_dir!r} was written with "
                f"n_stream_shards={ck_shards}; this loop explicitly set "
                f"n_stream_shards={self.n_stream_shards} — the logical "
                "shard count pins the per-chunk fold structure and cannot "
                "change mid-stream (the mesh can: pass a different mesh=, "
                "or omit n_stream_shards to adopt the checkpoint's)"
            )
        self.n_stream_shards = ck_shards
        if meta.get("mesh_shape") != self._mesh_shape():
            self.stats.remeshes += 1  # volatile: a remesh between processes
        self._birth, self._slots = read_slots(self.ckpt_dir, manifest, self.device)
        self._active = int(meta["active_slot"])
        self.chunk_idx = int(meta["chunk_idx"])
        self.stats.load_durable(meta["stats"])
        if any(s is not None for s in self._slots):
            merged = self._merged()
            # the resume fold is uncounted; a poisoned restored state keeps
            # _last_merged at None so nothing non-finite is ever served
            if merged is not None and not bool(torch.any(nonfinite_rows(merged))):
                self._last_merged = merged

    def _checkpoint(self, i: int) -> None:
        if all(s is None for s in self._slots):
            return  # nothing durable yet (e.g. every chunk so far quarantined)
        self._failpoint("mid_checkpoint", i, torn_tmp=True)
        # Count the commit in the meta it rides in: restoring checkpoint N
        # must report N checkpoints, or every restart would lose one.
        self.stats.checkpoints += 1
        if self._leader():
            meta = {
                "chunk_idx": self.chunk_idx,
                "active_slot": self._active,
                "live_k": self.k,
                "n_models": self.n_models,
                "bank_kind": self.bank_kind,
                # elastic contract: the LOGICAL fold structure is durable,
                # the mesh shape is informational (remesh detection)
                "n_stream_shards": self.n_stream_shards,
                "mesh_shape": self._mesh_shape(),
                "stats": self.stats.durable(),
            }
            if self.bank_kind == "kernel":
                # the save_kernel_bank meta contract: what
                # BankServer.from_checkpoint reads the kernel config from
                meta.update(
                    kernel=self.kernel, gamma=self.gamma,
                    coreset_size=self.coreset_size, eviction=self.eviction,
                )
            ckpt.save(self.ckpt_dir, self._state_tree(), meta=meta)
        self._barrier()  # no rank runs ahead of a durable state
        self._folds_since_ckpt = 0
        self._failpoint("post_checkpoint", i)

    # -- failure injection ---------------------------------------------------

    def _failpoint(self, phase: str, i: int, torn_tmp: bool = False) -> None:
        key = (phase, i)
        if key not in self._failpoints:
            return
        self._failpoints.discard(key)  # fire once: the restart sails past
        if torn_tmp and self._leader():
            # The debris an OS crash mid-commit leaves under the atomic
            # protocol: a half-written arrays tmp nothing references. The
            # resume path must shrug it off and restore the previous commit.
            os.makedirs(self.ckpt_dir, exist_ok=True)
            with open(
                os.path.join(self.ckpt_dir, "arrays-torn.npz.tmp"), "wb"
            ) as f:
                f.write(b"\x00garbage, not a zip")
        raise InjectedFailure(f"injected at {phase} of chunk {i}")

    # -- ingest --------------------------------------------------------------

    def _fetch(self, i: int):
        attempt = 0
        while True:
            try:
                chunk = self.source(i)
            except Exception as e:
                if not self.retry.is_retryable(e):
                    raise  # programming error: surface it
                if attempt >= self.retry.max_retries:
                    self.stats.quarantined.append(i)
                    return _QUARANTINED
                self._sleep(self.retry.delay(attempt))
                attempt += 1
                self.stats.retries += 1
                continue
            return _END if chunk is None else chunk

    # -- train / fold / swap -------------------------------------------------

    def _train(self, X, y) -> int:
        Xc = as_tensor(X, self.device, torch.float32)
        yc = as_tensor(y, self.device, torch.float32)
        if yc.ndim == 1:
            yc = yc[None, :].expand(self.n_models, yc.shape[0])
        n = int(Xc.shape[0])
        if self.n_stream_shards == 1 and self.mesh is None:
            self._train_single(Xc, yc)
        else:
            self._train_elastic(Xc, yc, n)
        return n

    def _train_single(self, Xc, yc) -> None:
        """The single-shard chunk path (no mesh, one logical shard): linear
        chunks continue the active slot inside the engine; kernel chunks fit
        fresh and Sec-4.3-merge into the prior."""
        prior = self._slots[self._active]
        if self.bank_kind == "kernel":
            bank = fit_kernel_bank(Xc, yc, self.cs, **self._engine_kw)
            # Lift the chunk-local core-set ids to ABSOLUTE stream
            # coordinates. rows_ingested is durable and not yet advanced for
            # this chunk, so a replayed chunk re-derives the same offset.
            bank = _lift_ids(bank, self.stats.rows_ingested)
            if prior is not None:
                bank, dropped = merge_kernel_banks(
                    prior, bank, return_dropped=True, **self._merge_kw
                )
                self.stats.merge_dropped_mass += float(torch.sum(dropped))
        else:
            bank = fit_bank(Xc, yc, self.cs, prior, **self._engine_kw)
        self._slots[self._active] = bank

    # -- elastic sharded chunk path ------------------------------------------

    def _train_elastic(self, Xc, yc, n: int) -> None:
        """One chunk across the LOGICAL stream shards (module docstring,
        "Elastic sharded training"): ranges fit fresh, fold in ascending
        range order, and the active slot's prior merges in last. The mesh
        only decides where the fits run, so the mesh path, the per-range
        path and any later remesh give the same bits."""
        i = self.chunk_idx
        ranges = shard_ranges(n, self.n_stream_shards)
        dead = self._dead_shards(i, ranges)
        if len(dead) == len(ranges):
            # every shard lost at once: the whole chunk degrades to
            # recorded loss (no survivor to re-issue ranges to)
            self.stats.rows_lost += n
            self.stats.shard_ranges_lost += sum(1 for lo, hi in ranges if lo < hi)
            return
        clean = not dead and (
            self.shard_faults is None or self.shard_faults.clean(i)
        )
        if clean and self.mesh is not None and (
            self._mesh_devices() == self.n_stream_shards
        ):
            parts = self._fit_chunk_mesh(Xc, yc, ranges)
        else:
            parts = self._fit_chunk_ranges(Xc, yc, i, ranges, dead)
        if not parts:
            return  # every range masked out: the chunk contributes nothing
        bank = self._fold_chunk(parts)
        prior = self._slots[self._active]
        if self.bank_kind == "kernel":
            # chunk-local -> absolute stream ids; rows_ingested advances by
            # the FULL chunk (masked rows included), so ids stay unique and
            # replay-stable whatever was lost
            bank = _lift_ids(bank, self.stats.rows_ingested)
            if prior is not None:
                bank, dropped = merge_kernel_banks(
                    prior, bank, return_dropped=True, **self._merge_kw
                )
                self.stats.merge_dropped_mass += float(torch.sum(dropped))
        elif prior is not None:
            bank = merge_banks(prior, bank)
        self._slots[self._active] = bank

    def _dead_shards(self, i: int, ranges) -> set:
        """Structurally dead logical shards for chunk ``i``: planned device
        losses plus declared stragglers. Plan-keyed and stateless, so every
        run (crash replay, chaos reference) re-derives the same set."""
        faults = self.shard_faults
        if faults is None:
            return set()
        dead = {int(j) for j in faults.lost(i) if 0 <= int(j) < len(ranges)}
        elapsed = faults.elapsed(i)
        if elapsed is not None and self.straggler_policy is not None:
            dead |= {
                j for j in self.straggler_policy.stragglers(list(elapsed))
                if 0 <= j < len(ranges)
            }
        return dead

    def _fit_chunk_mesh(self, Xc, yc, ranges):
        """Every logical shard fits on its own rank in one sharded call.
        Returns the same (lo, bank) parts list as the per-range path: for
        kernel banks the per-shard fits (gathered, unfolded); for linear
        banks ``fit_bank_sharded``'s folded bank as a single part (its fold
        is ``fold_merge`` over the same ranges in the same order)."""
        if self.bank_kind == "kernel":
            kw = {k: v for k, v in self._engine_kw.items() if k != "seed_check"}
            stacked = fit_kernel_bank_shards(
                Xc, yc, self.cs, self.mesh, axis=self.shard_axis, **kw
            )
            return [
                (lo, _slot(stacked, j))
                for j, (lo, hi) in enumerate(ranges) if lo < hi
            ]
        folded = fit_bank_sharded(
            Xc, yc, self.cs, self.mesh, None, axis=self.shard_axis,
            **self._engine_kw,
        )
        return [(0, folded)]

    def _fit_chunk_ranges(self, Xc, yc, i: int, ranges, dead):
        """Per-range fits in this process. Lost/straggler ranges are
        re-issued to survivors (``rebalance_ranges``); a shard whose fetch
        faults exhaust the retry budget has its whole assigned queue masked
        out with the loss recorded durably."""
        if dead:
            queues = rebalance_ranges(list(ranges), sorted(dead), grouped=True)
            self.stats.ranges_reissued += sum(
                1 for j in dead if ranges[j][0] < ranges[j][1]
            )
        else:
            queues = {j: [r] for j, r in enumerate(ranges)}
        parts = []
        for j in sorted(queues):
            work = [(lo, hi) for lo, hi in queues[j] if lo < hi]
            if not work:
                continue
            if not self._shard_fetch_ok(i, j):
                self.stats.rows_lost += sum(hi - lo for lo, hi in work)
                self.stats.shard_ranges_lost += len(work)
                continue
            for lo, hi in work:
                parts.append((lo, self._fit_range(Xc, yc, lo, hi)))
        parts.sort(key=lambda part: part[0])
        return parts

    def _shard_fetch_ok(self, i: int, j: int) -> bool:
        """Clear shard ``j``'s fetch channel for chunk ``i`` under the
        per-shard retry budget. False = budget exhausted: mask the shard's
        ranges out (the caller records the loss)."""
        if self.shard_faults is None:
            return True
        attempt = 0
        while True:
            try:
                self.shard_faults.check(i, j)
                return True
            except Exception as e:
                if not self.shard_retry.is_retryable(e):
                    raise  # programming error: surface it
                if attempt >= self.shard_retry.max_retries:
                    return False
                self._sleep(self.shard_retry.delay(attempt))
                attempt += 1
                self.stats.shard_retries += 1

    def _fit_range(self, Xc, yc, lo: int, hi: int):
        """Fresh fit of rows [lo, hi); kernel ids lifted to chunk
        coordinates (the +lo the sharded path applies on its rank)."""
        Xr, Yr = Xc[lo:hi], yc[:, lo:hi]
        if self.bank_kind == "kernel":
            return _lift_ids(fit_kernel_bank(Xr, Yr, self.cs, **self._engine_kw), lo)
        return fit_bank(Xr, Yr, self.cs, None, **self._engine_kw)

    def _fold_chunk(self, parts):
        """Eager ascending-range Sec-4.3 fold of the chunk's per-range banks:
        the one fold both execution paths share. Kernel re-compression drops
        are audited into ``merge_dropped_mass`` (deterministic: the fold
        structure is logical, so every run derives the same drops)."""
        banks = [b for _, b in parts]
        if self.bank_kind == "kernel":
            folded, dropped = fold_kernel_banks(
                banks, return_dropped=True, **self._merge_kw
            )
            self.stats.merge_dropped_mass += float(torch.sum(dropped))
            return folded
        if len(banks) == 1:
            return banks[0]
        return fold_merge(stack_banks(banks))

    def _age_order(self) -> List[int]:
        """Live slot indices, oldest epoch first (deterministic)."""
        return sorted(
            (s for s in range(self.k) if self._slots[s] is not None),
            key=lambda s: (self._birth[s], s),
        )

    def _rotate(self) -> None:
        if self._slots[self._active] is None:
            return  # empty epoch (all chunks quarantined): nothing to freeze
        free = [s for s in range(self.k) if self._slots[s] is None]
        if free:
            nxt = free[0]
        else:
            order = self._age_order()
            oldest = order[0]
            if self.retire == "drop" or self.k == 1:
                self._slots[oldest] = None
            else:
                second = order[1]
                if self.bank_kind == "kernel":
                    merged, dropped = merge_kernel_banks(
                        self._slots[oldest], self._slots[second],
                        return_dropped=True, **self._merge_kw,
                    )
                    self.stats.merge_dropped_mass += float(torch.sum(dropped))
                else:
                    merged = merge_banks(self._slots[oldest], self._slots[second])
                self._slots[second] = merged
                self._birth[second] = self._birth[oldest]
                self._slots[oldest] = None
            self.stats.retirements += 1
            nxt = oldest
        self._active = nxt
        self._birth[nxt] = self.chunk_idx
        self.stats.rotations += 1

    def _merged(self):
        """Serving fold of the live slots, oldest first (Ball or KernelBank).

        Also records the fold's dropped |coef| mass in ``_fold_dropped``:
        the caller that COUNTS the fold (cadence/finalize, not resume) adds
        it to the durable ``stats.merge_dropped_mass``.
        """
        folded, self._fold_dropped = fold_slots(self._birth, self._slots, **self._merge_kw)
        return folded

    def _check_server_config(self, server) -> None:
        """Refuse hot-swapping into a server with a mismatched kernel config.

        Duck-typed swap targets without a ``kernel`` attribute (e.g. test
        recorders) opt out; a real ``serve.BankServer`` always has one.
        """
        skernel = getattr(server, "kernel", _NO_KERNEL_ATTR)
        if skernel is _NO_KERNEL_ATTR:
            return
        sgamma = getattr(server, "gamma", None)
        mine = (
            f"bank_kind={self.bank_kind!r}, kernel={self.kernel!r}, "
            f"gamma={self.gamma if self.kernel else None!r}"
        )
        theirs = f"kernel={skernel!r}, gamma={sgamma!r}"
        if skernel != self.kernel or (
            self.kernel is not None
            and sgamma is not None
            and float(sgamma) != self.gamma
        ):
            raise ValueError(
                f"live loop ({mine}) cannot hot-swap into a server "
                f"configured {theirs} — a bank scored under the wrong "
                "kernel config serves silent garbage; rebuild the server "
                "with the loop's kernel configuration"
            )

    def _push(self, merged) -> None:
        if merged is None:
            return
        self._last_merged = merged
        if self._leader():  # under a mesh the server lives on rank 0 alone
            if self.server is None and self.server_factory is not None:
                self.server = self.server_factory(merged)
                self._check_server_config(self.server)
            elif self.server is not None:
                self._check_server_config(self.server)
                self.server.swap_bank(merged)
        self.stats.swaps += 1
        self.stats.last_swap_chunk = self.chunk_idx
        self.stats.bank_age_chunks = 0

    # -- public surface ------------------------------------------------------

    def attach_server(self, server, push_current: bool = True) -> None:
        """Point hot-swaps at ``server``; optionally push the current bank."""
        self._check_server_config(server)
        self.server = server
        if push_current and self._last_merged is not None:
            server.swap_bank(self._last_merged)

    def serving_bank(self):
        """The last folded bank (Ball or KernelBank by ``bank_kind``): what
        an attached server is serving."""
        return self._last_merged

    def run(self, max_chunks: Optional[int] = None) -> LiveStats:
        """Resume from the last durable checkpoint and consume the stream.

        Stops when the source returns None (bounded/drained stream) or
        after ``max_chunks`` chunk positions this call. On exit a final
        fold + swap + checkpoint makes the tail durable and served. Crash
        recovery = call run() again (see run_live_with_restarts).
        """
        self._resume_from_disk()
        processed = 0
        while max_chunks is None or processed < max_chunks:
            i = self.chunk_idx
            self._failpoint("fetch", i)
            chunk = self._fetch(i)
            if chunk is _END:
                break
            if chunk is _QUARANTINED:
                self.chunk_idx = i + 1
                processed += 1
                self._cadences(i)
                continue
            X, y = chunk
            if np.shape(X)[0] == 0:
                self.chunk_idx = i + 1
                processed += 1
                continue
            rows = self._train(X, y)
            self._failpoint("post_train", i)
            self.chunk_idx = i + 1
            self.stats.chunks_ingested += 1
            self.stats.rows_ingested += rows
            processed += 1
            self._cadences(i)
        self._finalize()
        return self.stats

    def _publishable(self, merged) -> bool:
        """The non-finite publish guard: a fold with NaN/Inf in ANY model
        row is never hot-swapped (one poisoned coordinate turns every score
        of that row into NaN). Default: quarantine the fold
        (``folds_quarantined`` counts it, the server keeps the last good
        bank). ``strict_finite=True``: raise, naming the offending rows."""
        bad = nonfinite_rows(merged)
        if not bool(torch.any(bad)):
            return True
        rows = torch.nonzero(bad).flatten().tolist()
        if self.strict_finite:
            raise ValueError(
                f"non-finite serving fold at chunk {self.chunk_idx}: model "
                f"row(s) {rows} contain NaN/Inf — refusing to publish "
                "(strict_finite=True). The last good bank keeps serving; "
                "inspect the stream window since the last swap."
            )
        self.stats.folds_quarantined += 1
        return False

    def _cadences(self, i: int) -> None:
        """Rotation / fold+swap / checkpoint, keyed on the ABSOLUTE chunk
        position so a replayed window re-fires them identically (and
        ``rotate_on`` sees only replay-stable durable stats)."""
        rotate = self.chunk_idx % self.rotate_every == 0
        if not rotate and self.rotate_on is not None:
            rotate = bool(self.rotate_on(self.stats))
        if rotate:
            self._rotate()
            self._failpoint("post_rotate", i)
        if self.chunk_idx % self.swap_every == 0:
            merged = self._merged()
            if merged is not None:
                if self._publishable(merged):
                    self.stats.folds += 1
                    self.stats.merge_dropped_mass += self._fold_dropped
                    self._folds_since_ckpt += 1
                    self._failpoint("post_fold", i)
                    self._push(merged)
                    self._failpoint("post_swap", i)
                else:
                    # quarantined folds still count toward the checkpoint
                    # cadence: durability must not stall on poisoned data
                    self._folds_since_ckpt += 1
        if (
            self.checkpoint_every_folds
            and self._folds_since_ckpt >= self.checkpoint_every_folds
        ):
            self._checkpoint(i)
        if self.stats.last_swap_chunk >= 0:
            self.stats.bank_age_chunks = (
                self.chunk_idx - self.stats.last_swap_chunk
            )

    def _finalize(self) -> None:
        """Drained-stream tail: fold+swap anything trained since the last
        cadence hit, then commit a final checkpoint."""
        if self.chunk_idx % self.swap_every != 0:
            merged = self._merged()
            if merged is not None and (
                self.stats.last_swap_chunk != self.chunk_idx
            ):
                if self._publishable(merged):
                    self.stats.folds += 1
                    self.stats.merge_dropped_mass += self._fold_dropped
                    self._folds_since_ckpt += 1
                    self._push(merged)
                else:
                    self._folds_since_ckpt += 1
        if self.checkpoint_every_folds and self._folds_since_ckpt:
            self._checkpoint(self.chunk_idx - 1)


def run_live_with_restarts(
    live: LiveBank,
    *,
    max_restarts: int = 8,
    policy: Optional[RetryPolicy] = None,
    sleep: Callable[[float], None] = time.sleep,
    max_chunks: Optional[int] = None,
) -> LiveStats:
    """Crash recovery: re-enter ``live.run()`` after retryable
    failures (the live-loop analogue of ``runtime.run_with_restarts``).

    Each restart resumes from the last durable checkpoint: the recovered
    bank, served scores and durable stats are bit-identical to an
    uninterrupted run. Non-retryable exceptions (programming errors)
    propagate at once.

    The default policy classifies injected test failures,
    ``DeviceLostError`` and torch's device-fault exceptions
    (``runtime.default_live_retryable``) as retryable. A sticky CUDA error
    (an illegal address, a device-side trap) leaves this process's CUDA
    context unusable, so a restart here cannot recover from it: every
    resume fails again until the restarts are spent and the error
    propagates. Recovering from one takes a new process that resumes from
    the checkpoint, started by whatever supervises the trainer.
    """
    policy = policy or RetryPolicy(
        retryable=default_live_retryable(), max_retries=max_restarts
    )
    restarts = 0
    while True:
        try:
            return live.run(max_chunks=max_chunks)
        except Exception as e:
            if not policy.is_retryable(e):
                raise
            restarts += 1
            if restarts > max_restarts:
                raise
            live.stats.restarts += 1
            sleep(policy.delay(restarts - 1))
