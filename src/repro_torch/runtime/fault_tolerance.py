"""Fault-tolerance runtime: checkpointed training loop with restart, range
re-assignment for stragglers and failures, and elastic restores.

- the training loop checkpoints every ``ckpt_every`` steps (atomic
  manifest commit, ``checkpoint/ckpt.py``) and restarts from the last
  durable state after a retryable failure;
- stream work is assigned as contiguous [start, end) ranges; a failed or
  straggling shard's range is re-issued to survivors (``rebalance_ranges``).
  The Sec-4.3 ball merge folds the ranges in a fixed order, so re-assignment
  does not change the model class;
- ``remesh_state`` restores a checkpoint for another process layout:
  placement is a property of the restore call (``ckpt.restore(device=)``),
  not of the file.

Failure classes. Retryable: ``InjectedFailure`` (tests), ``DeviceLostError``
and torch's device faults (``runtime_device_errors``: ``torch.AcceleratorError``
and ``torch.cuda.CudaError``). Not retryable: ``torch.OutOfMemoryError``
(a ``RuntimeError`` of its own, not an ``AcceleratorError``), since an
allocation that failed at given sizes fails again at the same sizes after a
resume; and the port's own launch checks (``kernels._build.check``), which
raise a plain ``RuntimeError`` for a launch the card refused: a
configuration fault, not a transient one.

Sticky CUDA errors. After an illegal address or a device-side trap the
process's CUDA context is unusable: every later CUDA call in that process
fails. A restart inside the same process (``run_with_restarts``,
``live.run_live_with_restarts``) therefore cannot recover from a real
``torch.AcceleratorError`` of that kind; it burns its restarts and raises.
Only a new process resumes from the checkpoint, started by whatever
supervises the trainer. The classification stays as it is so that such a
fault is reported as a device fault, not as a programming error.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable, List, Optional, Sequence, Tuple, Type

import torch

from ..checkpoint import ckpt


class InjectedFailure(RuntimeError):
    pass


class DeviceLostError(RuntimeError):
    """A shard's device disappeared mid-chunk (host preemption, link loss,
    accelerator reset). Always classified as a retryable infrastructure
    failure (the work range is re-issued or the process restarts), never as
    a programming error."""


def runtime_device_errors() -> Tuple[Type[BaseException], ...]:
    """The exception classes torch raises for device-level faults:
    ``torch.AcceleratorError`` (a CUDA error reported by the runtime, e.g.
    an illegal address or a device-side assert) and ``torch.cuda.CudaError``
    (an error code from the CUDA runtime API). A torch without one of them
    leaves it out. ``torch.OutOfMemoryError`` is not among them (module
    docstring)."""
    errs: List[Type[BaseException]] = []
    for owner, name in ((torch, "AcceleratorError"), (torch.cuda, "CudaError")):
        cls = getattr(owner, name, None)
        if isinstance(cls, type) and issubclass(cls, BaseException) and cls not in errs:
            errs.append(cls)
    return tuple(errs)


def default_live_retryable() -> Tuple[Type[BaseException], ...]:
    """Default retryable classes for the live restart loop
    (``repro_torch.live.run_live_with_restarts``): injected test failures,
    ``DeviceLostError`` and torch's device-fault exceptions, so a device
    fault burns a restart (resume from the last durable checkpoint) instead
    of propagating as if it were a programming error. See the module
    docstring for why an in-process restart cannot clear a sticky CUDA
    error."""
    return (InjectedFailure, DeviceLostError) + runtime_device_errors()


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Failure classification + capped exponential backoff, as one object.

    ``retryable`` names the exception classes worth restarting for:
    transient infrastructure faults (preemption, flaky I/O, injected test
    failures). Everything else is a programming error and propagates at
    once: retrying a ValueError re-raises the same ValueError
    ``max_retries`` times slower.

    ``delay(attempt)`` is ``backoff_base * 2**attempt`` capped at
    ``backoff_cap`` seconds (attempt counts from 0). The restart loop
    (``run_with_restarts``) and the live loop's chunk-fetch retry
    (``repro_torch.live``) share this policy object.
    """

    retryable: Tuple[Type[BaseException], ...] = (InjectedFailure,)
    max_retries: int = 8
    backoff_base: float = 0.05
    backoff_cap: float = 2.0

    def is_retryable(self, exc: BaseException) -> bool:
        return isinstance(exc, self.retryable)

    def delay(self, attempt: int) -> float:
        return min(self.backoff_cap, self.backoff_base * (2.0 ** attempt))


@dataclasses.dataclass
class RunReport:
    steps_done: int
    restarts: int
    metrics: list


def run_with_restarts(
    step_fn: Callable,
    state,
    batches: Sequence,
    *,
    ckpt_dir: str,
    ckpt_every: int = 10,
    fail_at: Optional[Sequence[int]] = None,
    max_restarts: int = 8,
    device=None,
    retryable: Sequence[Type[BaseException]] = (InjectedFailure,),
    backoff_base: float = 0.05,
    backoff_cap: float = 2.0,
    sleep: Callable[[float], None] = time.sleep,
) -> Tuple[object, RunReport]:
    """Run ``step_fn(state, batch) -> (state, metrics)`` over ``batches``
    with checkpoint/restart semantics. ``state`` is a tree of tensors
    (dicts, tuples, NamedTuples).

    ``fail_at``: steps at which an InjectedFailure fires *after* the step
    executes but *before* its checkpoint would commit: the worst case (work
    lost back to the last checkpoint).

    ``device``: where a restored state is placed (None: each leaf where the
    initial state's leaf lives).

    ``retryable`` classifies failures: exceptions of these classes restart
    from the last durable checkpoint after a capped exponential backoff
    (``backoff_base * 2**restart``, capped at ``backoff_cap``; ``sleep`` is
    injectable for tests); anything else propagates at once with no restart
    burned.
    """
    policy = RetryPolicy(
        retryable=tuple(retryable), max_retries=max_restarts,
        backoff_base=backoff_base, backoff_cap=backoff_cap,
    )
    fail_at = set(fail_at or ())
    restarts = 0
    metrics_log: list = []

    while True:
        # resume point
        if ckpt.exists(ckpt_dir):
            meta = ckpt.load_meta(ckpt_dir)
            start = int(meta["step"])
            state = ckpt.restore(ckpt_dir, state, device=device)
        else:
            start = 0
            ckpt.save(ckpt_dir, state, meta={"step": 0})
        # Steps between the last checkpoint and a crash re-run from `start`:
        # drop their already-logged metrics so RunReport.metrics matches the
        # uninterrupted run exactly (one entry per step, no duplicates).
        del metrics_log[start:]
        try:
            for i in range(start, len(batches)):
                state, m = step_fn(state, batches[i])
                if (i + 1) in fail_at:
                    fail_at.discard(i + 1)
                    raise InjectedFailure(f"injected at step {i + 1}")
                if (i + 1) % ckpt_every == 0 or (i + 1) == len(batches):
                    ckpt.save(ckpt_dir, state, meta={"step": i + 1})
                metrics_log.append(m)
            return state, RunReport(len(batches), restarts, metrics_log)
        except Exception as e:
            if not policy.is_retryable(e):
                raise  # programming error: no restart to burn
            restarts += 1
            if restarts > max_restarts:
                raise
            sleep(policy.delay(restarts - 1))


def rebalance_ranges(
    ranges: List[Tuple[int, int]], dead: Iterable[int], *, grouped: bool = False
):
    """Re-issue dead shards' [start, end) ranges to survivors (round-robin
    splits). Survivor count = len(ranges) - len(dead); each dead range is
    split evenly among survivors, appended to their work queues.

    ``grouped=True`` returns the per-survivor work queues as a dict
    ``{survivor_index: [(lo, hi), ...]}`` (each queue starts with the
    survivor's own range) instead of the flattened list: the form the
    elastic live loop needs to charge re-issued ranges to the surviving
    shard whose fetch channel delivers them."""
    dead = set(dead)
    survivors = [i for i in range(len(ranges)) if i not in dead]
    if not survivors:
        raise ValueError(
            f"rebalance_ranges: all {len(ranges)} shard(s) are dead "
            f"(dead={sorted(dead)}) — no survivors to re-issue ranges to"
        )
    out = {i: [ranges[i]] for i in survivors}
    # sorted(): set iteration order is hash-dependent; the re-issued work
    # queues must be deterministic across processes.
    for d in sorted(dead):
        lo, hi = ranges[d]
        n = len(survivors)
        width = (hi - lo + n - 1) // n
        for j, s in enumerate(survivors):
            a = lo + j * width
            b = min(lo + (j + 1) * width, hi)
            if a < b:
                out[s].append((a, b))
    if grouped:
        return out
    return [r for s in survivors for r in out[s]]


def remesh_state(ckpt_dir: str, target_state, new_mesh, sharding_fn):
    """Elastic rescale: restore ``target_state``'s structure from
    ``ckpt_dir`` onto the device ``sharding_fn(target_state, new_mesh)``
    names (e.g. this rank's card of the new mesh)."""
    device = sharding_fn(target_state, new_mesh)
    return ckpt.restore(ckpt_dir, target_state, device=device)


@dataclasses.dataclass
class StragglerPolicy:
    """Deadline-based straggler mitigation for the streaming fit.

    A controller observes per-shard heartbeats; the policy object carries
    the decision logic (pure, testable): after ``deadline_factor`` x the
    median shard time, a shard is declared straggling and its range is
    re-issued via ``rebalance_ranges``.
    """

    deadline_factor: float = 3.0

    def stragglers(self, elapsed: Sequence[float]) -> List[int]:
        if not elapsed:
            return []
        med = sorted(elapsed)[len(elapsed) // 2]
        return [i for i, t in enumerate(elapsed) if t > self.deadline_factor * max(med, 1e-9)]
