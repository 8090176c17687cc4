"""Chunk sources for the live loop — replayable-by-index stream adapters.

The live loop's crash-safety contract is REPLAY: a source is a callable
``source(i) -> (X_chunk, y_chunk) | None`` addressed by absolute chunk index.
After a crash, the trainer restarts from its last durable StreamCheckpoint
and re-requests exactly the chunks consumed since — so a source must return
the same rows for the same index every time it is asked (Kafka offsets, a
sharded log, or a file of fixed-size records all satisfy this; a one-shot
python iterator does NOT). ``None`` means the stream is (currently)
exhausted — the loop stops; an unbounded deployment source would block
instead of returning None.

Bit-exact crash equivalence additionally needs the per-chunk *outcome* to be
stable across re-fetches: a chunk either delivers the same rows (possibly
after transient failures) or always fails into quarantine. A chunk whose
retry budget only sometimes covers its flakiness trains in one run and is
quarantined in another — that is a property of the source, not of the loop.

``ArraySource``    in-memory (X, y) arrays chunked by index (tests/examples).
``FlakySource``    wraps a source with a deterministic failure plan —
                   transient faults (fail n times, then deliver) and poison
                   chunks (fail forever) for retry/quarantine testing.
``ShardFaults``    the per-(chunk, shard) fault plan of the ELASTIC live
                   loop: device-loss and straggler events (structural —
                   the shard's range is re-issued to survivors) plus
                   per-shard fetch faults (transient or poison — masked
                   out past the shard retry budget).
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np


class TransientSourceError(RuntimeError):
    """A retryable chunk-fetch fault (network blip, storage timeout)."""


Chunk = Tuple[np.ndarray, np.ndarray]


class ArraySource:
    """Replayable chunks out of in-memory arrays.

    ``y`` is (N,) shared labels or (B, N) per-model sign rows — chunk i is
    rows [i*chunk_size, (i+1)*chunk_size) of X and the matching columns/rows
    of y, exactly like ``data.stream.chunk_stream`` but addressed by index.
    """

    def __init__(self, X, y, chunk_size: int):
        self.X = np.asarray(X)
        self.y = np.asarray(y)
        if chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1: got {chunk_size}")
        self.chunk_size = int(chunk_size)
        n = self.X.shape[0]
        self.n_chunks = -(-n // self.chunk_size) if n else 0

    def __call__(self, i: int) -> Optional[Chunk]:
        lo = i * self.chunk_size
        if lo >= self.X.shape[0]:
            return None
        hi = min(lo + self.chunk_size, self.X.shape[0])
        yc = self.y[lo:hi] if self.y.ndim == 1 else self.y[:, lo:hi]
        return self.X[lo:hi], yc


class FlakySource:
    """Deterministic fault injection around any replayable source.

    ``fail_plan`` maps chunk index -> number of consecutive failures before
    the chunk delivers; ``POISON`` (or any negative count) marks a chunk
    that fails on every attempt, forever — the quarantine case. Attempts
    are counted per chunk across the source's lifetime, so a transient
    chunk's outcome is stable per fetch only while its budget lasts (see
    module docstring).
    """

    POISON = -1

    def __init__(
        self,
        inner: Callable[[int], Optional[Chunk]],
        fail_plan: Dict[int, int],
        exc: Callable[[str], BaseException] = TransientSourceError,
    ):
        self.inner = inner
        self.fail_plan = dict(fail_plan)
        self.exc = exc
        self.attempts: Dict[int, int] = {}

    def __call__(self, i: int) -> Optional[Chunk]:
        plan = self.fail_plan.get(i, 0)
        seen = self.attempts.get(i, 0)
        self.attempts[i] = seen + 1
        if plan < 0:
            raise self.exc(f"poison chunk {i} (attempt {seen + 1})")
        if seen < plan:
            raise self.exc(
                f"transient fault on chunk {i} (attempt {seen + 1}/{plan})"
            )
        return self.inner(i)


class ShardFaults:
    """Deterministic per-(chunk, shard) fault plan for the elastic live loop.

    The elastic loop splits every chunk into ``n_stream_shards`` LOGICAL
    ranges (``core.shard_ranges``); this object scripts what goes wrong per
    (chunk index, logical shard) — the shard-level analogue of
    ``FlakySource``:

    ``lost``   chunk -> shard ids whose DEVICE is lost for that chunk.
               Structural: queried (never raised), fires in every run and
               on every crash replay, so the re-issued range layout —
               ``runtime.rebalance_ranges`` splits the lost range among
               survivors — is identical in a chaos run and its crash-free
               reference.
    ``flaky``  (chunk, shard) -> consecutive per-shard fetch failures
               before the range delivers; ``POISON`` (any negative) fails
               forever — past the loop's shard retry budget the shard's
               assigned ranges are MASKED OUT (rows recorded in
               ``LiveStats.rows_lost``). Attempts are counted across this
               instance's lifetime, so share ONE instance across the
               relaunches of a crashy run (the replay-stability caveat of
               the module docstring applies per shard: keep transient
               counts within the retry budget, or use POISON).
    ``slow``   chunk -> simulated per-shard elapsed seconds, handed to the
               loop's ``StragglerPolicy``; declared stragglers are
               re-issued exactly like ``lost`` shards. Structural and
               stateless, hence replay-stable.
    """

    POISON = -1

    def __init__(
        self,
        *,
        lost: Optional[Dict[int, Iterable[int]]] = None,
        flaky: Optional[Dict[Tuple[int, int], int]] = None,
        slow: Optional[Dict[int, Sequence[float]]] = None,
        exc: Callable[[str], BaseException] = TransientSourceError,
    ):
        self._lost = {
            int(c): frozenset(int(j) for j in js)
            for c, js in (lost or {}).items()
        }
        self._flaky = {
            (int(c), int(j)): int(n) for (c, j), n in (flaky or {}).items()
        }
        self._slow = {
            int(c): tuple(float(t) for t in ts)
            for c, ts in (slow or {}).items()
        }
        self.exc = exc
        self.attempts: Dict[Tuple[int, int], int] = {}

    def lost(self, i: int) -> frozenset:
        """Shard ids whose device is lost for chunk ``i``."""
        return self._lost.get(i, frozenset())

    def elapsed(self, i: int) -> Optional[Tuple[float, ...]]:
        """Simulated per-shard elapsed seconds for chunk ``i`` (or None)."""
        return self._slow.get(i)

    def clean(self, i: int) -> bool:
        """True when chunk ``i`` has NO planned fault of any kind — the
        loop's license to take the single-dispatch mesh fast path. Plan-
        keyed (not attempt-keyed), so every run answers identically."""
        return (
            i not in self._lost
            and i not in self._slow
            and all(c != i for (c, _j) in self._flaky)
        )

    def check(self, i: int, j: int) -> None:
        """Raise shard ``j``'s planned fetch fault for chunk ``i``, if any."""
        plan = self._flaky.get((i, j), 0)
        if plan == 0:
            return
        seen = self.attempts.get((i, j), 0)
        self.attempts[(i, j)] = seen + 1
        if plan < 0:
            raise self.exc(f"poisoned shard {j} of chunk {i} (attempt {seen + 1})")
        if seen < plan:
            raise self.exc(
                f"transient fault on shard {j} of chunk {i} "
                f"(attempt {seen + 1}/{plan})"
            )
