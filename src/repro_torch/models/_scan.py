"""The models' token recurrences, through one helper.

``scan(step, carry, n)`` runs ``carry, y = step(carry, t)`` for t in
range(n) and joins the ys along ``dim``: the same Python loop, the same
ops in the same order, as the models wrote it by hand (the mLSTM with a
state and the sLSTM in ``xlstm.py``, the Mamba2 recurrence in
``mamba2.py``).

Inside ``count_once(counter)`` (the dry run) a recurrence of n > 3 steps is
not walked. Its step runs three times: the first and the last counted once
each, and between them one middle step counted n - 2 times, its outputs
standing for steps 1..n-2 (the join takes its y n - 2 times, all but one
detached, so that its gradient is one slot's and the last step's, as a
middle step's is). ``counter.scaled(n)`` is a context manager that
multiplies what the counter counts inside it by n;
``counter.scale_nodes(first, stop, n)`` does the same for what runs while
the autograd engine runs a node of sequence number in [first, stop): the
backward of the nodes the middle step made. ``counter.mark()`` and
``counter.persist(start, end, n, nodes)`` bound the middle step for the
live-bytes count: what it made and what outlives the last step counts n
times, one set a step standing, as in the walk (``nodes``: the sequence
numbers of the autograd nodes of steps 1..n-1, whose backward frees it). A carry that changes its
shapes over a step is walked step by step, and the counter's ``walked``
records the recurrence. The reference's compile traces a ``lax.scan`` body
once too, but its cost analysis leaves out the trip count; here it is kept.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch
from torch.utils._python_dispatch import _disable_current_modes
from torch.utils._pytree import tree_leaves

_ONCE = contextvars.ContextVar("repro_torch_scan_once", default=None)


@contextlib.contextmanager
def count_once(counter):
    """Inside the block, ``scan`` steps a recurrence three times and has
    ``counter`` (``scaled(n)``, ``scale_nodes(first, stop, n)``,
    ``scanned(name, n)``, ``walked``, ``mark()``, ``persist(start, end, n,
    nodes)``)
    count the rest."""
    token = _ONCE.set(counter)
    try:
        yield counter
    finally:
        _ONCE.reset(token)


def scan(step, carry, n: int, *, name: str, dim: int = 1, join=torch.stack):
    """``carry, y = step(carry, t)`` for t in range(n); returns the last
    carry and ``join(ys, dim)``."""
    counter = _ONCE.get()
    ys = []

    def walk(carry, t0):
        for t in range(t0, n):
            carry, y = step(carry, t)
            ys.append(y)
        return carry, join(ys, dim)

    if counter is None or n <= 3:
        return walk(carry, 0)
    shapes = [tuple(x.shape) for x in tree_leaves(carry)]
    carry, y0 = step(carry, 0)
    if [tuple(x.shape) for x in tree_leaves(carry)] != shapes:
        counter.walked[name] = counter.walked.get(name, 0) + 1
        ys.append(y0)
        return walk(carry, 1)
    counter.scanned(name, n)
    mark, start = _sequence_nr(), counter.mark()
    with counter.scaled(n - 2):
        carry, y1 = step(carry, 1)
    end = counter.mark()
    graph = torch.is_grad_enabled()
    if graph:
        counter.scale_nodes(mark, _sequence_nr(), n - 2)
    carry, y2 = step(carry, n - 1)
    counter.persist(start, end, n - 2, (mark, _sequence_nr()) if graph else None)
    return carry, join([y0, y1] + [y1.detach()] * (n - 3) + [y2], dim)


def _sequence_nr() -> int:
    """The sequence number the next autograd node of this thread gets (its
    probe made outside any dispatch mode, so that no count sees it)."""
    with _disable_current_modes(), torch.enable_grad():
        return torch.ones((), requires_grad=True).mul(1).grad_fn._sequence_nr() + 1
