"""One device's live bytes under a step: the dry run's memory analysis.

The port's stand-in for the ``output_size_in_bytes`` and
``temp_size_in_bytes`` of XLA's ``compiled.memory_analysis()``, which the
reference's dry run records per cell. ``LiveBytes`` is fed by the dispatch
mode that counts a cell's flops (``dryrun.CellCounter``): every op that runs
on local tensors hands it its outputs, and each new storage among them is
registered with its ``nbytes`` and a finalizer, keyed by the storage's
identity (the method of torch's ``distributed/_tools/mem_tracker.py``). An
event log keeps ``+bytes`` where a storage is made and ``-bytes`` where it
dies. The step's arguments (params, moments, batch, cache) are registered
before it runs and are not step-made; DTensor wrappers own no storage, and
the fake tensors of DTensor's sharding propagation never reach the count.

From the log, with the step's outputs:

  - ``output_size_in_bytes``: the bytes of the storages the step returns,
    arguments written in place among them (the reference donates those);
  - ``temp_size_in_bytes``: the highest count, at any point of the step, of
    live step-made bytes that are not outputs, so that argument + output +
    temp bounds the peak, as in XLA's analysis;
  - ``peak_bytes``: the highest count of all live step-made bytes (the
    device's peak above its arguments, which a card's allocator measures).

What the dry run does not run it reckons:

  - a recurrence counted once (``models._scan``): the bytes that its middle
    step makes and that outlive the last step stand for n - 2 steps' (the
    walk keeps one such set a step). ``persist`` gives them that weight from
    the end of the middle step on; where the backward of a recurrence's
    steps frees them, the extra copies go when the engine runs a node below
    that recurrence's middle step (the walk frees them over the backward of
    the steps they stand for, never above the first's peak);
  - one microbatch standing for A (``reckon_microbatches``): the A-step's
    log is its accumulators and update, run, with the microbatch's log
    between them, whose every byte is then temporary.

No compiler runs, so ``generated_code_size_in_bytes`` and ``bytes_accessed``
stay ``None`` in the dry run's record.
"""
from __future__ import annotations

import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._pytree import tree_leaves
from torch.utils._python_dispatch import is_traceable_wrapper_subclass


def local_tensors(tree):
    """The plain tensors that hold ``tree``'s data: a DTensor's local shard,
    a plain tensor itself; other wrapper subclasses are skipped."""
    out = []
    for x in tree_leaves(tree):
        if not isinstance(x, torch.Tensor):
            continue
        local = getattr(x, "_local_tensor", None)
        if local is not None:
            x = local
        if not is_traceable_wrapper_subclass(x):
            out.append(x)
    return out


def _node_seq():
    """The sequence number of the autograd node the engine runs, else None."""
    node = torch._C._current_autograd_node()
    return None if node is None else node._sequence_nr()


class LiveBytes:
    """The live-bytes count."""

    def __init__(self):
        self._ids = {}  # id(storage) -> sid (step-made) or -1 (an argument)
        self._refs = {}  # id(storage) -> weakref with the finalizer
        self._live = {}  # sid -> [nbytes, weight] of live step-made storages
        self._arg_bytes = {}  # id(storage) -> nbytes of the arguments
        self._next = 0
        self.events = []  # (sid, delta), in order
        self._virtual = []  # (position in events, sid, delta), merged on read
        self._spans = []  # (first, stop): the autograd nodes of a recurrence's steps 1..n-1
        self._pending = []  # (first, sid, delta): releases deferred below node ``first``
        self._devices = set()  # the arguments' devices: the one device counted

    # -- registration --------------------------------------------------------
    def arguments(self, tree) -> int:
        """Registers ``tree``'s storages as the step's arguments; returns
        their bytes (each storage once)."""
        total = 0
        for t in local_tensors(tree):
            self._devices.add(t.device)
            st = t.untyped_storage()
            key = id(st)
            if key in self._ids:
                continue
            self._watch(st, -1)
            self._arg_bytes[key] = st.nbytes()
            total += st.nbytes()
        return total

    def made(self, out) -> None:
        """Registers each new storage among the tensors of ``out``."""
        for t in tree_leaves(out):
            if (not isinstance(t, torch.Tensor) or is_traceable_wrapper_subclass(t)
                    or isinstance(t, FakeTensor) or t.device not in self._devices):
                continue
            st = t.untyped_storage()
            sid = self._ids.get(id(st))
            if sid is None:
                if self._pending:
                    self._flush(_node_seq())
                sid = self._next
                self._next += 1
                nbytes = st.nbytes()
                self._watch(st, sid)
                self._live[sid] = [nbytes, 1]
                self.events.append((sid, nbytes))
            elif sid >= 0 and st.nbytes() != self._live[sid][0]:  # resized in place
                rec = self._live[sid]
                self.events.append((sid, (st.nbytes() - rec[0]) * rec[1]))
                rec[0] = st.nbytes()

    def _watch(self, st, sid):
        key = id(st)
        self._ids[key] = sid
        self._refs[key] = weakref.ref(st, lambda _, key=key: self._died(key))

    def _died(self, key):
        sid = self._ids.pop(key)
        del self._refs[key]
        if sid < 0:
            return
        nbytes, weight = self._live.pop(sid)
        self.events.append((sid, -nbytes))
        if weight > 1:
            seq = _node_seq()
            first = next((a for a, b in self._spans if seq is not None and a <= seq < b), None)
            if first is not None:
                # a recurrence's backward frees it (with remat, the forward's
                # nodes free the recomputed copy): the walk's other copies go
                # with the backward of the steps they stand for
                self._pending.append((first, sid, -nbytes * (weight - 1)))
            else:
                self.events.append((sid, -nbytes * (weight - 1)))

    def _flush(self, seq):
        """Releases the deferred copies whose recurrence's backward is done
        (the engine below its steps' nodes, or out of the backward)."""
        keep = []
        for first, sid, delta in self._pending:
            if seq is None or seq < first:
                self.events.append((sid, delta))
            else:
                keep.append((first, sid, delta))
        self._pending = keep

    # -- a recurrence counted once ------------------------------------------
    def mark(self):
        """The log's position and the next storage id (``persist``'s bounds)."""
        return len(self.events), self._next

    def persist(self, start, end, n: int, nodes=None) -> None:
        """The storages made between the marks ``start`` and ``end`` (the
        middle step) that are still live count ``n`` times from ``end`` on.
        ``nodes``: (first, stop), the sequence numbers of the autograd nodes
        of the recurrence's steps after the first (None without a graph)."""
        pos = end[0]
        for sid in range(start[1], end[1]):
            rec = self._live.get(sid)
            if rec is not None:
                self._virtual.append((pos, sid, rec[0] * rec[1] * (n - 1)))
                rec[1] *= n
        if nodes is not None:
            self._spans.append(nodes)

    # -- reading ------------------------------------------------------------
    def deltas(self, lo=0, hi=None):
        """The log between positions ``lo`` and ``hi``, virtual entries
        merged in (one at position p goes before the event at p)."""
        if hi is None:
            self._flush(None)
            hi = len(self.events)
            virtual = [v for v in self._virtual if lo <= v[0]]
        else:
            virtual = [v for v in self._virtual if lo <= v[0] < hi]
        virtual.sort(key=lambda v: v[0])
        out, i = [], 0
        for pos in range(lo, hi):
            while i < len(virtual) and virtual[i][0] == pos:
                out.append(virtual[i][1:])
                i += 1
            out.append(self.events[pos])
        out.extend(v[1:] for v in virtual[i:])
        return out

    def outputs(self, tree):
        """(step-made sids among ``tree``'s storages, bytes of ``tree``'s
        storages: weighted where step-made, each storage once)."""
        sids, total, seen = set(), 0, set()
        for t in local_tensors(tree):
            st = t.untyped_storage()
            key = id(st)
            if key in seen:
                continue
            seen.add(key)
            sid = self._ids.get(key)
            if sid is None:
                continue  # made outside the count
            if sid < 0:
                total += self._arg_bytes[key]
            else:
                sids.add(sid)
                total += self._live[sid][0] * self._live[sid][1]
        return sids, total

    def summary(self, out) -> dict:
        """The step's record fields, ``out`` its returned tree (still live)."""
        sids, out_bytes = self.outputs(out)
        peak, temp = peaks([(sid in sids, d) for sid, d in self.deltas()])
        return {"output_size_in_bytes": out_bytes, "temp_size_in_bytes": temp,
                "peak_bytes": peak}


def peaks(log):
    """(the highest running sum of every delta, that of the deltas not
    marked as outputs) over ``log``, a list of (is_output, delta)."""
    all_, temp, peak_all, peak_temp = 0, 0, 0, 0
    for is_out, d in log:
        all_ += d
        if not is_out:
            temp += d
        peak_all = max(peak_all, all_)
        peak_temp = max(peak_temp, temp)
    return peak_all, peak_temp


def reckon_microbatches(micro: LiveBytes, micro_end, micro_out, update: LiveBytes, update_start,
                        out):
    """The bytes of a step of A > 1 microbatches from the parts that run
    alike: ``micro``'s log up to the mark ``micro_end`` (one microbatch's
    loss and grads; ``micro_out`` what that run returned), and ``update``'s
    log (the f32 accumulators and the loss's sum made before the position
    ``update_start``, then the update on them; ``out`` what it returned).
    The A-step makes its accumulators, runs A microbatches one after
    another, each one's grads added in place and then released, and
    updates: the microbatches' logs are alike, so one stands for all, every
    byte of it temporary. What the microbatch made that outlives the whole
    run without being returned (a model's cache, made by the first call)
    stays live through the update."""
    sids, out_bytes = update.outputs(out)
    returned, _ = micro.outputs(micro_out)
    grads = [(False, d) for _, d in micro.deltas(0, micro_end[0])]
    made = sum(d for _, d in grads)
    kept = sum(n * w for sid, (n, w) in micro._live.items()
               if sid < micro_end[1] and sid not in returned)
    log = ([(sid in sids, d) for sid, d in update.deltas(0, update_start)] + grads
           + [(False, kept - made)] + [(sid in sids, d) for sid, d in update.deltas(update_start)])
    peak, temp = peaks(log)
    return {"output_size_in_bytes": out_bytes, "temp_size_in_bytes": temp, "peak_bytes": peak}
