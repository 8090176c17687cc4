"""Multi-pod dry run: lay out and step every (arch x shape x mesh) cell on a
fake 256- or 512-rank world, in one process, with no allocation.

The port's stand-in for the reference's ``launch/dryrun.py``, which lowers
and compiles each cell's jitted step on 256 and 512 forced host devices and
reads XLA's memory and cost analyses. Here, for each cell:

  1. the default process group is torch's fake backend at the mesh's world
     size (``FakeStore``, rank 0: collectives return at once and move no
     data), and the mesh is ``launch/mesh.py``'s production mesh;
  2. params, AdamW moments, the batch and the cache are meta tensors laid
     out as DTensors by ``sharding/rules.py`` (``params_specs`` and
     ``decode_specs`` of ``launch/specs.py``);
  3. the step runs once on them, eagerly, under ``use_mesh`` (so the
     models' ``shard_hint`` sites redistribute) and ``implicit_replication``
     (plain tensors the models make, such as masks and positions, act as
     replicated): train is the loss's forward and backward of one
     microbatch with remat "full" and the AdamW update, prefill and decode
     are the models' own;
  4. a dispatch mode counts, per device, the products' flops (the ops that
     run on the local shards; ``flops_global`` counts the same products at
     their global shapes) and each collective the DTensors launch, with the
     bytes of its local operand. Train runs one of ``microbatches_for``'s
     microbatches and scales that step's flops and collectives by their
     count (the microbatches are identical; the update's few collectives,
     the global norm's all-reduces, are so counted once a microbatch). A
     token recurrence (``models._scan.scan``: the xLSTM's and Mamba2's) runs
     three of its steps and counts the middle one for the rest, forward and
     backward; the record says ``"scan_counted_once": true`` and gives the
     trip counts (``run_cell(..., scan_once=False)`` walks every step). The
     reference's compile traces a scan's body once too, but XLA's
     ``cost_analysis`` then counts that body once, not once a trip;
  5. the same mode counts one device's live bytes (``launch/memory.py``):
     each new storage a local op makes, until it dies. From it come the
     reference's ``output_size_in_bytes`` (what the step returns, the
     params, moments and cache it writes in place among them) and
     ``temp_size_in_bytes`` (the most step-made bytes live at once that are
     not outputs), and ``peak_above_arguments_in_bytes`` (the most
     step-made bytes live at once). A recurrence counted once weighs what
     its middle step leaves live for the steps it stands for; a train cell
     of A > 1 microbatches is reckoned from its one microbatch and an
     update on f32 accumulators (``reckon_train``). Ops that fall back run
     on full tensors, which count as the stand-in makes them;
  6. where DTensor cannot propagate an op's sharding, ``fallback_rule``
     lets the ops of FALLBACK_OPS run replicated (counted under
     ``fallbacks``) and fails the cell on any other. A fallback replicates
     the fewest mesh dims it must, as XLA's GSPMD gathers only the dim that
     blocks a reshape: first one dim of its inputs (``model``, then
     ``data``: a head view of a model-sharded activation keeps its batch
     shard), where DTensor then accepts the op, else every dim; the record's
     ``fallback_replicated`` counts, per op, the fallbacks of each kind;
  7. one JSON record per cell goes to ``--out`` (a results cache: cells
     already there are skipped unless ``--force``); a cell whose step runs
     past ``--cell-timeout`` seconds is recorded as a TIMEOUT.

Decode cells lay the cache and tokens out by ``cache_spec`` /
``batch_spec``, or with ``REPRO_SERVE_SHARDING=v2`` by the weight-stationary
``serve_cache_spec`` / ``serve_batch_spec``, and record ``serve_sharding``
as the reference does.

What the stand-in cannot see is ``null`` in the record: XLA's
generated-code size (``generated_code_size_in_bytes``) and ``bytes
accessed`` (no compiler runs), and collectives that a compiler would insert
or fuse beyond the DTensors' own. ``argument_size_in_bytes`` is one
device's shards of every input (params, moments and batch; params, batch;
or params, cache and tokens).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch internlm2-1.8b \\
      --shape train_4k --mesh single,multi --out results/dryrun_torch
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --smoke --world 8   # small
  REPRO_SERVE_SHARDING=v2 PYTHONPATH=src python -m repro_torch.launch.dryrun --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-moe-30b-a3b,whisper-base,xlstm-125m \\
      --shape train_4k,prefill_32k --mesh single,multi --cell-timeout 600 --force
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import signal
import time
import traceback
from pathlib import Path
from typing import Any, Callable, NamedTuple, Optional

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch._device import inference_as
from repro_torch.configs import SHAPES, SMOKE_SHAPES, applicable, get_config, list_archs
from repro_torch.configs.base import ArchConfig
from repro_torch.launch import specs as S
from repro_torch.launch.memory import LiveBytes, reckon_microbatches
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model
from repro_torch.models._scan import count_once
from repro_torch.optim import adamw
from repro_torch.sharding import rules as R
from repro_torch.sharding.hints import use_mesh
from repro_torch.train import TrainCfg
from repro_torch.train.train_loop import accumulators, apply_update, grads_of

COLLECTIVES = ("all_gather_into_tensor", "reduce_scatter_tensor", "all_reduce",
               "all_to_all_single", "broadcast")


def microbatches_for(cfg: ArchConfig, shape) -> int:
    """The reference's accumulation factor: 16 for unrolled families and
    configs over 20 B parameters, else 8 (train cells only)."""
    if shape.kind != "train":
        return 1
    if cfg.unrolled:
        return 16
    return 16 if cfg.n_params() > 20e9 else 8


#: The ops that run replicated where DTensor cannot propagate their
#: sharding (``fallback_rule``): the views that split or merge a sharded
#: dim unevenly (attention's head reshapes of sequence-sharded
#: activations), and the sLSTM's gate backward, which has no sharding
#: strategy. Any other op that DTensor refuses fails the cell.
FALLBACK_OPS = frozenset({
    "aten.view",
    "aten.log_sigmoid_backward",
})

#: The modules of DTensor's sharding propagation: an error raised in one of
#: them is DTensor refusing the op's layout, not the op failing.
_PROPAGATION = ("torch/distributed/tensor/_sharding_prop.py", "torch/distributed/tensor/_ops/")


def fallback_rule(func, exc: BaseException) -> str:
    """Whether the op ``func``, which raised ``exc`` under DTensor, runs
    replicated: returns the op's name where DTensor's sharding propagation
    refused it (a ``RuntimeError``, or the ``NotImplementedError`` of an op
    without a strategy, raised in the propagation's own code) and the op is
    in FALLBACK_OPS; else raises ``exc`` (an error of the op itself on its
    local shards, or a refusal of an op outside the list)."""
    name = str(func._overloadpacket)
    refused = isinstance(exc, (RuntimeError, NotImplementedError)) and any(
        m in _raised_in(e) for e in _causes(exc) for m in _PROPAGATION)
    if refused and name in FALLBACK_OPS:
        return name
    raise exc


def _causes(exc):
    """``exc`` and the exceptions it was raised from (DTensor re-raises a
    propagation error as a ``RuntimeError`` from it)."""
    while exc is not None:
        yield exc
        exc = exc.__cause__


def _raised_in(exc) -> str:
    """The file of the innermost frame of ``exc``'s traceback."""
    tb = exc.__traceback__
    while tb is not None and tb.tb_next is not None:
        tb = tb.tb_next
    return "" if tb is None else tb.tb_frame.f_code.co_filename.replace("\\", "/")


class CellCounter(TorchDispatchMode):
    """Counts, under a step on DTensors: the products' flops at their global
    shapes (the DTensor-level ops) and on the local shards (one device's
    share, also by op in ``flops_by_op``), and each collective with its
    local operand's bytes.

    Where DTensor cannot propagate an op's sharding, ``fallback_rule``
    decides: an op it lets through has the fewest mesh dims of its DTensor
    inputs replicated (``_run_replicated``; the all-gathers and all-reduces
    counted), as an SPMD partitioner falls back, and ``fallbacks`` counts it
    by op, ``fallback_replicated`` by op and the dim replicated.

    ``scaled(n)`` multiplies what is counted inside it by n (nested: the
    product), and ``scale_nodes`` what the backward of a range of autograd
    nodes runs; ``models._scan.scan`` counts a recurrence's steps so
    (``scanned``: its trip counts by name; ``walked``: the recurrences
    walked step by step, their carry not shape-stable)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._registry = flop_registry
        self._inside = False
        self._mult = [1]
        self._nodes = []  # (first, stop, n): autograd nodes whose backward counts n times
        self.flops = 0
        self.flops_global = 0
        self.flops_by_op = {}
        self.coll_counts = {k: 0 for k in COLLECTIVES}
        self.coll_bytes = {k: 0 for k in COLLECTIVES}
        self.fallbacks = {}
        self.fallback_replicated = {}
        self.scans = {}
        self.walked = {}
        self.live = LiveBytes()

    @contextlib.contextmanager
    def scaled(self, n: int):
        self._mult.append(self._mult[-1] * n)
        try:
            yield
        finally:
            self._mult.pop()

    def scale_nodes(self, first: int, stop: int, n: int) -> None:
        """What runs while the autograd engine runs a node of sequence
        number in [first, stop) counts n times (nested: the product)."""
        self._nodes.append((first, stop, n))

    def mark(self):
        return self.live.mark()

    def persist(self, start, end, n: int, nodes=None) -> None:
        self.live.persist(start, end, n, nodes)

    def _multiplier(self) -> int:
        mult = self._mult[-1]
        if self._nodes:
            node = torch._C._current_autograd_node()
            if node is not None:
                seq = node._sequence_nr()
                for first, stop, n in self._nodes:
                    if first <= seq < stop:
                        mult *= n
        return mult

    def scanned(self, name: str, n: int) -> None:
        calls = self.scans.setdefault(name, {})
        calls[n] = calls.get(n, 0) + self._mult[-1]

    def _flops(self, func, args, kwargs, out):
        count = self._registry.get(func._overloadpacket)
        return 0 if count is None else count(*args, **kwargs, out_val=out)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator) or any(
                isinstance(x, FakeTensor) for x in tree_leaves((args, kwargs))):
            # DTensor's sharding propagation runs an op on fake tensors at
            # global shapes, once per new input layout, for its output's
            # metadata: no device runs it, and counting it made the first
            # cell of a process count more than the same cell run again
            return func(*args, **kwargs)
        mult = self._multiplier()
        if any(issubclass(t, DTensor) for t in types):
            if self._inside:  # re-entered below: DTensor desugars the op
                return NotImplemented
            self._inside = True
            try:
                with self:  # the local ops and collectives come back through this mode
                    try:
                        out = func(*args, **kwargs)
                    except (RuntimeError, NotImplementedError) as e:
                        name = fallback_rule(func, e)
                        self.fallbacks[name] = self.fallbacks.get(name, 0) + mult
                        out, dims = _run_replicated(func, args, kwargs)
                        how = self.fallback_replicated.setdefault(name, {})
                        how[dims] = how.get(dims, 0) + mult
            finally:
                self._inside = False
            self.flops_global += mult * self._flops(func, args, kwargs, out)
            return out
        out = func(*args, **kwargs)
        self.live.made(out)
        packet = func._overloadpacket
        if func.namespace == "_c10d_functional" and packet.__name__ in COLLECTIVES:
            kind = packet.__name__
            self.coll_counts[kind] += mult
            self.coll_bytes[kind] += mult * args[0].numel() * args[0].element_size()
        else:
            flops = self._flops(func, args, kwargs, out)
            if flops:
                self.flops += mult * flops
                self.flops_by_op[str(packet)] = self.flops_by_op.get(str(packet), 0) + mult * flops
        return out


#: The mesh dims a fallback replicates alone, in the order tried.
FALLBACK_DIMS = ("model", "data")


def _run_replicated(func, args, kwargs):
    """``func`` run with the fewest mesh dims of its DTensor inputs
    replicated: one dim of ``FALLBACK_DIMS``, the first whose replication
    DTensor's sharding propagation accepts (the op then runs under DTensor,
    every other placement kept), else every dim (the op runs on the full
    values, its tensor outputs replicated DTensors). Returns the output and
    the dim replicated, or ``"all"``."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.utils._pytree import tree_map

    mesh = next(x.device_mesh for x in tree_leaves((args, kwargs)) if isinstance(x, DTensor))
    names = mesh.mesh_dim_names or ()
    for name in FALLBACK_DIMS:
        if name not in names:
            continue
        dim = names.index(name)

        def moved(x, dim=dim):
            return tuple(Replicate() if i == dim else p for i, p in enumerate(x.placements))

        if not any(isinstance(x, DTensor) and not x.placements[dim].is_replicate()
                   for x in tree_leaves((args, kwargs))):
            continue
        probe = tree_map(lambda x: DTensor.from_local(
            x._local_tensor, x.device_mesh, moved(x), run_check=False, shape=x.shape,
            stride=x.stride()) if isinstance(x, DTensor) else x, (args, kwargs))
        if _propagates(func, *probe):
            a, k = tree_map(lambda x: x.redistribute(x.device_mesh, moved(x))
                            if isinstance(x, DTensor) else x, (args, kwargs))
            return func(*a, **k), name
    args, kwargs = tree_map(lambda x: x.to_local() if isinstance(x, DTensor) else x,
                            _replicated((args, kwargs)))
    out = func(*args, **kwargs)
    rep = [Replicate()] * mesh.ndim
    return tree_map(lambda x: DTensor.from_local(x, mesh, rep, run_check=False)
                    if isinstance(x, torch.Tensor) else x, out), "all"


def _propagates(func, args, kwargs) -> bool:
    """Whether DTensor's sharding propagation accepts ``func`` on the
    layouts of its DTensor inputs (asked, not run: no collective, no local
    op). A refusal is ``fallback_rule``'s to judge."""
    from torch.distributed.tensor import DTensor

    dispatcher = DTensor._op_dispatcher
    try:
        dispatcher.sharding_propagator.propagate(dispatcher.unwrap_to_op_info(func, args, kwargs))
    except (RuntimeError, NotImplementedError) as e:
        fallback_rule(func, e)
        return False
    return True


def _replicated(tree):
    from torch.distributed.tensor import DTensor, Replicate
    from torch.utils._pytree import tree_map

    def one(x):
        if isinstance(x, DTensor):
            return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)
        return x

    return tree_map(one, tree)


def _world(n: int):
    """The default process group: the fake backend with ``n`` ranks."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def small_mesh(world: int, multi_pod: bool):
    """A mesh of ``world`` fake ranks with the production meshes' dims:
    (world // m, m) or (2, world // (2 m), m), m = the largest of 4, 2, 1
    that fits (the tests' and ``--world``'s small worlds)."""
    from torch.distributed.device_mesh import init_device_mesh

    pods = 2 if multi_pod else 1
    m = next(k for k in (4, 2, 1) if world % (pods * k) == 0 and world // (pods * k) >= 1)
    shape = ((pods,) if multi_pod else ()) + (world // (pods * m), m)
    names = (("pod",) if multi_pod else ()) + ("data", "model")
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


class Layout:
    """A cell's meshes: ``rules`` is the mesh the sharding rules read (the
    production mesh's dims and sizes); ``dt`` the mesh the DTensors live on.
    On a multi-pod mesh the two dp dims, which every rule names together
    (("pod", "data"), pod major), are one ``data`` dim of pod x data ranks
    in ``dt``: the same shards on the same ranks, one collective over the
    combined group (DTensor plans nested shards of one tensor dim with a
    graph search that takes minutes an op)."""

    def __init__(self, mesh):
        from torch.distributed.device_mesh import init_device_mesh

        self.rules = mesh
        sizes = R.mesh_axes(mesh)
        self.dt = mesh if "pod" not in sizes else init_device_mesh(
            "cpu", (sizes["pod"] * sizes["data"], sizes["model"]),
            mesh_dim_names=("data", "model"))

    def placements(self, spec):
        flat = tuple("data" if e == ("pod", "data") else e for e in spec)
        return R.to_placements(flat, self.dt)


def _place(tree, lay: Layout, spec_fn):
    """Meta tensors -> DTensors laid out by ``spec_fn``; returns the tree and
    one device's bytes of it."""
    from torch.distributed.tensor import distribute_tensor

    mapping = R.mesh_mapping(lay.rules)
    nbytes = [0]

    def one(path, x):
        if not isinstance(x, torch.Tensor):  # a cache's position
            return x
        spec = spec_fn(path, x, lay.rules, mapping)
        local = R.local_shape(x.shape, spec, lay.rules)
        nbytes[0] += x.element_size() * int(torch.Size(local).numel())
        return distribute_tensor(x, lay.dt, lay.placements(spec))

    return R.map_with_path(one, tree), nbytes[0]


class Step(NamedTuple):
    """A cell's step: ``run(counter)`` runs it once and returns its outputs;
    ``arguments`` the tree of its inputs; ``scale`` what the counts are
    multiplied by (the microbatches); ``reckon(counter, out, context)`` the
    memory fields where the step run stands for another (else ``None``)."""
    run: Callable
    arguments: Any
    scale: int = 1
    reckon: Optional[Callable] = None


def train_halves(model, tcfg, state, mb, counter):
    """``make_train_step(model, tcfg)(state, mb)`` at one microbatch, run as
    its two halves (``grads_of``, ``apply_update``); the live-bytes log's
    mark between them is kept in ``counter.micro_end``."""
    loss, grads = grads_of(model, state["params"], mb)
    counter.micro_end = counter.mark()
    return apply_update(tcfg, state, loss, grads)


def reckon_train(tcfg, state, counter, out, context=contextlib.nullcontext):
    """The memory fields of the train step at A > 1 microbatches from
    ``counter``'s run of ``train_halves`` at one (``out`` what it returned,
    still live): the f32 accumulators (``accumulators``) and the update on
    them run under ``context()`` and a count of their own, and one
    microbatch's log is set between them (``memory.reckon_microbatches``)."""
    upd = CellCounter()
    upd.live.arguments(state)
    with context(), upd:
        loss, grads = accumulators(state["params"])
        start = upd.mark()[0]
        upd_out = apply_update(tcfg, state, loss, grads)
    return reckon_microbatches(counter.live, counter.micro_end, out, upd.live, start, upd_out)


def _train(cfg, model, mesh, shape, rec):
    A = microbatches_for(cfg, shape)
    if shape.global_batch % A:  # the smoke shapes' batch of 2
        A = 1
    tcfg = TrainCfg(microbatches=1, moment_dtype=cfg.moment_dtype)
    params, p_bytes = _place(S.params_specs(model), mesh, R.param_spec)
    mdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.moment_dtype]
    opt_meta = adamw.init(S.params_specs(model), mdt)
    opt_m, m_bytes = _place(opt_meta.m, mesh, R.param_spec)
    opt_v, v_bytes = _place(opt_meta.v, mesh, R.param_spec)
    from torch.distributed.tensor import Replicate, distribute_tensor

    step = distribute_tensor(opt_meta.step, mesh.dt, [Replicate()] * mesh.dt.ndim)
    state = {"params": params, "opt": adamw.AdamWState(m=opt_m, v=opt_v, step=step)}
    full_batch = S.train_batch_specs(cfg, shape)
    _, batch_bytes = _place(full_batch, mesh, R.batch_spec)
    mb = {k: torch.empty((v.shape[0] // A, *v.shape[1:]), dtype=v.dtype, device=v.device)
          for k, v in full_batch.items()}
    mb, _ = _place(mb, mesh, R.batch_spec)
    rec["microbatches"] = A
    rec["argument_size_in_bytes"] = p_bytes + m_bytes + v_bytes + batch_bytes
    return Step(run=lambda counter: train_halves(model, tcfg, state, mb, counter),
                arguments=(state, mb), scale=A,
                reckon=None if A == 1 else (
                    lambda counter, out, context: reckon_train(tcfg, state, counter, out,
                                                               context)))


def _prefill(cfg, model, mesh, shape, rec):
    params, p_bytes = _place(S.params_specs(model), mesh, R.param_spec)
    batch, b_bytes = _place(S.prefill_batch_specs(cfg, shape), mesh, R.batch_spec)
    rec["argument_size_in_bytes"] = p_bytes + b_bytes
    return Step(run=lambda counter: model.prefill(params, batch), arguments=(params, batch))


def serve_layout() -> str:
    """``REPRO_SERVE_SHARDING``: "v2" lays a decode cell's cache and tokens
    out weight-stationary (``serve_cache_spec``, ``serve_batch_spec``: the
    batch on the model dim, the cache's sequence on the data dims), else
    "v1" (``cache_spec``, ``batch_spec``), as the reference's dry run reads it."""
    return "v2-weight-stationary" if os.environ.get("REPRO_SERVE_SHARDING", "v1") == "v2" else "v1"


def _decode(cfg, model, mesh, shape, rec):
    rec["serve_sharding"] = serve_layout()
    v2 = rec["serve_sharding"] != "v1"
    params, p_bytes = _place(S.params_specs(model), mesh, R.param_spec)
    cache_meta, tokens_meta = S.decode_specs(model, cfg, shape)
    cache, c_bytes = _place(cache_meta, mesh, R.serve_cache_spec if v2 else R.cache_spec)
    tokens, t_bytes = _place(tokens_meta, mesh, R.serve_batch_spec if v2 else R.batch_spec)
    rec["argument_size_in_bytes"] = p_bytes + c_bytes + t_bytes
    return Step(run=lambda counter: model.decode_step(params, cache, tokens),
                arguments=(params, cache, tokens))


def step_cell(cfg: ArchConfig, shape, mesh, mesh_name: str, scan_once: bool = True):
    """Lay out one cell on ``mesh`` (a ``Layout``), run its step once under
    the counter, and return its record. ``scan_once``: each recurrence's
    steps counted from three of them (``models._scan``); else walked."""
    from torch.distributed.tensor.experimental import implicit_replication

    model = build_model(cfg, remat="full" if shape.kind == "train" else "none")
    rec = {}
    t0 = time.perf_counter()
    build = {"train": _train, "prefill": _prefill, "decode": _decode}[shape.kind]
    step = build(cfg, model, mesh, shape, rec)
    scale = step.scale
    rec["layout_s"] = round(time.perf_counter() - t0, 1)
    t1 = time.perf_counter()
    counter = CellCounter()
    counter.live.arguments(step.arguments)
    once = count_once(counter) if scan_once else contextlib.nullcontext()

    # DTensors cannot be made in inference mode: prefill and decode run
    # under no_grad here (the same values, no graph either)
    @contextlib.contextmanager
    def context():
        with use_mesh(mesh.dt), implicit_replication(), inference_as(torch.no_grad):
            yield

    with context(), once, counter:
        out = step.run(counter)
    rec["step_s"] = round(time.perf_counter() - t1, 1)
    mem = counter.live.summary(out) if step.reckon is None else step.reckon(counter, out, context)
    del out
    rec["scan_counted_once"] = bool(scan_once)
    rec["scan_trips"] = {k: {str(n): c * scale for n, c in v.items()}
                         for k, v in counter.scans.items()}
    rec["scan_walked"] = {k: v * scale for k, v in counter.walked.items()}
    rec["flops"] = float(counter.flops * scale)
    rec["flops_global"] = float(counter.flops_global * scale)
    rec["flops_by_op"] = {k: float(v * scale) for k, v in sorted(counter.flops_by_op.items())}
    rec["collective_counts"] = {k: v * scale for k, v in counter.coll_counts.items()}
    rec["collective_bytes"] = {k: v * scale for k, v in counter.coll_bytes.items()}
    rec["fallbacks"] = {k: v * scale for k, v in counter.fallbacks.items()}
    rec["fallback_replicated"] = {k: {d: n * scale for d, n in v.items()}
                                  for k, v in counter.fallback_replicated.items()}
    rec["output_size_in_bytes"] = mem["output_size_in_bytes"]
    rec["temp_size_in_bytes"] = mem["temp_size_in_bytes"]
    rec["peak_above_arguments_in_bytes"] = mem["peak_bytes"]
    rec["generated_code_size_in_bytes"] = None
    rec["bytes_accessed"] = None
    rec["mesh"] = mesh_name
    rec["mesh_shape"] = dict(R.mesh_axes(mesh.rules))
    rec["dtensor_mesh_shape"] = dict(R.mesh_axes(mesh.dt))
    rec["devices"] = int(mesh.dt.size())
    return rec


def step_memory(run, arguments) -> dict:
    """The memory fields of ``run()`` on one rank with no DTensor (meta, CPU
    or CUDA tensors), ``arguments`` the tree of its inputs: the count that
    predicts a step's peak above its arguments on a card."""
    counter = CellCounter()
    counter.live.arguments(arguments)
    with counter:
        out = run()
    return counter.live.summary(out)


def train_memory(model, tcfg, state, mb, microbatches: int = 1) -> dict:
    """The memory fields of ``make_train_step(model, tcfg)``'s step on
    ``microbatches`` microbatches of ``mb``'s size, from one microbatch run
    (``train_halves``, then ``reckon_train`` where there are more), on one
    rank with no DTensor."""
    counter = CellCounter()
    counter.live.arguments((state, mb))
    with counter:
        out = train_halves(model, tcfg, state, mb, counter)
    if microbatches == 1:
        return counter.live.summary(out)
    return reckon_train(tcfg, state, counter, out)


class CellTimeout(Exception):
    pass


def _on_alarm(signum, frame):
    raise CellTimeout()


def run_cell(arch: str, shape_name: str, mesh_name: str, out_dir: Path, force=False,
             smoke=False, world=None, timeout=0, scan_once=True):
    cell_id = f"{arch}__{shape_name}__{mesh_name}" + ("__smoke" if smoke else "")
    out_path = out_dir / f"{cell_id}.json"
    if out_path.exists() and not force:
        print(f"[skip cached] {cell_id}")
        return json.loads(out_path.read_text())
    cfg = get_config(arch, smoke=smoke)
    shape = (SMOKE_SHAPES if smoke else SHAPES)[shape_name]
    ok, why = applicable(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "kind": shape.kind}
    if not ok:
        rec.update({"status": "SKIP", "reason": why})
    else:
        multi = mesh_name == "multi"
        try:
            if timeout:
                signal.signal(signal.SIGALRM, _on_alarm)
                signal.alarm(timeout)
            if world is None:
                _world(512 if multi else 256)
                mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
            else:
                _world(world)
                mesh = small_mesh(world, multi)
            rec.update(step_cell(cfg, shape, Layout(mesh), mesh_name, scan_once=scan_once))
            rec["status"] = "OK"
            tokens = shape.global_batch * (1 if shape.kind == "decode" else shape.seq_len)
            rec["model_flops_6nd"] = 6.0 * cfg.active_params() * tokens
            rec["n_params"] = cfg.n_params()
            rec["active_params"] = cfg.active_params()
        except CellTimeout:
            rec["status"] = "TIMEOUT"
            rec["error"] = f"the step did not end within --cell-timeout {timeout} s"
            rec["traceback"] = traceback.format_exc()[-4000:]
        except Exception as e:  # a failure here is a fault of the port, recorded
            rec["status"] = "FAIL"
            rec["error"] = f"{type(e).__name__}: {e}"[:2000]
            rec["traceback"] = traceback.format_exc()[-4000:]
        finally:
            if timeout:
                signal.alarm(0)
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(rec, indent=1))
    extra = "" if rec["status"] != "OK" else (
        f" step={rec['step_s']}s flops/device={rec['flops']:.3g} "
        f"args/device={rec['argument_size_in_bytes'] / 1e9:.3f} GB "
        f"temp/device={rec['temp_size_in_bytes'] / 1e9:.3f} GB "
        f"out/device={rec['output_size_in_bytes'] / 1e9:.3f} GB")
    if rec["status"] in ("FAIL", "TIMEOUT"):
        extra = " " + rec["error"].splitlines()[0][:300]
    print(f"[{rec['status']}] {cell_id}{extra}", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single,multi")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke configs and shapes (with --world: a quick check)")
    ap.add_argument("--cell-timeout", type=int, default=900,
                    help="seconds a cell may take (0: no limit); a cell past it is a TIMEOUT")
    ap.add_argument("--world", type=int, default=None,
                    help="a small fake world in place of the production meshes' 256 / 512")
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    archs = list_archs() if (args.all or args.arch is None) else args.arch.split(",")
    shapes = list(SHAPES) if (args.all or args.shape is None) else args.shape.split(",")
    meshes = args.mesh.split(",")

    t0 = time.perf_counter()
    n_fail = 0
    try:
        for arch in archs:
            for shape in shapes:
                for mesh_name in meshes:
                    rec = run_cell(arch, shape, mesh_name, out_dir, force=args.force,
                                   smoke=args.smoke, world=args.world,
                                   timeout=args.cell_timeout)
                    n_fail += rec["status"] in ("FAIL", "TIMEOUT")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print(f"done in {time.perf_counter() - t0:.1f} s; failures: {n_fail}")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
