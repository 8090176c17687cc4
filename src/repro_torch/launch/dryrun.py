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
     the global norm's all-reduces, are so counted once a microbatch);
  5. one JSON record per cell goes to ``--out`` (a results cache: cells
     already there are skipped unless ``--force``); a cell whose step runs
     past ``--cell-timeout`` seconds is recorded as a TIMEOUT (the eager
     stand-in walks a recurrence token by token where the reference's
     compile scans it once).

What the stand-in cannot see is ``null`` in the record: XLA's temp and
generated-code sizes (``temp_size_in_bytes``,
``generated_code_size_in_bytes``), its ``bytes accessed``, and collectives
that a compiler would insert or fuse beyond the DTensors' own.
``argument_size_in_bytes`` is one device's shards of every input (params,
moments and batch; params, batch; or params, cache and tokens).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch internlm2-1.8b \\
      --shape train_4k --mesh single,multi --out results/dryrun_torch
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --smoke --world 8   # small
"""
from __future__ import annotations

import argparse
import contextlib
import json
import signal
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs import SHAPES, SMOKE_SHAPES, applicable, get_config, list_archs
from repro_torch.configs.base import ArchConfig
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model
from repro_torch.optim import adamw
from repro_torch.sharding import rules as R
from repro_torch.sharding.hints import use_mesh
from repro_torch.train import TrainCfg, make_train_step

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


class CellCounter(TorchDispatchMode):
    """Counts, under a step on DTensors: the products' flops at their global
    shapes (the DTensor-level ops) and on the local shards (one device's
    share), and each collective with its local operand's bytes.

    Where DTensor cannot propagate an op's sharding (a view that merges a
    sharded dim, an op with no sharding strategy), the op's DTensor inputs
    are replicated (the all-gathers and all-reduces counted) and the op runs
    replicated, as an SPMD partitioner falls back; ``fallbacks`` counts them
    by op."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._registry = flop_registry
        self._inside = False
        self.flops = 0
        self.flops_global = 0
        self.coll_counts = {k: 0 for k in COLLECTIVES}
        self.coll_bytes = {k: 0 for k in COLLECTIVES}
        self.fallbacks = {}

    def _fallback(self, func):
        name = str(func._overloadpacket)
        self.fallbacks[name] = self.fallbacks.get(name, 0) + 1

    def _flops(self, func, args, kwargs, out):
        count = self._registry.get(func._overloadpacket)
        return 0 if count is None else count(*args, **kwargs, out_val=out)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            if self._inside:  # re-entered below: DTensor desugars the op
                return NotImplemented
            self._inside = True
            try:
                with self:  # the local ops and collectives come back through this mode
                    if func is torch.ops.aten.gather.default and _sharded_on(args[0], args[1]):
                        # DTensor's gather along a sharded dim masks on the local
                        # values (torch.equal), which the meta device cannot run
                        self._fallback(func)
                        args, kwargs = _replicated((args, kwargs))
                    try:
                        out = func(*args, **kwargs)
                    except (RuntimeError, NotImplementedError) as e:
                        msg = str(e)
                        if "harding" not in msg and "redistribut" not in msg:
                            raise
                        self._fallback(func)
                        out = _run_replicated(func, args, kwargs)
            finally:
                self._inside = False
            self.flops_global += self._flops(func, args, kwargs, out)
            return out
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if func.namespace == "_c10d_functional" and packet.__name__ in COLLECTIVES:
            kind = packet.__name__
            self.coll_counts[kind] += 1
            self.coll_bytes[kind] += args[0].numel() * args[0].element_size()
        else:
            self.flops += self._flops(func, args, kwargs, out)
        return out


def _sharded_on(x, dim):
    from torch.distributed.tensor import Shard

    dim = dim % x.ndim
    return any(isinstance(p, Shard) and p.dim == dim for p in getattr(x, "placements", ()))


@contextlib.contextmanager
def _inference_as_no_grad():
    """The models' ``prefill`` and ``decode_step`` enter
    ``torch.inference_mode()``, in which DTensors cannot be made; inside this
    block it is ``torch.no_grad()`` (the same values, no graph either)."""
    saved = torch.inference_mode
    torch.inference_mode = torch.no_grad
    try:
        yield
    finally:
        torch.inference_mode = saved


def _run_replicated(func, args, kwargs):
    """``func`` on the full (replicated) values of its DTensor inputs, run on
    their local tensors, its tensor outputs replicated DTensors."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.utils._pytree import tree_map

    mesh = next(x.device_mesh for x in tree_leaves((args, kwargs)) if isinstance(x, DTensor))
    args, kwargs = tree_map(lambda x: x.to_local() if isinstance(x, DTensor) else x,
                            _replicated((args, kwargs)))
    out = func(*args, **kwargs)
    rep = [Replicate()] * mesh.ndim
    return tree_map(lambda x: DTensor.from_local(x, mesh, rep, run_check=False)
                    if isinstance(x, torch.Tensor) else x, out)


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
    return lambda: make_train_step(model, tcfg)(state, mb), A


def _prefill(cfg, model, mesh, shape, rec):
    params, p_bytes = _place(S.params_specs(model), mesh, R.param_spec)
    batch, b_bytes = _place(S.prefill_batch_specs(cfg, shape), mesh, R.batch_spec)
    rec["argument_size_in_bytes"] = p_bytes + b_bytes
    return lambda: model.prefill(params, batch), 1


def _decode(cfg, model, mesh, shape, rec):
    params, p_bytes = _place(S.params_specs(model), mesh, R.param_spec)
    cache_meta, tokens_meta = S.decode_specs(model, cfg, shape)
    cache, c_bytes = _place(cache_meta, mesh, R.cache_spec)
    tokens, t_bytes = _place(tokens_meta, mesh, R.batch_spec)
    rec["argument_size_in_bytes"] = p_bytes + c_bytes + t_bytes
    return lambda: model.decode_step(params, cache, tokens), 1


def step_cell(cfg: ArchConfig, shape, mesh, mesh_name: str):
    """Lay out one cell on ``mesh`` (a ``Layout``), run its step once under
    the counter, and return its record."""
    from torch.distributed.tensor.experimental import implicit_replication

    model = build_model(cfg, remat="full" if shape.kind == "train" else "none")
    rec = {}
    t0 = time.perf_counter()
    build = {"train": _train, "prefill": _prefill, "decode": _decode}[shape.kind]
    run, scale = build(cfg, model, mesh, shape, rec)
    rec["layout_s"] = round(time.perf_counter() - t0, 1)
    t1 = time.perf_counter()
    counter = CellCounter()
    with use_mesh(mesh.dt), implicit_replication(), _inference_as_no_grad(), counter:
        run()
    rec["step_s"] = round(time.perf_counter() - t1, 1)
    rec["flops"] = float(counter.flops * scale)
    rec["flops_global"] = float(counter.flops_global * scale)
    rec["collective_counts"] = {k: v * scale for k, v in counter.coll_counts.items()}
    rec["collective_bytes"] = {k: v * scale for k, v in counter.coll_bytes.items()}
    rec["fallbacks"] = {k: v * scale for k, v in counter.fallbacks.items()}
    for k in ("output_size_in_bytes", "temp_size_in_bytes", "generated_code_size_in_bytes",
              "bytes_accessed"):
        rec[k] = None
    rec["mesh"] = mesh_name
    rec["mesh_shape"] = dict(R.mesh_axes(mesh.rules))
    rec["dtensor_mesh_shape"] = dict(R.mesh_axes(mesh.dt))
    rec["devices"] = int(mesh.dt.size())
    return rec


class CellTimeout(Exception):
    pass


def _on_alarm(signum, frame):
    raise CellTimeout()


def run_cell(arch: str, shape_name: str, mesh_name: str, out_dir: Path, force=False,
             smoke=False, world=None, timeout=0):
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
            rec.update(step_cell(cfg, shape, Layout(mesh), mesh_name))
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
        f"args/device={rec['argument_size_in_bytes'] / 1e9:.3f} GB")
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
