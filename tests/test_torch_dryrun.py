"""The dry run's repairs, on small fake worlds (each world in a subprocess:
torch's fake process group is global to its process).

- The cells that failed or timed out before (a MoE train cell's gradient
  view, Whisper's vocab-sharded gather on the multi-pod mesh, the xLSTM's
  recurrences walked token by token) step OK at full width and cut depth on
  the smallest fake worlds that reproduced them (64, 128 and 8 ranks).
- A recurrence counted once and scaled (``models._scan``) gives, per op,
  the counts of walking every step: flops by op, collectives and their
  bytes, fallbacks, and one device's output, temp and peak bytes. A cell's
  counts do not depend on the cells run before it in the process.
- ``REPRO_SERVE_SHARDING=v2`` lays a decode cell's cache and tokens out by
  the serve rules (weight-stationary) and records it.
- The replication fallback is decided by ``fallback_rule`` alone: an op of
  its pinned allow-list that DTensor's sharding propagation refuses runs
  replicated; any other op, or an error of the op itself, raises. It
  replicates the fewest mesh dims it must: a head view refused on the
  model dim keeps its data shard (8 gloo ranks, CPU values).
- A data-only mesh (4 data x 1 model fake ranks, global batch 8, every
  param replicated: data parallelism without FSDP) counts per device what
  one rank counts at batch 2 with no DTensor: no buffer is made at the
  global batch (the caches, attention's carries, the recurrences' states).
  The MoE's dispatch, global by its semantics, is the one pinned gap.
- ``cache_hint`` on a mesh makes each device's shard alone.
- No module of the port assigns to ``torch.inference_mode``.
"""
import ast
import json
import multiprocessing
import os
import pickle
import subprocess
import sys
from contextlib import nullcontext
from pathlib import Path

import pytest
import torch

from repro_torch.launch import dryrun as D

ROOT = Path(__file__).resolve().parents[1]

_FAULTS = r"""
import dataclasses, json
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun as D

out = {}
for name, arch, shape, mesh_name, layers, world in (
        ("C7", "qwen3-moe-30b-a3b", "train_4k", "single", 1, 64),
        ("C8", "whisper-base", "train_4k", "multi", 1, 128),
        ("C9", "xlstm-125m", "train_4k", "single", 4, 8)):
    cfg = get_config(arch)
    kw = {"n_layers": layers}
    if cfg.n_encoder_layers:
        kw["n_encoder_layers"] = layers
    cfg = dataclasses.replace(cfg, **kw)
    D._world(world)
    try:
        rec = D.step_cell(cfg, SHAPES[shape], D.Layout(D.small_mesh(world, mesh_name == "multi")),
                          mesh_name)
        out[name] = dict(status="OK", **{k: rec[k] for k in (
            "step_s", "fallbacks", "scan_trips", "scan_counted_once", "flops", "devices")})
    except Exception as e:
        out[name] = dict(status="FAIL", error=f"{type(e).__name__}: {e}"[:500])
print(json.dumps(out))
"""

_SCANS = r"""
import json
from pathlib import Path
import tempfile
import torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.launch import dryrun as D

keys = ("flops", "flops_global", "flops_by_op", "collective_counts", "collective_bytes",
        "fallbacks", "status", "output_size_in_bytes", "temp_size_in_bytes",
        "peak_above_arguments_in_bytes")
out = {}
tmp = Path(tempfile.mkdtemp())
for arch, shape in (("xlstm-125m", "train_4k"), ("xlstm-125m", "prefill_32k"),
                    ("zamba2-1.2b", "decode_32k")):
    once = D.run_cell(arch, shape, "single", tmp / "once", force=True, smoke=True, world=8)
    walk = D.run_cell(arch, shape, "single", tmp / "walk", force=True, smoke=True, world=8,
                      scan_once=False)
    out[f"{arch}/{shape}"] = dict(once={k: once.get(k) for k in keys + ("scan_trips",)},
                                  walk={k: walk.get(k) for k in keys})
again = D.run_cell("zamba2-1.2b", "decode_32k", "single", tmp / "again", force=True, smoke=True,
                   world=8)
out["again"] = {k: again.get(k) for k in keys}

# A view DTensor's propagation refuses (it would split a dim sharded over 4
# ranks into an outer dim of 2) falls back; the same refusal for an op
# outside the allow-list, and the op failing on its own, raise.
D._world(8)
mesh = D.small_mesh(8, False)
x = distribute_tensor(torch.empty((4, 8), device="meta"), mesh, [Replicate(), Shard(1)])
rule = {}
try:
    x.view(4, 2, 4)
    rule["refused"] = None
except (RuntimeError, NotImplementedError) as e:
    rule["refused"] = D.fallback_rule(torch.ops.aten.view.default, e)
    try:
        D.fallback_rule(torch.ops.aten.mm.default, e)
        rule["outside"] = "fell back"
    except type(e):
        rule["outside"] = "raised"
try:
    torch.empty((3, 4), device="meta").view(5)
except RuntimeError as e:
    try:
        D.fallback_rule(torch.ops.aten.view.default, e)
        rule["own_error"] = "fell back"
    except RuntimeError:
        rule["own_error"] = "raised"
out["rule"] = rule
print(json.dumps(out))
"""

_SERVE_V2 = r"""
import json, os, tempfile
from pathlib import Path
from repro_torch.configs import SMOKE_SHAPES, get_config
from repro_torch.launch import dryrun as D
from repro_torch.models import build_model
from repro_torch.sharding import rules as R
from repro_torch.sharding.rules import map_with_path

out = {}
tmp = Path(tempfile.mkdtemp())
for layout in ("v1", "v2"):
    os.environ["REPRO_SERVE_SHARDING"] = layout
    for arch in ("internlm2-1.8b", "zamba2-1.2b"):
        for mesh_name in ("single", "multi"):
            rec = D.run_cell(arch, "decode_32k", mesh_name, tmp / layout, force=True, smoke=True,
                             world=8)
            cfg = get_config(arch, smoke=True)
            lay = D.Layout(D.small_mesh(8, mesh_name == "multi"))
            step = D._decode(cfg, build_model(cfg), lay, SMOKE_SHAPES["decode_32k"], {})
            _, cache, tokens = step.arguments
            cspec = R.serve_cache_spec if layout == "v2" else R.cache_spec
            bspec = R.serve_batch_spec if layout == "v2" else R.batch_spec
            mapping = R.mesh_mapping(lay.rules)
            placed = []
            def check(path, x, spec_fn):
                if hasattr(x, "placements"):
                    want = lay.placements(spec_fn(path, x, lay.rules, mapping))
                    placed.append([str(p) for p in x.placements] == [str(p) for p in want])
                return x
            map_with_path(lambda p, x: check(p, x, cspec), cache)
            check((), tokens, bspec)
            out[f"{layout}/{arch}/{mesh_name}"] = dict(
                status=rec["status"], serve_sharding=rec.get("serve_sharding"),
                placed=placed, temp=rec.get("temp_size_in_bytes"),
                sharded_batch=[str(p) for p in tokens.placements])
print(json.dumps(out))
"""


_DATA_MESH = r"""
import json, sys
import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor
from repro_torch._device import inference_as
from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import dryrun as D, specs as S
from repro_torch.models import build_model
from repro_torch.optim import adamw
from repro_torch.sharding import rules as R
from repro_torch.sharding.hints import use_mesh
from repro_torch.train import TrainCfg
from dryrun_peak import Tracer

# data parallelism without FSDP (every param replicated) at one microbatch:
# each device's share of the step is one rank's step on its batch shard
D.microbatches_for = lambda cfg, shape: 1
R.param_spec = lambda path, leaf, mesh, mapping=None: (None,) * leaf.ndim
D._world(4)
mesh = init_device_mesh("cpu", (4, 1), mesh_dim_names=("data", "model"))
SEQ = {"prefill": 128, "decode": 128, "train": 64}
mem = lambda m: [m["temp_size_in_bytes"], m["output_size_in_bytes"]]
out = {}
for arch in ("internlm2-1.8b", "qwen3-moe-30b-a3b", "zamba2-1.2b", "whisper-base", "xlstm-125m"):
    cfg = get_config(arch, smoke=True)
    for kind in ("prefill", "decode", "train"):
        with Tracer() as tracer:
            rec = D.step_cell(cfg, ShapeSpec(kind, kind, SEQ[kind], 8), D.Layout(mesh), "single")
        peak = [[b, *made] for b, made in tracer.largest(12)]
        model = build_model(cfg, remat="full" if kind == "train" else "none")
        params = S.params_specs(model)
        shape = ShapeSpec(kind, kind, SEQ[kind], 2)
        if kind == "train":
            mdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.moment_dtype]
            state = {"params": params, "opt": adamw.init(params, mdt)}
            one = D.train_memory(model, TrainCfg(moment_dtype=cfg.moment_dtype), state,
                                 S.train_batch_specs(cfg, shape))
        else:  # the dry run's own context: no_grad in place of inference mode
            if kind == "prefill":
                batch = S.prefill_batch_specs(cfg, shape)
                run, args = (lambda: model.prefill(params, batch)), (params, batch)
            else:
                cache, tokens = S.decode_specs(model, cfg, shape)
                run = lambda: model.decode_step(params, cache, tokens)
                args = (params, cache, tokens)
            with inference_as(torch.no_grad):
                one = D.step_memory(run, args)
        out[f"{arch}/{kind}"] = dict(
            mesh=mem(rec), one=mem(one),
            all_reduce=rec["collective_bytes"]["all_reduce"], fallbacks=rec["fallbacks"],
            peak=peak)

# cache_hint on a (2 data, 2 model) mesh: every leaf a DTensor of the
# global shape laid out by cache_spec, its storage the local shard alone
mesh2 = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
mapping = R.mesh_mapping(mesh2)
for arch in ("internlm2-1.8b", "zamba2-1.2b", "whisper-base", "xlstm-125m"):
    model = build_model(get_config(arch, smoke=True))
    plain = dict(R.tree_paths(model.init_cache(8, 16, device="meta")))
    counter = D.CellCounter()
    counter.live.arguments(torch.empty(0, device="meta"))  # the device counted
    with use_mesh(mesh2), counter:
        cache = model.init_cache(8, 16, device="meta")
    leaves, shard_bytes = [], 0
    for path, x in R.tree_paths(cache):
        spec = R.cache_spec(path, x, mesh2, mapping)
        local = R.local_shape(x.shape, spec, mesh2)
        shard_bytes += x.element_size() * int(torch.Size(local).numel())
        leaves.append(isinstance(x, DTensor) and x.shape == plain[path].shape
                      and x.dtype == plain[path].dtype
                      and tuple(x.placements) == R.to_placements(spec, mesh2)
                      and tuple(x._local_tensor.shape) == tuple(local))
    made = counter.live.summary(cache)
    out[f"cache/{arch}"] = dict(leaves=leaves, shard_bytes=shard_bytes,
                                largest=max(d for _, d in counter.live.deltas()), **made)
print(json.dumps(out))
"""


def _view_rank(rank, path):
    """One of 8 gloo ranks: a (4, S, 4, hd) tensor sharded (Shard(0),
    Shard(2)) on a (2 data, 4 model) mesh, reshaped under the counter into
    (4, S, 2, 2, hd): DTensor refuses the view (4 model-sharded heads split
    2 x 2); the fallback replicates the model dim alone."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{path}/store", rank=rank, world_size=8)
    try:
        mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
        full = torch.randn((4, 6, 4, 8), generator=torch.Generator().manual_seed(0))
        x = distribute_tensor(full, mesh, [Shard(0), Shard(2)])
        counter = D.CellCounter()
        with counter:
            y = x.reshape(4, 6, 2, 2, 8)
        got = y.full_tensor()
        out = dict(local=tuple(y.to_local().shape), placements=[repr(p) for p in y.placements],
                   fallbacks=counter.fallbacks, replicated=counter.fallback_replicated,
                   gathers=counter.coll_counts["all_gather_into_tensor"],
                   equal=torch.equal(got, full.reshape(4, 6, 2, 2, 8)))
        with open(f"{path}/rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs():
    """The subprocesses, started together; each one's JSON line."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tools")]))
    env.pop("REPRO_SERVE_SHARDING", None)
    procs = {name: subprocess.Popen([sys.executable, "-c", code], env=env, cwd=ROOT, text=True,
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for name, code in (("faults", _FAULTS), ("scans", _SCANS), ("serve", _SERVE_V2),
                                ("data_mesh", _DATA_MESH))}
    out = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=400)
        assert proc.returncode == 0, stdout[-3000:] + stderr[-3000:]
        out[name] = json.loads(stdout.strip().splitlines()[-1])
    return out


@pytest.fixture(scope="module")
def faults(runs):
    return runs["faults"]


@pytest.fixture(scope="module")
def scans(runs):
    return runs["scans"]


@pytest.mark.parametrize("fault", ["C7", "C8", "C9"])
def test_repaired_cells_step_ok_on_small_fake_worlds(faults, fault):
    """C7 (qwen3-moe-30b-a3b's train cell on a (16, 4) mesh: the MoE
    tokens' gradient laid out as nested shards that DTensor viewed back to
    (B, S, D) with a wrong local shape), C8 (whisper-base's on a (2, 16, 4)
    mesh: the target logit's vocab-sharded gather) and C9 (xlstm-125m's,
    whose sLSTM walked 4,096 tokens of DTensor ops) at full width and cut
    depth step OK; C9's recurrence counted once, with its trip count."""
    rec = faults[fault]
    assert rec["status"] == "OK", rec
    assert rec["flops"] > 0 and rec["scan_counted_once"] is True
    if fault == "C9":
        assert set(rec["scan_trips"]) == {"slstm"}
        assert set(rec["scan_trips"]["slstm"]) == {"4096"}
        assert rec["step_s"] < 120
    assert set(rec["fallbacks"]) <= D.FALLBACK_OPS


@pytest.mark.parametrize("cell", ["xlstm-125m/train_4k", "xlstm-125m/prefill_32k",
                                  "zamba2-1.2b/decode_32k"])
def test_scan_once_counts_equal_walking_every_step(scans, cell):
    """Per op, the counts of a cell whose recurrences are counted once and
    scaled equal those of walking every step, and so do one device's
    output, temp and peak bytes: the xLSTM's train cell (the sLSTM forward,
    its remat recompute and backward, 64 tokens), its prefill (the mLSTM
    with a state and the sLSTM, 128 tokens), and Zamba2's decode (one
    token: the recurrence is walked either way)."""
    once, walk = scans[cell]["once"], scans[cell]["walk"]
    assert once.pop("scan_trips") == ({} if cell.startswith("zamba2") else once_trips(cell))
    assert once == walk
    assert once["status"] == "OK" and sum(once["flops_by_op"].values()) == once["flops"]
    assert once["output_size_in_bytes"] > 0 and once["temp_size_in_bytes"] > 0


@pytest.mark.parametrize("s", [4, 7])
def test_mamba2_recurrence_counted_once_equals_the_walk(s):
    """Mamba2's token recurrence (``_ssd_sequential``: decode, and prefill
    lengths not a multiple of the chunk) over s > 3 tokens, forward and
    backward: counted once and scaled, its flops by op equal those of
    walking every step, and its trips are recorded."""
    import torch

    from repro_torch.models._scan import count_once
    from repro_torch.models.mamba2 import _ssd_sequential

    g = torch.Generator().manual_seed(s)
    shapes = {"x": (2, s, 3, 4), "dt": (2, s, 3), "A_log": (3,), "B": (2, s, 5), "C": (2, s, 5)}
    counts = {}
    for once in (True, False):
        ins = {k: torch.randn(v, generator=g).requires_grad_() for k, v in shapes.items()}
        counter = D.CellCounter()
        with counter, count_once(counter) if once else nullcontext():
            y, st = _ssd_sequential(ins["x"], ins["dt"].abs(), ins["A_log"], ins["B"], ins["C"])
            (y.sum() + st.sum()).backward()
        assert y.shape == (2, s, 3, 4) and st.shape == (2, 3, 4, 5)
        counts[once] = (counter.flops_by_op, counter.flops, counter.scans, counter.walked)
    assert counts[True][0] == counts[False][0] and counts[True][1] == counts[False][1] > 0
    assert counts[True][2:] == ({"mamba2": {s: 1}}, {}) and counts[False][2:] == ({}, {})


def once_trips(cell):
    return {"xlstm-125m/train_4k": {"slstm": {"64": 4}},
            "xlstm-125m/prefill_32k": {"mlstm": {"128": 2}, "slstm": {"128": 2}}}[cell]


def test_cell_counts_do_not_depend_on_the_cells_before(scans):
    """Zamba2's decode cell counts the same after five other cells in the
    process as first: DTensor's sharding propagation runs each op on fake
    tensors at global shapes for a new input layout, and the counter leaves
    those out."""
    assert scans["again"] == scans["zamba2-1.2b/decode_32k"]["walk"]


@pytest.mark.parametrize("cell", ["internlm2-1.8b/single", "internlm2-1.8b/multi",
                                  "zamba2-1.2b/single", "zamba2-1.2b/multi"])
def test_serve_v2_decode_cells_lay_out_cache_and_tokens_by_the_serve_rules(runs, cell):
    """With ``REPRO_SERVE_SHARDING=v2`` a dense and a hybrid arch's decode
    cells on 8 fake ranks step OK, record ``"v2-weight-stationary"``, and
    every cache leaf and the tokens carry the placements of
    ``serve_cache_spec`` / ``serve_batch_spec`` (the tokens' batch on the
    model dim); without it, ``"v1"`` and ``cache_spec`` / ``batch_spec``."""
    serve = runs["serve"]
    v1, v2 = serve[f"v1/{cell}"], serve[f"v2/{cell}"]
    assert v1["status"] == v2["status"] == "OK"
    assert (v1["serve_sharding"], v2["serve_sharding"]) == ("v1", "v2-weight-stationary")
    for rec in (v1, v2):
        assert rec["placed"] and all(rec["placed"]) and rec["temp"] > 0
    assert v1["sharded_batch"] != v2["sharded_batch"]


def test_fallback_allow_list_is_pinned_and_decides(scans):
    """The ops that may run replicated, pinned: the cells of the smoke and
    production dry runs fall back on these and no others (PERF.md). A view
    DTensor refuses falls back; the same refusal for an op outside the list,
    and a view that fails on its own shards, raise."""
    assert D.FALLBACK_OPS == frozenset({"aten.view", "aten.log_sigmoid_backward"})
    assert scans["rule"] == {"refused": "aten.view", "outside": "raised", "own_error": "raised"}


def _raise_in(filename, exc):
    """Raise ``exc`` from a frame whose code lies in ``filename``."""
    scope = {}
    exec(compile("def boom(e):\n    raise e\n", filename, "exec"), scope)
    try:
        scope["boom"](exc)
    except type(exc) as e:
        return e


@pytest.mark.parametrize("where,cause,op,want", [
    ("torch/distributed/tensor/_ops/_view_ops.py", False, "aten.view", "aten.view"),
    ("torch/distributed/tensor/_sharding_prop.py", False, "aten.log_sigmoid_backward",
     "aten.log_sigmoid_backward"),
    ("torch/distributed/tensor/_ops/_view_ops.py", True, "aten.view", "aten.view"),
    ("torch/distributed/tensor/_ops/_view_ops.py", False, "aten.gather", None),
    ("torch/_ops.py", False, "aten.view", None),
])
def test_fallback_rule_keys_on_the_raising_module_and_the_op(where, cause, op, want):
    """``fallback_rule`` lets an op of FALLBACK_OPS through where the error
    (or the one DTensor re-raised it from) was raised in DTensor's sharding
    propagation, and raises it otherwise."""
    import torch

    exc = _raise_in(where, RuntimeError("refused"))
    if cause:  # DTensor's dispatch re-raises a propagation error from it
        outer = RuntimeError("Sharding propagation failed")
        outer.__cause__ = exc
        exc = _raise_in("torch/distributed/tensor/_dispatch.py", outer)
    func = getattr(torch.ops.aten, op.split(".")[1]).default
    if want is None:
        with pytest.raises(RuntimeError):
            D.fallback_rule(func, exc)
    else:
        assert D.fallback_rule(func, exc) == want


DATA_MESH_ARCHS = ["internlm2-1.8b", "qwen3-moe-30b-a3b", "zamba2-1.2b", "whisper-base",
                   "xlstm-125m"]

#: The MoE prefill's bytes above one rank's on the data-only mesh: its
#: dispatch is global by its semantics (a stable sort of all T K
#: assignments, a capacity of the global T), and DTensor runs it
#: replicated: at the peak the gathered token rows (``aten.index``), their
#: bf16 and f32 gate products (``aten._to_copy``, ``aten.mul``), each of
#: the global T K = 2,048 rows where one rank has 512.
MOE_PREFILL_GAP = 2_110_912


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", DATA_MESH_ARCHS)
def test_data_only_mesh_counts_what_one_rank_counts(runs, arch, kind):
    """On 4 data x 1 model fake ranks at global batch 8, every param
    replicated, one device's temp and output bytes of a prefill and a
    decode step equal one rank's at batch 2 with no DTensor (both under
    no_grad, the dry run's context), exactly: the caches, attention's
    carries and the recurrences' states are made as shards. The MoE
    prefill's one gap is its global dispatch, pinned by op."""
    rec = runs["data_mesh"][f"{arch}/{kind}"]
    (mesh_temp, mesh_out), (one_temp, one_out) = rec["mesh"], rec["one"]
    assert mesh_out == one_out > 0 and one_temp > 0
    if (arch, kind) != ("qwen3-moe-30b-a3b", "prefill"):
        assert mesh_temp == one_temp
        return
    assert mesh_temp - one_temp == MOE_PREFILL_GAP
    rows = {op: b for b, shape, dtype, op, line in rec["peak"]
            if line.startswith("models/moe.py") and shape[0] == 2 * 1024}
    assert rows == {"aten.mul.Tensor": 1_048_576, "aten.index.Tensor": 524_288,
                    "aten._to_copy.default": 524_288}
    assert rec["peak"][0][4].startswith("models/moe.py")  # the peak is the dispatch's


@pytest.mark.parametrize("arch", DATA_MESH_ARCHS)
def test_data_only_mesh_train_step_counts_one_rank_and_its_all_reduces(runs, arch):
    """A train step (one microbatch, remat "full", the AdamW update) on the
    data-only mesh counts at most one rank's temp bytes plus one device's
    all-reduce buffers (the gradients'), and the same output bytes."""
    rec = runs["data_mesh"][f"{arch}/train"]
    (mesh_temp, mesh_out), (one_temp, one_out) = rec["mesh"], rec["one"]
    assert mesh_out == one_out > 0
    assert one_temp <= mesh_temp <= one_temp + rec["all_reduce"]
    assert rec["all_reduce"] > 0


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "zamba2-1.2b", "whisper-base",
                                  "xlstm-125m"])
def test_cache_hint_on_a_mesh_makes_each_devices_shard_alone(runs, arch):
    """``init_cache`` under a (2 data, 2 model) mesh: every leaf is a
    DTensor of the plain cache's global shape and dtype laid out by
    ``cache_spec``, and the only storages made are the local shards: no
    storage of a global shape, nothing temporary."""
    rec = runs["data_mesh"][f"cache/{arch}"]
    assert rec["leaves"] and all(rec["leaves"])
    assert rec["output_size_in_bytes"] == rec["peak_bytes"] == rec["shard_bytes"]
    assert rec["temp_size_in_bytes"] == 0 and rec["largest"] <= rec["shard_bytes"]


def test_refused_head_view_keeps_its_data_shard(tmp_path):
    """A (4, S, 4, hd) tensor sharded (Shard(0), Shard(2)) on a (2 data, 4
    model) mesh of 8 gloo ranks, reshaped into (4, S, 2, 2, hd): DTensor
    refuses the view, and the fallback replicates the model dim alone (one
    all-gather), keeping the data shard: a local batch of 2 on every rank,
    ``fallback_replicated`` {"model": 1}, and the gathered result equal to
    the plain reshape bit for bit."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_view_rank, args=(r, str(tmp_path))) for r in range(8)]
    for proc in procs:
        proc.start()
    for proc in procs:
        proc.join(240)
    hung = [proc.pid for proc in procs if proc.is_alive()]
    for proc in procs:
        if proc.is_alive():
            proc.kill()
            proc.join(10)
    assert not hung and [proc.exitcode for proc in procs] == [0] * 8
    for r in range(8):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            out = pickle.load(f)
        assert out["local"] == (2, 6, 2, 2, 8)
        assert out["placements"] == ["Shard(dim=0)", "Replicate()"]
        assert out["fallbacks"] == {"aten.view": 1}
        assert out["replicated"] == {"aten.view": {"model": 1}}
        assert out["gathers"] == 1 and out["equal"]


def test_no_module_assigns_torch_inference_mode():
    """The models reach inference mode through ``_device.inference()``; the
    dry run swaps it with ``inference_as``, and nothing patches torch."""
    hits = []
    for path in (ROOT / "src" / "repro_torch").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target] if isinstance(node, (ast.AugAssign, ast.AnnAssign))
                       else [])
            for t in targets:
                if (isinstance(t, ast.Attribute) and t.attr == "inference_mode"
                        and isinstance(t.value, ast.Name) and t.value.id == "torch"):
                    hits.append(f"{path}:{node.lineno}")
            if isinstance(node, ast.With) and path.name != "_device.py":
                for item in node.items:  # every inference block goes through the helper
                    f = getattr(item.context_expr, "func", None)
                    if isinstance(f, ast.Attribute) and f.attr == "inference_mode":
                        hits.append(f"{path}:{node.lineno}")
    assert hits == []
