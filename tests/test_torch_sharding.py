"""The port's sharding rules (repro_torch.sharding) against the reference's
(repro.sharding.rules) on the CPU, with no devices: specs compared entry
for entry against the reference's PartitionSpecs on the two production
meshes' axis sizes.

The reference's trees come from ``jax.eval_shape`` of its init and decode
state; the port's from the meta device. A reference spec shorter than its
leaf's rank is padded with ``None`` (the port's spec has one entry a dim).
"""
import jax
import pytest
import torch
from jax.sharding import PartitionSpec

import repro.configs as rcfg
import repro.launch.specs as RS
import repro.sharding.rules as RR
from repro.models import build_model as ref_build

import repro_torch.configs as tcfg
import repro_torch.launch.specs as TS
import repro_torch.sharding.rules as TR
from repro_torch.models import build_model
from repro_torch.sharding import shard_hint, use_mesh
from repro_torch.sharding.hints import cache_hint


class _FakeMesh:
    """Axis names and sizes only, as the reference's own rules test uses."""

    def __init__(self, shape_map):
        self.shape = shape_map
        self.axis_names = tuple(shape_map)


MESHES = {
    "single": _FakeMesh({"data": 16, "model": 16}),
    "multi": _FakeMesh({"pod": 2, "data": 16, "model": 16}),
}
SPEC_ARCHS = ["nemotron-4-340b", "qwen3-moe-235b-a22b", "zamba2-1.2b", "whisper-base"]


def _ref_specs(tree, mesh, spec_fn):
    """{path: spec padded to the leaf's rank} of the reference's tree."""
    mapping = RR.mesh_mapping(mesh)
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        spec = tuple(spec_fn(path, leaf, mesh, mapping))
        out[tuple(RR._path_names(path))] = (spec + (None,) * (leaf.ndim - len(spec)), leaf.shape)
    return out


def _port_specs(tree, mesh, spec_fn):
    mapping = TR.mesh_mapping(mesh)
    return {path: (spec_fn(path, leaf, mesh, mapping), tuple(leaf.shape))
            for path, leaf in TR.tree_paths(tree) if isinstance(leaf, torch.Tensor)}


def _assert_same(got, want, skip=()):
    extra = {k for k in want if k not in got}
    assert extra <= set(skip), extra  # the reference's 0-d cache position
    assert set(got) == set(want) - extra
    for path, (spec, shape) in got.items():
        assert shape == tuple(want[path][1]), path
        assert spec == want[path][0], (path, spec, want[path][0])


@pytest.mark.parametrize("arch", tcfg.list_archs())
@pytest.mark.parametrize("mesh_name", ["single", "multi"])
def test_param_specs_equal_the_reference(arch, mesh_name):
    mesh = MESHES[mesh_name]
    want = _ref_specs(RS.params_specs(ref_build(rcfg.get_config(arch))), mesh, RR.param_spec)
    got = _port_specs(TS.params_specs(build_model(tcfg.get_config(arch))), mesh, TR.param_spec)
    _assert_same(got, want)
    assert any(any(e is not None for e in s) for s, _ in got.values())


@pytest.mark.parametrize("arch", SPEC_ARCHS)
def test_batch_and_cache_specs_equal_the_reference(arch):
    mesh = MESHES["single"]
    cfg_r, cfg_t = rcfg.get_config(arch), tcfg.get_config(arch)
    shape_r, shape_t = rcfg.SHAPES["train_4k"], tcfg.SHAPES["train_4k"]
    _assert_same(_port_specs(TS.train_batch_specs(cfg_t, shape_t), mesh, TR.batch_spec),
                 _ref_specs(RS.train_batch_specs(cfg_r, shape_r), mesh, RR.batch_spec))
    cache_r, tok_r = RS.decode_specs(ref_build(cfg_r), cfg_r, rcfg.SHAPES["decode_32k"])
    cache_t, tok_t = TS.decode_specs(build_model(cfg_t), cfg_t, tcfg.SHAPES["decode_32k"])
    for port_fn, ref_fn in ((TR.cache_spec, RR.cache_spec),
                            (TR.serve_cache_spec, RR.serve_cache_spec)):
        _assert_same(_port_specs(cache_t, mesh, port_fn), _ref_specs(cache_r, mesh, ref_fn),
                     skip={("pos",)})
    _assert_same(_port_specs({"t": tok_t}, mesh, TR.serve_batch_spec),
                 _ref_specs({"t": tok_r}, mesh, RR.serve_batch_spec))


@pytest.mark.parametrize("arch", ["nemotron-4-340b", "qwen3-moe-235b-a22b"])
def test_param_and_moment_bytes_per_device_equal_the_reference(arch):
    """One device's bf16 params and two moments (of the config's moment
    dtype) on the single-pod mesh: the port's rules count the reference's
    rules' bytes, and they fit one H100's 80 GB."""
    mesh = MESHES["single"]
    sizes = TR.mesh_axes(mesh)

    def per_device(specs, numel_of, moment_bytes):
        total = 0
        for spec, shape in specs.values():
            shard = 1
            for axes in spec:
                for a in ((axes,) if isinstance(axes, str) else (axes or ())):
                    shard *= sizes[a]
            total += numel_of(shape) // shard * (2 + 2 * moment_bytes)
        return total

    cfg_r, cfg_t = rcfg.get_config(arch), tcfg.get_config(arch)
    mb = 2 if cfg_t.moment_dtype == "bfloat16" else 4
    numel = lambda s: int(torch.Size(s).numel())
    want = per_device(_ref_specs(RS.params_specs(ref_build(cfg_r)), mesh, RR.param_spec), numel, mb)
    got = per_device(_port_specs(TS.params_specs(build_model(cfg_t)), mesh, TR.param_spec), numel, mb)
    assert got == want
    assert got < 80e9


def test_to_placements_nests_pod_and_data():
    from torch.distributed.tensor import Replicate, Shard

    multi = MESHES["multi"]
    assert TR.to_placements((("pod", "data"), "model", None), multi) == (Shard(0), Shard(0), Shard(1))
    assert TR.to_placements((None, None), multi) == (Replicate(),) * 3
    assert TR.to_placements(("model", ("data",)), MESHES["single"]) == (Shard(1), Shard(0))
    assert TR.local_shape((64, 48, 7), (("pod", "data"), "model", None), multi) == (2, 3, 7)


def test_hints_are_the_identity_without_a_mesh_or_a_dtensor():
    x = torch.randn(4, 6, 8)
    assert shard_hint(x, ("dp", None, "tp")) is x
    cache = {"k": torch.zeros(2, 3), "ssm": [torch.zeros(1)]}
    assert cache_hint(cache) is cache
    with use_mesh(MESHES["single"]):  # a plain tensor under a mesh: still itself
        assert shard_hint(x, ("dp", "tp", None)) is x


def test_reference_spec_form_is_a_partition_spec():
    """The comparison's premise: the reference's specs are PartitionSpecs
    whose entries are None, a name or a tuple of names."""
    spec = RR.param_spec(
        (jax.tree_util.DictKey("layers"), jax.tree_util.DictKey("w1")),
        jax.ShapeDtypeStruct((4, 1024, 4096), jax.numpy.bfloat16), MESHES["multi"])
    assert isinstance(spec, PartitionSpec) and tuple(spec) == (None, ("pod", "data"), "model")
