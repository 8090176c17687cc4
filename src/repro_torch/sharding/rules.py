"""Logical-axis sharding rules: param / batch / cache trees -> specs.

The port of the reference's ``sharding/rules.py``. Leaf paths map to tuples
of *logical* axes by name-based rules; a mesh mapping resolves logical axes
to mesh dims. Default mapping:

  tensor-parallel axes (heads / ff / experts / vocab / d_inner) -> "model"
  fully-sharded-data-parallel axis (the remaining large dim)     -> dp dims
                                       ("pod","data") or ("data",)
  batch dims of activations / caches                             -> dp dims
  KV-cache sequence dim                                          -> "model"

Any axis whose size does not divide the mesh dims' product is replicated.

A spec is the reference's ``PartitionSpec`` as a tuple with one entry per
tensor dim: ``None``, a mesh-dim name, or a tuple of names (a one-name
tuple is the name, as ``PartitionSpec`` keeps it).
``to_placements`` turns it into DTensor placements. Paths come from the
port's own tree walk (``tree_paths``): dict keys and list / tuple indices,
as the reference's ``_path_names`` reads ``DictKey`` and ``SequenceKey``
(a NamedTuple's field, a ``GetAttrKey`` there, adds nothing). A mesh is a
``DeviceMesh`` with named dims, or anything with ``axis_names`` and a
``shape`` mapping names to sizes.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

# leaf-name -> logical axes (without the optional leading layer-stack dim)
PARAM_RULES: Dict[str, Tuple] = {
    # embed: vocab unsharded so the token gather stays local; d_model -> tp.
    "embed": (None, "tp"),
    "unembed": ("fsdp", "vocab"),
    "wq": ("fsdp", "tp", None),
    "wk": ("fsdp", "tp", None),
    "wv": ("fsdp", "tp", None),
    "wo": ("tp", None, "fsdp"),
    "w1": ("fsdp", "tp"),
    "w3": ("fsdp", "tp"),
    "w2": ("tp", "fsdp"),
    "router": ("fsdp", None),
    # moe expert weights carry a leading experts dim (MOE_RULES)
    "in_proj": ("fsdp", "tp"),
    "out_proj": ("tp", "fsdp"),
    "conv_w": (None, "tp"),
    "conv_b": ("tp",),
    "w_up": ("fsdp", "tp"),
    "w_down": ("tp", "fsdp"),
    "w_out": ("tp", "fsdp"),
    "W": ("fsdp", "tp"),
    "R": (None, None, None),
    "w_if": ("fsdp", None),
}

MOE_RULES: Dict[str, Tuple] = {
    "w1": ("expert", "fsdp", None),
    "w3": ("expert", "fsdp", None),
    "w2": ("expert", None, "fsdp"),
}

DEFAULT_MAPPING: Dict[str, Any] = {
    "vocab": "model",
    "tp": "model",
    "expert": "model",
    "fsdp": ("data",),  # extended with "pod" on multi-pod meshes
    "dp": ("data",),
    "kvseq": "model",
}


def mesh_axes(mesh) -> Dict[str, int]:
    """{mesh-dim name: size}."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:  # a DeviceMesh
        return dict(zip(names, mesh.shape))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def mesh_mapping(mesh) -> Dict[str, Any]:
    m = dict(DEFAULT_MAPPING)
    if "pod" in mesh_axes(mesh):
        m["fsdp"] = ("pod", "data")
        m["dp"] = ("pod", "data")
    return m


def _axis_size(mesh, axes) -> int:
    sizes = mesh_axes(mesh)
    if axes is None:
        return 1
    if isinstance(axes, str):
        return sizes[axes]
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def _entry(axes):
    """A spec entry as ``PartitionSpec`` keeps it: a one-name tuple is the name."""
    return axes[0] if isinstance(axes, tuple) and len(axes) == 1 else axes


def _resolve(logical: Tuple, shape, mesh, mapping) -> Tuple:
    spec = []
    for ax_name, dim in zip(logical, shape):
        axes = mapping.get(ax_name) if ax_name else None
        if axes is not None and dim % _axis_size(mesh, axes) == 0:
            spec.append(_entry(axes))
        else:
            spec.append(None)
    return tuple(spec)


def _replicated(shape) -> Tuple:
    return (None,) * len(shape)


def _pad(spec, shape) -> Tuple:
    return tuple(_entry(a) for a in spec) + (None,) * (len(shape) - len(spec))


def tree_paths(tree, path=()):
    """(path, leaf) pairs of a nested dict / list / tuple tree, in the
    reference's flatten order (dicts by sorted key)."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in tree_paths(tree[k], path + (str(k),))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [pl for v in tree for pl in tree_paths(v, path)]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree) for pl in tree_paths(v, path + (i,))]
    return [(path, tree)]


def map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over ``tree``; the result has ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_with_path(fn, v, path) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def param_spec(path, leaf, mesh, mapping=None) -> Tuple:
    mapping = mapping or mesh_mapping(mesh)
    names = list(path)
    key = next((n for n in reversed(names) if isinstance(n, str)), "")
    in_moe = "moe" in names
    rules = MOE_RULES if (in_moe and key in MOE_RULES) else PARAM_RULES
    rule = rules.get(key)
    shape = tuple(leaf.shape)
    if rule is None:
        return _replicated(shape)  # norms, biases, scalars
    if len(shape) == len(rule) + 1:  # stacked layer dim
        rule = (None,) + rule
    if len(shape) != len(rule):
        return _replicated(shape)
    return _resolve(rule, shape, mesh, mapping)


def params_shardings(params, mesh):
    """The params' DTensor placements, leaf for leaf."""
    return tree_shardings(params, mesh, param_spec)


# ---------------------------------------------------------------------------
# batch / cache / state specs
# ---------------------------------------------------------------------------


def batch_spec(path, leaf, mesh, mapping=None) -> Tuple:
    """Input batches: shard dim 0 (the global batch) over the dp dims."""
    mapping = mapping or mesh_mapping(mesh)
    dp = mapping["dp"]
    shape = tuple(leaf.shape)
    if shape and shape[0] % _axis_size(mesh, dp) == 0:
        return _pad((dp,), shape)
    return _replicated(shape)


def cache_spec(path, leaf, mesh, mapping=None) -> Tuple:
    """KV caches and recurrent states.

    5-D (L, B, S, KV, hd): batch -> dp, seq -> model (flash-decoding layout).
    4-D (B, S, KV, hd) or (B, H, p, n) ssm state: batch -> dp, dim 1 (seq
    or heads) -> model when divisible. Other ranks: batch -> dp only.
    """
    mapping = mapping or mesh_mapping(mesh)
    dp, tp = mapping["dp"], mapping["tp"]
    names = list(path)
    shape = tuple(leaf.shape)
    dp_ok = lambda d: d % _axis_size(mesh, dp) == 0
    tp_ok = lambda d: d % _axis_size(mesh, tp) == 0

    if len(shape) == 5 and ("k" in names or "v" in names):
        return _pad((None, dp if dp_ok(shape[1]) else None, tp if tp_ok(shape[2]) else None),
                    shape)
    if len(shape) == 4:
        return _pad((dp if dp_ok(shape[0]) else None, tp if tp_ok(shape[1]) else None), shape)
    if shape and dp_ok(shape[0]):
        return _pad((dp,), shape)
    return _replicated(shape)


# serve-v2: the weight-stationary decode layout. Weights keep their 2-D
# sharding; the batch goes to the model dim and the KV cache's sequence to
# the data dims, so weights never move during decode.


def serve_batch_spec(path, leaf, mesh, mapping=None) -> Tuple:
    mapping = mapping or mesh_mapping(mesh)
    tp = mapping["tp"]
    shape = tuple(leaf.shape)
    if shape and shape[0] % _axis_size(mesh, tp) == 0:
        return _pad((tp,), shape)
    return _replicated(shape)


def serve_cache_spec(path, leaf, mesh, mapping=None) -> Tuple:
    mapping = mapping or mesh_mapping(mesh)
    dp, tp = mapping["dp"], mapping["tp"]
    names = list(path)
    shape = tuple(leaf.shape)
    tp_ok = lambda d: d % _axis_size(mesh, tp) == 0
    dp_ok = lambda d: d % _axis_size(mesh, dp) == 0
    if len(shape) == 5 and ("k" in names or "v" in names):
        return _pad((None, tp if tp_ok(shape[1]) else None,  # batch -> model
                     dp if dp_ok(shape[2]) else None), shape)  # seq -> data
    if len(shape) == 4:  # recurrent states: batch -> model
        return _pad((tp if tp_ok(shape[0]) else None,), shape)
    if shape and tp_ok(shape[0]):
        return _pad((tp,), shape)
    return _replicated(shape)


def to_placements(spec, mesh):
    """DTensor placements, one per mesh dim, of a spec: ``Shard(d)`` on each
    mesh dim that shards tensor dim ``d`` (both ``pod`` and ``data`` where a
    tuple names them, in mesh order, which nests them as the reference's
    major-to-minor tuple), ``Replicate()`` on the rest."""
    from torch.distributed.tensor import Replicate, Shard

    owner = {}
    for d, axes in enumerate(spec):
        for a in ((axes,) if isinstance(axes, str) else (axes or ())):
            owner[a] = d
    return tuple(Shard(owner[a]) if a in owner else Replicate() for a in mesh_axes(mesh))


def tree_shardings(tree, mesh, spec_fn):
    """DTensor placements for every leaf of ``tree`` by ``spec_fn``."""
    mapping = mesh_mapping(mesh)
    return map_with_path(lambda p, x: to_placements(spec_fn(p, x, mesh, mapping), mesh), tree)


def local_shape(shape, spec, mesh) -> Tuple:
    """One device's shard of a tensor of ``shape`` laid out by ``spec``
    (every sharded dim divides, as the rules guarantee)."""
    return tuple(d // _axis_size(mesh, axes) for d, axes in zip(shape, _pad(spec, shape)))
