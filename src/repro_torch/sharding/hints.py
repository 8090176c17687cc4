"""Mesh-aware sharding hints usable from model code.

The port of the reference's ``sharding/hints.py``. ``shard_hint(x, dims)``
redistributes ``x`` to the placements its logical dims give when an
ambient ``DeviceMesh`` with ``data`` and ``model`` dims is set (``with
use_mesh(mesh):``) and ``x`` is a DTensor; otherwise it returns ``x``
itself, so a run without a mesh (every single-card path) is unchanged.
``cache_hint`` does the same for a new decode cache.
Logical dims:

  "dp"  -> the data-parallel mesh dims ("pod", "data") or ("data",)
  "tp"  -> the tensor-parallel mesh dim ("model",)
  None  -> unsharded

Divisibility-guarded as ``rules.py``: a dim that does not divide is left
unsharded rather than failing.
"""
from __future__ import annotations

import contextlib
import contextvars

from .rules import cache_spec, map_with_path, mesh_axes, mesh_mapping, to_placements

_AMBIENT = contextvars.ContextVar("repro_torch_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the ambient mesh of ``shard_hint`` inside the block."""
    token = _AMBIENT.set(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.reset(token)


def shard_hint(x, dims):
    """dims: a tuple of "dp" | "tp" | None, one per tensor dim."""
    mesh = _AMBIENT.get()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    sizes = mesh_axes(mesh)
    if "model" not in sizes or "data" not in sizes:
        return x
    dp = tuple(a for a in ("pod", "data") if a in sizes)
    n_dp = 1
    for a in dp:
        n_dp *= sizes[a]

    spec = []
    for tag, dim in zip(dims, x.shape):
        size = sizes["model"] if tag == "tp" else n_dp
        if tag is None or dim % size:
            spec.append(None)
        elif tag == "tp":
            spec.append("model")
        else:
            spec.append(dp if len(dp) > 1 else dp[0])
    spec += [None] * (x.ndim - len(spec))
    return x.redistribute(mesh, to_placements(tuple(spec), mesh))


def cache_hint(cache):
    """A new cache's tensors laid out by ``rules.cache_spec`` on the ambient
    mesh (as the reference's prefill gives its cache out-shardings); the
    cache itself without one."""
    mesh = _AMBIENT.get()
    if mesh is None:
        return cache
    from torch.distributed.tensor import distribute_tensor

    mapping = mesh_mapping(mesh)

    def one(path, x):
        return distribute_tensor(x, mesh, to_placements(cache_spec(path, x, mesh, mapping), mesh))

    return map_with_path(one, cache)
