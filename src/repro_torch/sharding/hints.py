"""Mesh-aware sharding hints usable from model code.

The port of the reference's ``sharding/hints.py``. ``shard_hint(x, dims)``
redistributes ``x`` to the placements its logical dims give when an
ambient ``DeviceMesh`` with ``data`` and ``model`` dims is set (``with
use_mesh(mesh):``) and ``x`` is a DTensor; otherwise it returns ``x``
itself, so a run without a mesh (every single-card path) is unchanged.
``cache_hint`` makes a new decode cache from its leaves' shapes, dtypes and
fill values (``Blank``): plain tensors without a mesh; on one, each device's
shard alone, wrapped as a DTensor laid out by ``rules.cache_spec`` (as
``jnp.zeros`` under ``jit`` with out-shardings allocates only the local
shard), so no device holds a buffer of the global batch.
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

import torch

from .rules import (cache_spec, local_shape, map_with_path, mesh_axes, mesh_mapping,
                    to_placements)

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


class Blank:
    """A cache leaf to make: its global ``shape``, ``dtype`` and ``fill``."""

    __slots__ = ("shape", "dtype", "fill")

    def __init__(self, shape, dtype, fill: float = 0.0):
        self.shape, self.dtype, self.fill = torch.Size(shape), dtype, fill


def cache_hint(blanks, device):
    """The tensors of a tree of ``Blank`` leaves on ``device``: without an
    ambient mesh, the plain tensors; on one, each made at its local shape
    under ``rules.cache_spec`` (the reference's prefill gives its cache
    out-shardings) and wrapped as a DTensor of the global shape."""

    def filled(shape, b):
        return torch.full(shape, b.fill, dtype=b.dtype, device=device)

    mesh = _AMBIENT.get()
    if mesh is None:
        return map_with_path(lambda path, b: filled(b.shape, b), blanks)
    from torch.distributed.tensor import DTensor

    mapping = mesh_mapping(mesh)

    def one(path, b):
        spec = cache_spec(path, b, mesh, mapping)
        local = filled(local_shape(b.shape, spec, mesh), b)
        return DTensor.from_local(local, mesh, to_placements(spec, mesh), run_check=False,
                                  shape=b.shape, stride=_strides(b.shape))

    return map_with_path(one, blanks)


def batch_full(like, shape, fill: float, dtype):
    """A new ``shape`` tensor of ``fill`` whose dim 0 is ``like``'s (the
    batch): a plain tensor on ``like``'s device; for a DTensor ``like``,
    each device's shard alone, dim 0 laid out as ``like``'s and every other
    dim replicated (a plain tensor of the global shape would be replicated
    whole on every device)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(like, DTensor):
        return torch.full(shape, fill, dtype=dtype, device=like.device)
    placements = [p if p == Shard(0) else Replicate() for p in like.placements]
    local = torch.full((like._local_tensor.shape[0], *shape[1:]), fill, dtype=dtype,
                       device=like.device)
    return DTensor.from_local(local, like.device_mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=_strides(shape))


def _strides(shape):
    """A contiguous tensor's strides."""
    out, n = [], 1
    for d in reversed(shape):
        out.append(n)
        n *= d
    return tuple(reversed(out))
