"""Sharding of the LLM zoo on a ``DeviceMesh``: the reference's rules as
specs and DTensor placements, and the model code's hints."""
from .hints import shard_hint, use_mesh
from .rules import (
    batch_spec,
    cache_spec,
    mesh_mapping,
    param_spec,
    params_shardings,
    to_placements,
    tree_shardings,
)

__all__ = [
    "batch_spec", "cache_spec", "mesh_mapping", "param_spec",
    "params_shardings", "tree_shardings", "shard_hint", "use_mesh", "to_placements",
]
