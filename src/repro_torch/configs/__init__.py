"""Architecture configs of the LLM zoo: the port's own copy of the
reference's ``configs/`` (the port imports nothing of ``repro``). Every full
and smoke config equals the reference's field for field."""
from .base import ArchConfig, MoECfg, SSMCfg, get_config, list_archs
from .shapes import SHAPES, SMOKE_SHAPES, ShapeSpec, applicable, cells

__all__ = [
    "ArchConfig", "MoECfg", "SSMCfg", "get_config", "list_archs",
    "SHAPES", "SMOKE_SHAPES", "ShapeSpec", "applicable", "cells",
]
