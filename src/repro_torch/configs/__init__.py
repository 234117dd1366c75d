"""Architecture configs of the LM scaffolding: a copy of ``repro.configs``.

Pure data (dataclasses and the published values), kept apart so the port
imports nothing of the JAX package. Every config trains and serves in the
port (ROADMAP A15).
"""
from .common import ArchConfig, ShapeSpec, SHAPES, applicable, skip_reason
from .registry import ARCHS, get_config, smoke_config, smoke_shape

__all__ = [
    "ArchConfig", "ShapeSpec", "SHAPES", "applicable", "skip_reason",
    "ARCHS", "get_config", "smoke_config", "smoke_shape",
]
