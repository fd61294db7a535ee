from .base import (
    ARCH_IDS,
    PORTED_ARCH_IDS,
    SHAPE_CELLS,
    ArchConfig,
    HybridConfig,
    ShapeCell,
    SSMConfig,
    get_config,
    reduced_config,
)

__all__ = [
    "ARCH_IDS",
    "PORTED_ARCH_IDS",
    "SHAPE_CELLS",
    "ArchConfig",
    "HybridConfig",
    "SSMConfig",
    "ShapeCell",
    "get_config",
    "reduced_config",
]
