from .base import (
    ARCH_IDS,
    SHAPE_CELLS,
    ArchConfig,
    HybridConfig,
    MoEConfig,
    ShapeCell,
    SSMConfig,
    get_config,
    reduced_config,
)

__all__ = [
    "ARCH_IDS",
    "SHAPE_CELLS",
    "ArchConfig",
    "HybridConfig",
    "MoEConfig",
    "SSMConfig",
    "ShapeCell",
    "get_config",
    "reduced_config",
]
