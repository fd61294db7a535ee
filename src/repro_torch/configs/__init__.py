from .base import (
    ARCH_IDS,
    SHAPE_CELLS,
    ArchConfig,
    HybridConfig,
    MoEConfig,
    ShapeCell,
    ShardingPolicy,
    SSMConfig,
    cell_supported,
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
    "ShardingPolicy",
    "cell_supported",
    "get_config",
    "reduced_config",
]
