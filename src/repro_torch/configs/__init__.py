from .base import (
    ARCH_IDS,
    PORTED_ARCH_IDS,
    ArchConfig,
    HybridConfig,
    SSMConfig,
    get_config,
    reduced_config,
)

__all__ = [
    "ARCH_IDS",
    "PORTED_ARCH_IDS",
    "ArchConfig",
    "HybridConfig",
    "SSMConfig",
    "get_config",
    "reduced_config",
]
