"""AdamW, learning-rate schedules and error-feedback gradient compression
of the port (``repro.optim``'s twin on trees of tensors)."""

from .adamw import (AdamWConfig, global_norm, init, state_specs, update,
                    update_)
from .schedules import constant, warmup_cosine

__all__ = [
    "AdamWConfig",
    "global_norm",
    "init",
    "state_specs",
    "update",
    "update_",
    "constant",
    "warmup_cosine",
]
