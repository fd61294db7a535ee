"""Models of the port: the dense LM family on the attention kernels, and
the hybrid family (zamba2) on them and the SSD scan."""

from .lm import (
    count_params,
    decode_step,
    init_decode_state,
    init_params,
    params_to,
    prefill,
    train_loss,
)

__all__ = [
    "count_params",
    "decode_step",
    "init_decode_state",
    "init_params",
    "params_to",
    "prefill",
    "train_loss",
]
