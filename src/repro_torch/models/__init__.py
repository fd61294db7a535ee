"""Models of the port, all ten architectures: the dense, vlm and moe
families on the attention kernels, the hybrid family (zamba2) on them and
the SSD scan, whisper on them, and xLSTM on tensor ops."""

from .lm import (
    active_params,
    count_params,
    decode_step,
    init_decode_state,
    init_params,
    params_to,
    prefill,
    train_loss,
)

__all__ = [
    "active_params",
    "count_params",
    "decode_step",
    "init_decode_state",
    "init_params",
    "params_to",
    "prefill",
    "train_loss",
]
