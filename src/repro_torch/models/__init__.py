"""Models of the port, all ten architectures: the dense, vlm and moe
families on the attention kernels, the hybrid family (zamba2) on them and
the SSD scan, whisper on them, and xLSTM on tensor ops; the placement
trees of their parameters and decode states, and ``Shard``'s hooks, on a
production mesh shape."""

from .lm import (
    active_params,
    count_params,
    decode_state_shapes,
    decode_state_specs,
    decode_step,
    init_decode_state,
    init_params,
    param_specs,
    params_to,
    prefill,
    train_loss,
)
from .sharding import Shard

__all__ = [
    "Shard",
    "active_params",
    "count_params",
    "decode_state_shapes",
    "decode_state_specs",
    "decode_step",
    "init_decode_state",
    "init_params",
    "param_specs",
    "params_to",
    "prefill",
    "train_loss",
]
