"""Automatic sharding-policy selection per (arch x shape x mesh shape).

The reference's rules (``repro.launch.policies.auto_policy``), on a mesh
shape (an ordered ``{axis: size}`` mapping, ``launch.mesh``) in place of
a ``jax.sharding.Mesh``: its decisions read only the axis sizes, the
data-parallel axes and the parameter count.
"""

from __future__ import annotations

from ..configs.base import ArchConfig, ShapeCell, ShardingPolicy
from .mesh import dp_axes_of

__all__ = ["auto_policy", "FSDP_PARAM_THRESHOLD", "ACT_BUDGET"]

FSDP_PARAM_THRESHOLD = 2e9  # params above this shard over the dp axes too

# activation-memory budget per chip for choosing microbatching (bytes)
ACT_BUDGET = 2 << 30


def _param_count(cfg: ArchConfig) -> int:
    from ..models import count_params

    return count_params(cfg)


def auto_policy(cfg: ArchConfig, cell: ShapeCell, mesh_shape) -> ShardingPolicy:
    model_size = mesh_shape["model"]
    dp = dp_axes_of(mesh_shape)
    dp_total = 1
    for a in dp:
        dp_total *= mesh_shape[a]

    n_params = _param_count(cfg)
    fsdp = n_params > FSDP_PARAM_THRESHOLD

    # shard heads; pad them with zero weights when the count does not
    # divide the axis (head_dim sharding all-reduces the attention scores)
    if cfg.n_heads % model_size == 0:
        attn_mode, pad = "heads", 0
    else:
        padded = ((cfg.n_heads + model_size - 1) // model_size) * model_size
        if padded % max(cfg.n_kv_heads, 1) == 0:
            attn_mode, pad = "heads", padded
        elif cfg.head_dim % model_size == 0:
            attn_mode, pad = "head_dim", 0
        else:
            attn_mode, pad = "heads", 0  # replicated heads (small models)
    shard_kv = cfg.n_kv_heads % model_size == 0
    shard_vocab = cfg.vocab_size % model_size == 0

    seq_shard = (
        cfg.family in ("dense", "vlm")
        and cell.kind in ("train", "prefill")
        and cfg.d_model >= 4096
        and cell.seq_len % model_size == 0
    )

    # decode: if the batch cannot cover the dp extent (long context) or the
    # KV heads cannot shard, place the cache's seq dim instead
    kv_seq_shard = cell.kind == "decode" and (
        cell.global_batch < dp_total or not shard_kv
    )

    num_microbatches = 1
    if cell.kind == "train":
        per_shard_batch = max(cell.global_batch // dp_total, 1)
        layer_bytes = per_shard_batch * cell.seq_len * cfg.d_model * 2
        if cfg.family == "audio":
            layer_bytes = layer_bytes + layer_bytes // 8  # enc + dec stacks
        if seq_shard:
            layer_bytes //= model_size
        depth = cfg.n_layers * (2 if cfg.enc_dec else 1)
        total = layer_bytes * depth
        while num_microbatches < per_shard_batch and total > ACT_BUDGET:
            num_microbatches *= 2
            total //= 2

    # pin full-seq activations (and cotangents) around the weight matmuls
    # iff a layer's weight-gradient all-reduce bytes would exceed the extra
    # activation reshard bytes
    sp_fix = False
    if seq_shard and cell.kind == "train":
        layer_params = n_params / max(cfg.n_layers, 1)
        b_micro = max(cell.global_batch // dp_total // num_microbatches, 1)
        act_bytes = 2 * b_micro * cell.seq_len * cfg.d_model
        sp_fix = layer_params > act_bytes

    return ShardingPolicy(
        dp_axes=dp,
        model_axis="model",
        fsdp=fsdp,
        seq_shard=seq_shard,
        attn_mode=attn_mode,
        attn_pad_heads=pad,
        sp_weightgrad_fix=sp_fix,
        shard_kv_heads=shard_kv,
        shard_vocab=shard_vocab,
        remat=True,
        num_microbatches=num_microbatches,
        kv_seq_shard=kv_seq_shard,
    )
