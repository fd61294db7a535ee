"""Architecture configs of the port: all ten of the reference's.

A config is pure data: the models read it.  This is the port's own copy of
``repro.configs.base.ArchConfig`` and its sub-configs (:class:`MoEConfig`,
the Mamba-2 / xLSTM :class:`SSMConfig`, the Zamba :class:`HybridConfig`),
of the shape cells (:class:`ShapeCell`, :data:`SHAPE_CELLS`), of the
sharding policy (:class:`ShardingPolicy`, which ``launch.policies``
derives per arch, cell and mesh shape, and the placement trees and
``launch.dryrun`` read), of :func:`cell_supported`, and of
:func:`get_config` and :func:`reduced_config`.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Literal, Optional

__all__ = [
    "MoEConfig",
    "SSMConfig",
    "HybridConfig",
    "ArchConfig",
    "ShapeCell",
    "SHAPE_CELLS",
    "ARCH_IDS",
    "ShardingPolicy",
    "cell_supported",
    "get_config",
    "reduced_config",
]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int  # routed experts
    top_k: int
    d_expert: int  # per-expert FFN hidden dim
    n_shared: int = 0  # always-on shared experts (DeepSeekMoE)
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    first_layer_dense: bool = False  # DeepSeekMoE: layer 0 stays dense


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 / SSD settings (zamba2) or xLSTM settings (xlstm-350m)."""

    state_dim: int = 64  # N (per-head state) for SSD; dk for mLSTM
    head_dim: int = 64  # P
    expansion: int = 2
    conv_kernel: int = 4
    n_groups: int = 1  # B/C groups (like GQA for the SSM)
    chunk: int = 128  # chunk length of the chunked scans
    # xLSTM only: which block indices are sLSTM (the rest mLSTM)
    slstm_layers: tuple[int, ...] = ()


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style hybrid: SSM backbone + one shared attention block."""

    attn_every: int = 6  # shared attn applied after every k-th ssm block


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Literal["dense", "moe", "ssm", "hybrid", "audio", "vlm"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    qkv_bias: bool = False
    mlp_bias: bool = False
    attn_out_bias: bool = False
    parallel_block: bool = False  # command-r style parallel attn+FFN
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    activation: Literal["swiglu", "gelu"] = "swiglu"
    rope_theta: float = 10_000.0
    use_rope: bool = True
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    # enc-dec (whisper): n_layers counts EACH stack (24 enc + 24 dec)
    enc_dec: bool = False
    # modality frontend stub: 'none' | 'patch' (vlm) | 'frames' (audio)
    frontend: Literal["none", "patch", "frames"] = "none"
    frontend_dim: int = 0  # dim of the precomputed stub embeddings
    n_patches: int = 0  # vlm: patches prepended per sample
    max_seq_len: int = 1_048_576
    # whether this arch supports O(seq) (sub-quadratic) decode at 500k
    subquadratic: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def validate(self) -> None:
        if self.n_heads % max(self.n_kv_heads, 1):
            raise ValueError(f"{self.name}: n_heads % n_kv_heads != 0")
        if self.d_model % self.n_heads:
            raise ValueError(f"{self.name}: d_model % n_heads != 0")


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPE_CELLS: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}


# every architecture of the reference; the port builds each of them
ARCH_IDS = (
    "internvl2-76b",
    "command-r-plus-104b",
    "qwen2-0.5b",
    "qwen2.5-14b",
    "granite-34b",
    "xlstm-350m",
    "olmoe-1b-7b",
    "deepseek-moe-16b",
    "zamba2-7b",
    "whisper-medium",
)


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    """How an arch maps onto a mesh of (data-parallel axes, model axis):
    the reference's fields and defaults (derived per arch x cell x mesh
    shape by ``launch.policies.auto_policy``)."""

    dp_axes: tuple[str, ...] = ("data",)  # data-parallel mesh axes
    model_axis: str = "model"
    fsdp: bool = False  # shard params over dp_axes too (ZeRO-3 style)
    seq_shard: bool = False  # Megatron-style sequence parallelism
    attn_mode: Literal["heads", "head_dim"] = "heads"
    # pad q-heads (zero weights) up to this count so the head dim divides
    # the model axis; 0 = no padding
    attn_pad_heads: int = 0
    # under sequence parallelism, pin full-seq placement around the weight
    # matmuls (inputs and cotangents) so weight gradients never all-reduce
    # over the model axis
    sp_weightgrad_fix: bool = False
    shard_kv_heads: bool = True  # false when kv_heads % model_size != 0
    shard_vocab: bool = True
    remat: bool = True
    num_microbatches: int = 1
    # decode: place the KV cache's sequence dim over the dp axes
    kv_seq_shard: bool = False


def cell_supported(cfg: ArchConfig, cell: ShapeCell) -> tuple[bool, str]:
    """Whether (arch x shape) is a runnable dry-run cell, and why not."""
    if cell.name == "long_500k" and not cfg.subquadratic:
        return False, "long_500k skipped: pure full-attention arch (DESIGN.md)"
    return True, ""


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(
        f"{__package__}.{arch_id.replace('-', '_').replace('.', '_')}"
    )
    cfg: ArchConfig = mod.CONFIG
    cfg.validate()
    return cfg


def reduced_config(cfg: ArchConfig) -> ArchConfig:
    """Tiny same-family config for CPU smoke tests (shapes only, same code
    paths: GQA ratios, MoE routing, hybrid interleave, enc-dec, frontends),
    by the reference's rule."""
    kv = max(1, min(cfg.n_kv_heads, 2))
    heads = max(kv * max(1, cfg.n_heads // max(cfg.n_kv_heads, 1) // 4), kv)
    heads = max(heads - heads % kv, kv)
    d_model = 64 * heads if cfg.family != "ssm" else 128
    moe = None
    if cfg.moe is not None:
        moe = dataclasses.replace(
            cfg.moe, n_experts=8, top_k=min(cfg.moe.top_k, 2), d_expert=64)
    ssm = None
    if cfg.ssm is not None:
        # keep one sLSTM segment end if the original had any (layout: 3m+1s)
        slstm = (3,) if cfg.ssm.slstm_layers else ()
        ssm = dataclasses.replace(cfg.ssm, state_dim=16, head_dim=32,
                                  chunk=16, slstm_layers=slstm)
    hybrid = cfg.hybrid
    if hybrid is not None:
        hybrid = dataclasses.replace(hybrid, attn_every=2)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-reduced",
        n_layers=4 if not cfg.enc_dec else 2,
        d_model=d_model,
        n_heads=heads,
        n_kv_heads=kv,
        d_ff=0 if cfg.d_ff == 0 else 4 * d_model,
        vocab_size=512,
        moe=moe,
        ssm=ssm,
        hybrid=hybrid,
        frontend_dim=32 if cfg.frontend != "none" else 0,
        n_patches=8 if cfg.frontend == "patch" else 0,
        max_seq_len=4096,
    )
