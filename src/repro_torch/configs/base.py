"""Architecture configs of the port (the dense and hybrid families so far).

A config is pure data: the models read it.  This is the port's own copy of
the fields of ``repro.configs.base.ArchConfig`` that the dense and hybrid
families read (with the Mamba-2 :class:`SSMConfig` and the Zamba
:class:`HybridConfig`), of the shape cells (:class:`ShapeCell`,
:data:`SHAPE_CELLS`), and of :func:`get_config` and
:func:`reduced_config`.  The MoE sub-config, the xLSTM fields of
``SSMConfig`` and the sharding policy are not ported yet;
:func:`get_config` raises for an architecture the port cannot run.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Literal, Optional

__all__ = [
    "SSMConfig",
    "HybridConfig",
    "ArchConfig",
    "ShapeCell",
    "SHAPE_CELLS",
    "ARCH_IDS",
    "PORTED_ARCH_IDS",
    "get_config",
    "reduced_config",
]


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 / SSD settings (zamba2)."""

    state_dim: int = 64  # N, per-head state
    head_dim: int = 64  # P
    expansion: int = 2
    conv_kernel: int = 4
    n_groups: int = 1  # B/C groups (like GQA for the SSM)
    chunk: int = 128  # chunk length of the plain chunked scan


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
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None

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


# every architecture of the reference, and the ones the port can build
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
PORTED_ARCH_IDS = ("qwen2-0.5b", "zamba2-7b")


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    if arch_id not in PORTED_ARCH_IDS:
        raise NotImplementedError(
            f"{arch_id} is not ported yet; the port has {PORTED_ARCH_IDS}")
    mod = importlib.import_module(
        f"{__package__}.{arch_id.replace('-', '_').replace('.', '_')}"
    )
    cfg: ArchConfig = mod.CONFIG
    cfg.validate()
    return cfg


def reduced_config(cfg: ArchConfig) -> ArchConfig:
    """Tiny same-family config for CPU smoke tests (shapes only, same code
    paths, GQA ratio kept, hybrid interleave kept): the dense and hybrid
    cases of the reference's rule."""
    kv = max(1, min(cfg.n_kv_heads, 2))
    heads = max(kv * max(1, cfg.n_heads // max(cfg.n_kv_heads, 1) // 4), kv)
    heads = max(heads - heads % kv, kv)
    d_model = 64 * heads if cfg.family != "ssm" else 128
    ssm = None
    if cfg.ssm is not None:
        ssm = dataclasses.replace(cfg.ssm, state_dim=16, head_dim=32, chunk=16)
    hybrid = cfg.hybrid
    if hybrid is not None:
        hybrid = dataclasses.replace(hybrid, attn_every=2)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-reduced",
        n_layers=4,
        d_model=d_model,
        n_heads=heads,
        n_kv_heads=kv,
        d_ff=0 if cfg.d_ff == 0 else 4 * d_model,
        vocab_size=512,
        ssm=ssm,
        hybrid=hybrid,
    )
