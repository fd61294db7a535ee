"""Dense decoder-only transformer block of the port (the qwen2 family).

Follows ``repro.models.transformer``: GQA attention with optional QKV
bias, an optional parallel attention + FFN block, RMSNorm or LayerNorm,
SwiGLU or GELU.  Where the reference calls its XLA attention
(``chunked_gqa_attend`` in prefill, ``decode_attend`` in decode), the port
calls the hand-written kernels: :func:`prefill_attend` (causal) and
:func:`full_attend` (bidirectional or cross, whisper) go through
``flash_attention`` and :func:`decode_attend` through
``decode_attention``.  All read the KV heads natively (no repeat).
With grad mode on and an input that requires grad (training),
:func:`prefill_attend` and :func:`full_attend` go through
``FlashAttentionFn``: the same kernel forward, and a backward kernel;
:func:`apply_block` without ``kv_sink`` is then the training block.
"""

from __future__ import annotations

import torch

from ..configs.base import ArchConfig, ShardingPolicy
from ..kernels.decode_attention.ops import decode_attention
from ..kernels.flash_attention.ops import FlashAttentionFn, flash_attention
from . import layers as L

__all__ = [
    "init_block",
    "block_specs",
    "apply_block",
    "apply_block_decode",
    "prefill_attend",
    "full_attend",
    "decode_attend",
]


def _no_softcap(logit_softcap: float) -> None:
    if logit_softcap > 0.0:
        raise NotImplementedError("the attention kernels have no logit softcap")


def _attend(q, k, v, causal: bool) -> torch.Tensor:
    """The flash kernel, through ``FlashAttentionFn`` when grad mode is on
    and an input requires grad."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, 0)
    return flash_attention(q, k, v, causal=causal)


def prefill_attend(q, k, v, logit_softcap: float = 0.0) -> torch.Tensor:
    """Causal attention over the prompt.  q: (b, s, H, hd); k, v:
    (b, s, KV, hd).  The twin of the reference's ``chunked_gqa_attend``;
    differentiable when grad mode is on and an input requires grad."""
    _no_softcap(logit_softcap)
    return _attend(q, k, v, True)


def full_attend(q, k, v) -> torch.Tensor:
    """Attention without a mask: every query sees every key.  q: (b, sq,
    H, hd); k, v: (b, skv, KV, hd), skv free (the whisper encoder's
    self-attention, and cross attention into its output).  The twin of
    the reference's ``chunked_gqa_attend(..., causal=False)``;
    differentiable as :func:`prefill_attend` is."""
    return _attend(q, k, v, False)


def decode_attend(q, k_cache, v_cache, cache_len: int,
                  logit_softcap: float = 0.0) -> torch.Tensor:
    """One-token attention against the cache.  q: (b, 1, H, hd); caches
    (b, S_max, KV, hd); ``cache_len`` valid positions (the new token's K/V
    already written at cache_len - 1).  Returns (b, 1, H, hd)."""
    _no_softcap(logit_softcap)
    out = decode_attention(q[:, 0].contiguous(), k_cache, v_cache, cache_len)
    return out[:, None]


def init_block(gen: torch.Generator, cfg: ArchConfig, device):
    p = {
        "ln1": L.init_norm(cfg, device),
        "attn": L.init_attention(gen, cfg, device),
        "mlp": L.init_mlp(gen, cfg, device),
    }
    if not cfg.parallel_block:
        p["ln2"] = L.init_norm(cfg, device)
    return p


def block_specs(cfg: ArchConfig, policy: ShardingPolicy):
    p = {
        "ln1": L.norm_specs(cfg),
        "attn": L.attention_specs(cfg, policy),
        "mlp": L.mlp_specs(cfg, policy),
    }
    if not cfg.parallel_block:
        p["ln2"] = L.norm_specs(cfg)
    return p


def _finish(cfg: ArchConfig, params, x, h1, attn_y):
    """Residual adds and the FFN after attention (shared by both blocks)."""
    if cfg.parallel_block:
        return x + attn_y + L.apply_mlp(cfg, params["mlp"], h1)
    x = x + attn_y
    h2 = L.apply_norm(cfg, params["ln2"], x)
    return x + L.apply_mlp(cfg, params["mlp"], h2)


def apply_block(cfg: ArchConfig, params, x, rope, kv_sink=None):
    """Prefill and training block.  x: (b, s, d); ``rope``:
    :func:`layers.rope_tables` of the positions.  When ``kv_sink`` =
    (k_cache, v_cache) is given, this layer's K/V are written into
    positions [0, s) of those caches in place."""
    h1 = L.apply_norm(cfg, params["ln1"], x)
    q, k, v = L.qkv_project(cfg, params["attn"], h1, rope)
    if kv_sink is not None:
        k_cache, v_cache = kv_sink
        k_cache[:, : k.shape[1]] = k
        v_cache[:, : v.shape[1]] = v
    ctx = prefill_attend(q, k, v, cfg.logit_softcap)
    return _finish(cfg, params, x, h1, L.attn_out(cfg, params["attn"], ctx))


def apply_block_decode(cfg: ArchConfig, params, x, k_cache, v_cache,
                       cache_len: int, rope):
    """Single-token decode block.  x: (b, 1, d).

    Writes the new K/V at index ``cache_len`` of the caches IN PLACE (the
    reference returns updated copies) and attends over ``cache_len + 1``
    items.  ``rope``: the rotary tables of position ``cache_len``.
    Returns (x_out, k_cache, v_cache).
    """
    h1 = L.apply_norm(cfg, params["ln1"], x)
    q, k, v = L.qkv_project(cfg, params["attn"], h1, rope)
    k_cache[:, cache_len] = k[:, 0]
    v_cache[:, cache_len] = v[:, 0]
    ctx = decode_attend(q, k_cache, v_cache, cache_len + 1, cfg.logit_softcap)
    attn_y = L.attn_out(cfg, params["attn"], ctx)
    return _finish(cfg, params, x, h1, attn_y), k_cache, v_cache
