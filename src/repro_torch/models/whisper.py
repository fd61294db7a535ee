"""Whisper-medium encoder-decoder of the port (the audio family).

Follows ``repro.models.whisper``.  The conv / mel frontend is a stub:
precomputed frame embeddings (B, T, frontend_dim) go through one learned
linear map to d_model, and sinusoidal positions are added.  Encoder blocks
are bidirectional; decoder blocks are causal self-attention, then cross
attention into the encoder output, then the MLP.  LayerNorm, GELU (tanh)
and biases on q / k / v / out and on the MLP, as the config says; the
decoder's input and output embeddings are tied.

Where the reference calls its XLA attention, the port calls the
hand-written kernels: the encoder's self-attention and the decoder's
cross attention go through ``flash_attention(causal=False)``
(``transformer.full_attend``), the decoder's causal self-attention in
:func:`decode_train` through ``transformer.prefill_attend``, and both
attentions of :func:`decode_step` through ``decode_attention``
(``transformer.decode_attend``).  :func:`encode` and :func:`decode_train`
are also the audio family's training forward: with grad mode on, their
attention goes through ``FlashAttentionFn`` (the same kernel forward,
and a backward kernel), so ``lm.train_loss`` differentiates both stacks.

``params``: {"frontend" (frontend_dim, d), "embed", "enc_blocks": [block,
...], "enc_norm", "dec_blocks": [block with "ln_cross" and "cross", ...],
"dec_norm"}.  The decode cache (:func:`whisper_cache_shape`): self and
cross K / V, each (L, b, max_len, KV, hd) in bfloat16; the cross cache
holds the encoder's K / V at [0, cross_len).  :func:`decode_step` writes
the self cache IN PLACE (the reference returns a new one).
"""

from __future__ import annotations

import math

import torch

from ..configs.base import ArchConfig, ShardingPolicy
from . import layers as L
from . import transformer as T

__all__ = [
    "init_whisper",
    "whisper_specs",
    "encode",
    "decode_train",
    "whisper_cache_shape",
    "decode_step",
]


def _sinusoid(positions: torch.Tensor, d: int) -> torch.Tensor:
    """(len(positions), d) float32: sin then cos of position x
    10000^(-i / (d/2 - 1))."""
    half = d // 2
    freqs = torch.exp(-math.log(10_000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=positions.device)
                      / max(half - 1, 1))
    ang = positions[:, None].float() * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def init_dec_block(gen: torch.Generator, cfg: ArchConfig, device):
    p = T.init_block(gen, cfg, device)
    p["ln_cross"] = L.init_norm(cfg, device)
    p["cross"] = L.init_attention(gen, cfg, device)
    return p


def init_whisper(gen: torch.Generator, cfg: ArchConfig, device):
    """The reference's shapes and scales, drawn from ``gen`` in the order
    frontend, embedding, encoder blocks, decoder blocks."""
    return {
        "frontend": L._normal(gen, (cfg.frontend_dim, cfg.d_model),
                              cfg.frontend_dim ** -0.5, device),
        "embed": L.init_embedding(gen, cfg, device),
        "enc_blocks": [T.init_block(gen, cfg, device)
                       for _ in range(cfg.n_layers)],
        "enc_norm": L.init_norm(cfg, device),
        "dec_blocks": [init_dec_block(gen, cfg, device)
                       for _ in range(cfg.n_layers)],
        "dec_norm": L.init_norm(cfg, device),
    }


def dec_block_specs(cfg: ArchConfig, policy: ShardingPolicy):
    p = T.block_specs(cfg, policy)
    p["ln_cross"] = L.norm_specs(cfg)
    p["cross"] = L.attention_specs(cfg, policy)
    return p


def whisper_specs(cfg: ArchConfig, policy: ShardingPolicy):
    """The placement tree of :func:`init_whisper`'s layout (the reference
    stacks each stack's blocks on one unplaced leading dim)."""
    enc, dec = T.block_specs(cfg, policy), dec_block_specs(cfg, policy)
    return {
        "frontend": (None, L._dp(policy)),
        "embed": L.embedding_specs(cfg, policy),
        "enc_blocks": [enc] * cfg.n_layers,
        "enc_norm": L.norm_specs(cfg),
        "dec_blocks": [dec] * cfg.n_layers,
        "dec_norm": L.norm_specs(cfg),
    }


def _cross_q(cfg: ArchConfig, lp, x):
    """The cross attention's queries from the decoder stream (after
    ``ln_cross``)."""
    h = L.apply_norm(cfg, lp["ln_cross"], x)
    q = L._project(h, lp["cross"]["wq"])
    if cfg.qkv_bias:
        q = q + lp["cross"]["bq"]
    return q


def _cross_attend(cfg: ArchConfig, lp, x, enc_k, enc_v):
    """Cross attention: queries from decoder x, the encoder's K / V."""
    ctx = T.full_attend(_cross_q(cfg, lp, x), enc_k, enc_v)
    return x + L.attn_out(cfg, lp["cross"], ctx)


def _cross_kv(cfg: ArchConfig, lp, enc_out):
    """A decoder layer's cross K and V, (b, t, KV, hd) each, from the
    encoder output (b, t, d)."""
    k = L._project(enc_out, lp["cross"]["wk"])
    v = L._project(enc_out, lp["cross"]["wv"])
    if cfg.qkv_bias:
        k = k + lp["cross"]["bk"]
        v = v + lp["cross"]["bv"]
    return k, v


def _add_positions(cfg: ArchConfig, x, positions):
    return x + _sinusoid(positions, cfg.d_model).to(x.dtype)[None]


def encode(cfg: ArchConfig, params, frames):
    """frames: (b, t, frontend_dim) -> (b, t, d)."""
    w = params["frontend"]
    dev = w.device
    # the reference rounds the frames to bfloat16 whatever its weights' dtype
    x = torch.as_tensor(frames, device=dev).to(L.DTYPE).to(w.dtype) @ w
    x = _add_positions(cfg, x, torch.arange(x.shape[1], device=dev))
    for lp in params["enc_blocks"]:
        h1 = L.apply_norm(cfg, lp["ln1"], x)
        q, k, v = L.qkv_project(cfg, lp["attn"], h1)
        x = x + L.attn_out(cfg, lp["attn"], T.full_attend(q, k, v))
        h2 = L.apply_norm(cfg, lp["ln2"], x)
        x = x + L.apply_mlp(cfg, lp["mlp"], h2)
    return L.apply_norm(cfg, params["enc_norm"], x)


def decode_train(cfg: ArchConfig, params, tokens, enc_out):
    """Teacher-forced decoder pass.  tokens: (b, sd) -> logits (b, sd, V)."""
    dev = params["frontend"].device
    tokens = torch.as_tensor(tokens, device=dev).long()
    x = L.embed_tokens(params["embed"], tokens)
    x = _add_positions(cfg, x, torch.arange(x.shape[1], device=dev))
    for lp in params["dec_blocks"]:
        h1 = L.apply_norm(cfg, lp["ln1"], x)
        q, k, v = L.qkv_project(cfg, lp["attn"], h1)
        x = x + L.attn_out(cfg, lp["attn"], T.prefill_attend(q, k, v))
        ek, ev = _cross_kv(cfg, lp, enc_out)
        x = _cross_attend(cfg, lp, x, ek, ev)
        h2 = L.apply_norm(cfg, lp["ln2"], x)
        x = x + L.apply_mlp(cfg, lp["mlp"], h2)
    x = L.apply_norm(cfg, params["dec_norm"], x)
    return L.unembed(cfg, params["embed"], x)


def whisper_cache_shape(cfg: ArchConfig, batch: int, max_len: int):
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {name: shape for name in ("self_k", "self_v", "cross_k",
                                     "cross_v")}


def decode_step(cfg: ArchConfig, params, cache, token, cache_len: int,
                cross_len: int):
    """One decoder token against the cached self K / V (``cache_len``
    positions before it) and the cached cross K / V (``cross_len`` valid
    positions).  token: (b, 1) integers.  Writes the token's self K / V at
    ``cache_len`` IN PLACE.  Returns (logits (b, 1, V), cache)."""
    dev = params["frontend"].device
    cache_len = int(cache_len)
    x = L.embed_tokens(params["embed"], torch.as_tensor(token,
                                                        device=dev).long())
    x = _add_positions(cfg, x, torch.full((1,), cache_len, device=dev))
    for i, lp in enumerate(params["dec_blocks"]):
        sk, sv = cache["self_k"][i], cache["self_v"][i]
        h1 = L.apply_norm(cfg, lp["ln1"], x)
        q, k, v = L.qkv_project(cfg, lp["attn"], h1)
        sk[:, cache_len] = k[:, 0]
        sv[:, cache_len] = v[:, 0]
        ctx = T.decode_attend(q, sk, sv, cache_len + 1)
        x = x + L.attn_out(cfg, lp["attn"], ctx)
        cctx = T.decode_attend(_cross_q(cfg, lp, x), cache["cross_k"][i],
                               cache["cross_v"][i], cross_len)
        x = x + L.attn_out(cfg, lp["cross"], cctx)
        h2 = L.apply_norm(cfg, lp["ln2"], x)
        x = x + L.apply_mlp(cfg, lp["mlp"], h2)
    x = L.apply_norm(cfg, params["dec_norm"], x)
    return L.unembed(cfg, params["embed"], x), cache
