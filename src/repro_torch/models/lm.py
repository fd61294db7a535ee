"""Model API of the port (the dense and hybrid families).

    params          = init_params(generator, cfg, device)
    loss, metrics   = train_loss(cfg, params, batch)
    logits, state   = prefill(cfg, params, batch, max_len)
    logits, state   = decode_step(cfg, params, state, token, cache_len)

As ``repro.models.lm`` without the ``Shard`` argument (the port runs on
one device until the distributed slice).  ``params`` is a dict.  Dense:
``{"embed", "blocks": [per-layer dict, ...], "final_norm"}``; the
reference's blocks, stacked on a leading layer axis by ``vmap``, are a
list here, one dict per layer.  Hybrid (zamba2): ``{"embed",
"mamba_segments": [[block, ...] per segment], "shared_attn",
"mamba_trailing": [block, ...], "final_norm"}`` (``models.zamba``).

The decode state keeps the reference's layout: dense ``{"k", "v"}`` of
shape (L, b, max_len, KV, hd) in bfloat16; hybrid ``seg_ssm`` (n_seg, seg,
b, H, N, P) float32, ``seg_conv`` (n_seg, seg, b, K-1, conv_dim) bfloat16,
``attn_k`` / ``attn_v`` (n_seg, b, max_len, KV, hd) bfloat16, and
``trail_ssm`` / ``trail_conv`` for the trailing blocks.  ``prefill`` and
``decode_step`` write it IN PLACE and return it.  Families other than
``dense`` and ``hybrid`` raise ``NotImplementedError``.

``train_loss`` is the dense family's training forward (the hybrid
family's waits for a gradient through the SSD scan): every attention
layer runs the flash kernel through ``FlashAttentionFn``, so
``loss.backward()`` reaches every parameter.  The reference's per-layer
``jax.checkpoint`` only saves memory and changes no number; the port
keeps every layer's activations.
"""

from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..device import resolve_device
from . import layers as L
from . import transformer as T
from . import zamba as Z

__all__ = [
    "init_params",
    "params_to",
    "count_params",
    "init_decode_state",
    "train_loss",
    "prefill",
    "decode_step",
]


PORTED_FAMILIES = ("dense", "hybrid")


def _ported(cfg: ArchConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported "
            f"(the port has {PORTED_FAMILIES})")


def init_params(generator: torch.Generator, cfg: ArchConfig, device=None):
    """Random parameters with the reference's shapes and scales, drawn in
    order (embedding, then the blocks in order of application, then the
    final norm) from ``generator``, which must live on ``device`` (``None``
    means CUDA)."""
    cfg.validate()
    _ported(cfg)
    dev = resolve_device(device)
    p = {"embed": L.init_embedding(generator, cfg, dev)}
    if cfg.family == "hybrid":
        p.update(Z.init_zamba(generator, cfg, dev))
    else:
        p["blocks"] = [T.init_block(generator, cfg, dev)
                       for _ in range(cfg.n_layers)]
    p["final_norm"] = L.init_norm(cfg, dev)
    return p


def params_to(params, device):
    """The same parameter tree with every tensor moved to ``device``."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [params_to(v, device) for v in params]
    return params.to(device)


def count_params(params) -> int:
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    if isinstance(params, list):
        return sum(count_params(v) for v in params)
    return params.numel()


TRAINED_FAMILIES = ("dense",)


def _trained(cfg: ArchConfig) -> None:
    if cfg.family not in TRAINED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: training of family {cfg.family!r} is not ported "
            f"(the port trains {TRAINED_FAMILIES})")


def _embed_inputs(cfg: ArchConfig, params, batch):
    """Returns (x (b, s, d), positions (s,), loss_mask (b, s) or None)."""
    tokens = torch.as_tensor(batch["tokens"],
                             device=_device_of(params)).long()
    x = L.embed_tokens(params["embed"], tokens)
    return x, torch.arange(x.shape[1], device=x.device), None


def _backbone(cfg: ArchConfig, params, x, positions):
    """Residual-stream pass through the blocks.  Returns (y, aux)."""
    _trained(cfg)
    rope = L.rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    for lp in params["blocks"]:
        x = T.apply_block(cfg, lp, x, rope)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def train_loss(cfg: ArchConfig, params, batch):
    """Mean next-token cross entropy.  ``batch``: {"tokens", "labels"},
    (b, s) integers.  Returns (loss, {"loss", "aux"}), float32 0-dim."""
    _trained(cfg)
    x, positions, mask = _embed_inputs(cfg, params, batch)
    x, aux = _backbone(cfg, params, x, positions)
    x = L.apply_norm(cfg, params["final_norm"], x)
    logits = L.unembed(cfg, params["embed"], x)
    labels = torch.as_tensor(batch["labels"], device=x.device)
    xent = L.softmax_xent(logits, labels, mask)
    loss = xent + aux
    return loss, {"loss": xent, "aux": aux}


def _device_of(params) -> torch.device:
    return params["embed"]["tokens"].device


def init_decode_state(cfg: ArchConfig, batch: int, max_len: int, device=None):
    """Zero decode state: dense {"k", "v"}: (L, batch, max_len, KV, hd)
    bfloat16; hybrid: ``zamba.init_zamba_decode_state``."""
    _ported(cfg)
    dev = resolve_device(device)
    if cfg.family == "hybrid":
        return Z.init_zamba_decode_state(cfg, batch, max_len, dev)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=L.DTYPE, device=dev),
            "v": torch.zeros(shape, dtype=L.DTYPE, device=dev)}


def prefill(cfg: ArchConfig, params, batch, max_len: int):
    """Process a prompt and build the decode state.

    ``batch["tokens"]``: (b, s) integer tokens.  K/V of every attention
    layer are written at positions [0, s) of a fresh state (and, hybrid,
    every Mamba-2 block's final SSM state and conv tail).  Returns (logits
    of the last position (b, 1, V) in bfloat16, state).
    """
    _ported(cfg)
    dev = _device_of(params)
    tokens = torch.as_tensor(batch["tokens"], device=dev).long()
    b, s = tokens.shape
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens exceeds max_len {max_len}")
    state = init_decode_state(cfg, b, max_len, dev)
    x = L.embed_tokens(params["embed"], tokens)
    rope = L.rope_tables(torch.arange(s, device=dev), cfg.head_dim,
                         cfg.rope_theta)
    if cfg.family == "hybrid":
        x = Z.apply_zamba_prefill(cfg, params, x, rope, state)
    else:
        for i, lp in enumerate(params["blocks"]):
            x = T.apply_block(cfg, lp, x, rope,
                              kv_sink=(state["k"][i], state["v"][i]))
    x = L.apply_norm(cfg, params["final_norm"], x[:, -1:])
    return L.unembed(cfg, params["embed"], x), state


def decode_step(cfg: ArchConfig, params, state, token, cache_len: int):
    """One-token step.  ``token`` (b, 1) integers; ``cache_len`` (a host
    int) is the number of tokens already in the cache, and the new token
    sits at position ``cache_len``.  Returns (logits (b, 1, V), state)."""
    _ported(cfg)
    dev = _device_of(params)
    cache_len = int(cache_len)
    max_len = state["attn_k" if cfg.family == "hybrid" else "k"].shape[2]
    if not 0 <= cache_len < max_len:
        raise ValueError(f"cache_len {cache_len} outside the cache "
                         f"[0, {max_len})")
    x = L.embed_tokens(params["embed"], torch.as_tensor(token, device=dev).long())
    rope = L.rope_tables(torch.full((1,), cache_len, device=dev),
                         cfg.head_dim, cfg.rope_theta)
    if cfg.family == "hybrid":
        x = Z.apply_zamba_decode(cfg, params, x, state, cache_len, rope)
    else:
        for i, lp in enumerate(params["blocks"]):
            x, _, _ = T.apply_block_decode(cfg, lp, x, state["k"][i],
                                           state["v"][i], cache_len, rope)
    x = L.apply_norm(cfg, params["final_norm"], x)
    return L.unembed(cfg, params["embed"], x), state
