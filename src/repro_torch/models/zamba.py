"""Zamba2-7B hybrid of the port: a Mamba-2 backbone and ONE shared-weight
attention + MLP block applied after every ``attn_every``-th Mamba-2 block.

Follows ``repro.models.zamba``.  81 layers with attn_every = 6 give 13
segments of (6 Mamba-2 blocks + the shared block) and 3 trailing Mamba-2
blocks.  The shared block's weights are reused at every application; each
application keeps its OWN KV cache.  The reference scans over segments
stacked on leading axes; the port keeps ``mamba_segments`` as a list (one
per segment) of lists (one dict per block) and ``mamba_trailing`` as a
list, and loops.

The shared block is the dense family's block (``transformer.apply_block``
with ``kv_sink`` in prefill, ``apply_block_decode`` in decode), so prefill
runs ``flash_attention`` and decode ``decode_attention`` once per
application, and each Mamba-2 block of prefill runs ``ssd_scan`` once.
Prefill and decode write the decode state IN PLACE.

:func:`apply_zamba` is the training forward: under grad mode each Mamba-2
block's scan goes through ``SsdScanFn`` and each shared application's
attention through ``FlashAttentionFn``, so ``backward`` reaches every
parameter.  The shared block's weights enter the graph once per
application, so autograd sums their gradient over the applications.  The
reference wraps each block and each segment in ``jax.checkpoint`` (save
nothing, recompute in the backward), which only saves memory: the port
keeps every block's activations in the autograd graph until the
backward, and recomputes only the scan (``ssd_scan_grad`` runs the plain
scan again under grad mode).
"""

from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from . import layers as L
from . import ssm
from . import transformer as T

__all__ = [
    "segment_layout",
    "init_zamba",
    "apply_zamba",
    "apply_zamba_prefill",
    "zamba_decode_state_shape",
    "init_zamba_decode_state",
    "apply_zamba_decode",
]

STATE_DTYPES = {"seg_ssm": torch.float32, "seg_conv": L.DTYPE,
                "attn_k": L.DTYPE, "attn_v": L.DTYPE,
                "trail_ssm": torch.float32, "trail_conv": L.DTYPE}


def segment_layout(cfg: ArchConfig) -> tuple[int, int, int]:
    """(n_segments, seg_len, n_trailing)."""
    k = cfg.hybrid.attn_every
    n_seg = cfg.n_layers // k
    return n_seg, k, cfg.n_layers - n_seg * k


def init_zamba(gen: torch.Generator, cfg: ArchConfig, device):
    """Segments' blocks in order, then the shared block, then the trailing
    blocks, all drawn from ``gen``."""
    n_seg, seg, trailing = segment_layout(cfg)
    p = {
        "mamba_segments": [[ssm.init_mamba2_block(gen, cfg, device)
                            for _ in range(seg)] for _ in range(n_seg)],
        "shared_attn": T.init_block(gen, cfg, device),
    }
    if trailing:
        p["mamba_trailing"] = [ssm.init_mamba2_block(gen, cfg, device)
                               for _ in range(trailing)]
    return p


def zamba_decode_state_shape(cfg: ArchConfig, batch: int, max_len: int):
    n_seg, seg, trailing = segment_layout(cfg)
    st = ssm.mamba2_state_shape(cfg, batch)
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    shapes = {
        "seg_ssm": (n_seg, seg) + st["ssm"],
        "seg_conv": (n_seg, seg) + st["conv"],
        "attn_k": (n_seg, batch, max_len, kv, hd),
        "attn_v": (n_seg, batch, max_len, kv, hd),
    }
    if trailing:
        shapes["trail_ssm"] = (trailing,) + st["ssm"]
        shapes["trail_conv"] = (trailing,) + st["conv"]
    return shapes


def init_zamba_decode_state(cfg: ArchConfig, batch: int, max_len: int,
                            device):
    """Zeros with the reference's keys, layouts and dtypes: SSM states in
    float32, conv tails and KV caches in bfloat16."""
    return {k: torch.zeros(v, dtype=STATE_DTYPES[k], device=device)
            for k, v in zamba_decode_state_shape(cfg, batch, max_len).items()}


def apply_zamba(cfg: ArchConfig, params, x, rope):
    """Training forward.  x: (b, s, d); ``rope``: the rotary tables of
    positions [0, s).  Every segment's Mamba-2 blocks, each followed by the
    shared block, then the trailing blocks; the final states are
    discarded.  Returns y."""
    n_seg, _, trailing = segment_layout(cfg)
    shared = params["shared_attn"]
    for i in range(n_seg):
        for lp in params["mamba_segments"][i]:
            x, _ = ssm.apply_mamba2_block(cfg, lp, x)
        x = T.apply_block(cfg, shared, x, rope)
    for lp in params["mamba_trailing"] if trailing else ():
        x, _ = ssm.apply_mamba2_block(cfg, lp, x)
    return x


def _mamba_prefill(cfg, blocks, x, ssm_sink, conv_sink):
    for j, lp in enumerate(blocks):
        x, st = ssm.apply_mamba2_block(cfg, lp, x)
        ssm_sink[j].copy_(st["ssm"])
        conv_sink[j].copy_(st["conv"])
    return x


def apply_zamba_prefill(cfg: ArchConfig, params, x, rope, state):
    """Prompt pass.  x: (b, s, d); ``rope``: the rotary tables of positions
    [0, s).  Writes every block's SSM state and conv tail, and every shared
    application's K/V at [0, s), into ``state`` in place.  Returns y."""
    n_seg, _, trailing = segment_layout(cfg)
    shared = params["shared_attn"]
    for i in range(n_seg):
        x = _mamba_prefill(cfg, params["mamba_segments"][i], x,
                           state["seg_ssm"][i], state["seg_conv"][i])
        x = T.apply_block(cfg, shared, x, rope,
                          kv_sink=(state["attn_k"][i], state["attn_v"][i]))
    if trailing:
        x = _mamba_prefill(cfg, params["mamba_trailing"], x,
                           state["trail_ssm"], state["trail_conv"])
    return x


def _mamba_decode(cfg, blocks, x, ssm_state, conv_state):
    for j, lp in enumerate(blocks):
        x, _ = ssm.apply_mamba2_decode(
            cfg, lp, x, {"ssm": ssm_state[j], "conv": conv_state[j]})
    return x


def apply_zamba_decode(cfg: ArchConfig, params, x, state, cache_len: int,
                       rope):
    """x: (b, 1, d) at position ``cache_len``; ``rope``: its rotary
    tables.  Updates ``state`` in place.  Returns y."""
    n_seg, _, trailing = segment_layout(cfg)
    shared = params["shared_attn"]
    for i in range(n_seg):
        x = _mamba_decode(cfg, params["mamba_segments"][i], x,
                          state["seg_ssm"][i], state["seg_conv"][i])
        x, _, _ = T.apply_block_decode(cfg, shared, x, state["attn_k"][i],
                                       state["attn_v"][i], cache_len, rope)
    if trailing:
        x = _mamba_decode(cfg, params["mamba_trailing"], x,
                          state["trail_ssm"], state["trail_conv"])
    return x
