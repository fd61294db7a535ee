"""Model API of the port, over all ten architectures.

    params          = init_params(generator, cfg, device)
    specs           = param_specs(cfg, policy)   # placements, same layout
    loss, metrics   = train_loss(cfg, params, batch)
    logits, state   = prefill(cfg, params, batch, max_len)
    logits, state   = decode_step(cfg, params, state, token, cache_len)

As ``repro.models.lm`` without the ``Shard`` argument (a model runs on
one card; ``models.sharding.Shard`` gives the placements the reference's
hooks would apply, and the models do not call it).  ``params`` is a dict; the
reference's blocks, stacked on leading axes by ``vmap``, are lists here,
one dict per block:

* dense: ``{"embed", "blocks": [block, ...], "final_norm"}``; vlm adds
  ``"projector": {"w" (frontend_dim, d)}``;
* moe: ``"blocks"`` of ``{ln1, attn, ln2, moe}`` (``models.moe``), and
  ``"dense_block"`` (layer 0) when ``first_layer_dense``;
* hybrid (zamba2): ``"mamba_segments": [[block, ...] per segment],
  "shared_attn", "mamba_trailing"`` (``models.zamba``);
* ssm (xLSTM): ``"mlstm_segments": [[block, ...] per segment],
  "slstm_blocks": [block per segment], "mlstm_trailing"``
  (``models.xlstm``; :func:`_xlstm_layout`);
* audio (whisper): ``models.whisper.init_whisper``'s tree.

:func:`param_specs` and :func:`decode_state_specs` are the placement
trees of the parameters and of the decode state on a production mesh
under a ``ShardingPolicy``: the reference's ``PartitionSpec`` trees with
each spec a tuple of its entries (``None``, an axis name or a tuple of
them), in the port's layout.  Where the reference stacks blocks on
leading dims (unplaced, ``P(None, *spec)``), the port's list holds each
block's own spec.  The decode state keeps the reference's stacked layout,
so its placements are the reference's.  The models do not read them on one
card (``launch.specs``, ``launch.dryrun``).

The decode state keeps the reference's layout: dense, vlm and moe
``{"k", "v"}`` (L, b, max_len, KV, hd) bfloat16 (moe's dense layer 0 holds
slot 0); hybrid ``seg_ssm``, ``seg_conv``, ``attn_k`` / ``attn_v``,
``trail_ssm``, ``trail_conv``; ssm ``m_c`` (n_seg, m_per, b, H, dk, dv),
``m_n``, ``m_m``, ``m_conv``, ``s_c`` / ``s_n`` / ``s_m`` / ``s_h``
(n_seg, b, H, d/H), ``t_c`` ... ``t_conv`` for the trailing blocks (float32
but the conv tails, bfloat16); audio ``self_k``, ``self_v``, ``cross_k``,
``cross_v`` (L, b, max_len, KV, hd).  ``prefill`` and ``decode_step``
write it IN PLACE and return it.  ``prefill`` raises
``NotImplementedError`` for audio, as the reference's does: whisper runs
``whisper.encode``, the cross cache, and ``decode_step``.

``train_loss`` is the training forward of all six families: every
attention layer (causal, and whisper's bidirectional encoder and cross
attention) runs the flash kernel through ``FlashAttentionFn`` and, hybrid,
every Mamba-2 block the SSD scan kernel through ``SsdScanFn``, whose
backwards are kernels too (on a CPU tensor, the plain backwards), so
``loss.backward()`` reaches every parameter.  moe adds the MoE layers'
load-balancing losses to the cross entropy; vlm scores only the text
positions behind the patch slots; audio runs ``whisper.encode`` and
``whisper.decode_train``; the xLSTM recurrences are tensor ops (no Pallas
kernel computes them in the reference).  The reference's per-layer and
per-segment ``jax.checkpoint`` only saves memory and changes no number;
the port keeps every layer's activations.
"""

from __future__ import annotations

import functools
import math

import torch

from ..configs.base import ArchConfig, ShardingPolicy
from ..device import resolve_device
from . import layers as L
from . import moe as M
from . import transformer as T
from . import whisper as W
from . import xlstm as X
from . import zamba as Z

__all__ = [
    "init_params",
    "param_specs",
    "params_to",
    "count_params",
    "active_params",
    "init_decode_state",
    "decode_state_shapes",
    "decode_state_specs",
    "train_loss",
    "prefill",
    "decode_step",
]


def _xlstm_layout(cfg: ArchConfig) -> tuple[int, int, int]:
    """(n_segments, mlstm_per_segment, trailing_mlstm): segments of mLSTM
    blocks each ending in an sLSTM, then the trailing mLSTM blocks."""
    sl = sorted(cfg.ssm.slstm_layers)
    if not sl:
        return 0, 0, cfg.n_layers
    seg_len = sl[0] + 1
    expect = tuple(seg_len * (i + 1) - 1 for i in range(len(sl)))
    if tuple(sl) != expect:
        raise ValueError(
            f"slstm_layers {sl} must be uniformly spaced ends of segments")
    n_seg = len(sl)
    trailing = cfg.n_layers - n_seg * seg_len
    if trailing < 0:
        raise ValueError("slstm layout exceeds n_layers")
    return n_seg, seg_len - 1, trailing


def _build(gen, cfg: ArchConfig, dev: torch.device):
    """The parameter tree, drawn from ``gen`` on ``dev``."""
    if cfg.family == "audio":
        return W.init_whisper(gen, cfg, dev)
    p = {"embed": L.init_embedding(gen, cfg, dev)}
    if cfg.family == "vlm":
        p["projector"] = {"w": L._normal(gen, (cfg.frontend_dim, cfg.d_model),
                                         cfg.frontend_dim ** -0.5, dev)}
    if cfg.family in ("dense", "vlm"):
        p["blocks"] = [T.init_block(gen, cfg, dev)
                       for _ in range(cfg.n_layers)]
    elif cfg.family == "moe":
        if cfg.moe.first_layer_dense:
            p["dense_block"] = T.init_block(gen, cfg, dev)
        p["blocks"] = [M.init_moe_block(gen, cfg, dev)
                       for _ in range(cfg.n_layers - _n_dense(cfg))]
    elif cfg.family == "ssm":
        n_seg, m_per, trailing = _xlstm_layout(cfg)
        if n_seg:
            p["mlstm_segments"] = [[X.init_mlstm_block(gen, cfg, dev)
                                    for _ in range(m_per)]
                                   for _ in range(n_seg)]
            p["slstm_blocks"] = [X.init_slstm_block(gen, cfg, dev)
                                 for _ in range(n_seg)]
        if trailing:
            p["mlstm_trailing"] = [X.init_mlstm_block(gen, cfg, dev)
                                   for _ in range(trailing)]
    elif cfg.family == "hybrid":
        p.update(Z.init_zamba(gen, cfg, dev))
    else:
        raise ValueError(f"unknown family {cfg.family}")
    p["final_norm"] = L.init_norm(cfg, dev)
    return p


def init_params(generator: torch.Generator, cfg: ArchConfig, device=None):
    """Random parameters with the reference's shapes and scales, drawn in
    order (embedding, then the blocks in order of application, then the
    final norm) from ``generator``, which must live on ``device`` (``None``
    means CUDA)."""
    cfg.validate()
    return _build(generator, cfg, resolve_device(device))


def param_specs(cfg: ArchConfig, policy: ShardingPolicy):
    """The placement tree of :func:`init_params`'s tree (the module's
    docstring)."""
    if cfg.family == "audio":
        return W.whisper_specs(cfg, policy)
    p = {"embed": L.embedding_specs(cfg, policy)}
    if cfg.family == "vlm":
        p["projector"] = {"w": (None, L._dp(policy))}
    if cfg.family in ("dense", "vlm"):
        p["blocks"] = [T.block_specs(cfg, policy)] * cfg.n_layers
    elif cfg.family == "moe":
        if cfg.moe.first_layer_dense:
            p["dense_block"] = T.block_specs(cfg, policy)
        p["blocks"] = ([M.moe_block_specs(cfg, policy)]
                       * (cfg.n_layers - _n_dense(cfg)))
    elif cfg.family == "ssm":
        n_seg, m_per, trailing = _xlstm_layout(cfg)
        ms = X.mlstm_block_specs(cfg, policy)
        if n_seg:
            p["mlstm_segments"] = [[ms] * m_per for _ in range(n_seg)]
            p["slstm_blocks"] = [X.slstm_block_specs(cfg, policy)] * n_seg
        if trailing:
            p["mlstm_trailing"] = [ms] * trailing
    elif cfg.family == "hybrid":
        p.update(Z.zamba_specs(cfg, policy))
    else:
        raise ValueError(f"unknown family {cfg.family}")
    p["final_norm"] = L.norm_specs(cfg)
    return p


def params_to(params, device):
    """The same parameter tree with every tensor moved to ``device``."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [params_to(v, device) for v in params]
    return params.to(device)


def count_params(params) -> int:
    """Elements of a parameter tree; given an ``ArchConfig``, of its tree
    at full size, built on the meta device (nothing is allocated), once a
    config."""
    if isinstance(params, ArchConfig):
        return _full_size_count(params)
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    if isinstance(params, list):
        return sum(count_params(v) for v in params)
    return params.numel()


@functools.lru_cache(maxsize=None)
def _full_size_count(cfg: ArchConfig) -> int:
    cfg.validate()
    return count_params(_build(None, cfg, torch.device("meta")))


def active_params(cfg: ArchConfig) -> int:
    """Active parameters per token (MoE: only the top_k and shared
    experts of each MoE layer)."""
    total = count_params(cfg)
    if cfg.moe is None:
        return total
    moe = cfg.moe
    per_expert = 3 * cfg.d_model * moe.d_expert
    n_moe_layers = cfg.n_layers - _n_dense(cfg)
    return total - n_moe_layers * (moe.n_experts - moe.top_k) * per_expert


def _n_dense(cfg: ArchConfig) -> int:
    """Dense layers ahead of the MoE layers (DeepSeekMoE's layer 0)."""
    return 1 if cfg.moe is not None and cfg.moe.first_layer_dense else 0


TRAINED_FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "audio")


def _trained(cfg: ArchConfig) -> None:
    if cfg.family not in TRAINED_FAMILIES:
        raise ValueError(
            f"{cfg.name}: unknown family {cfg.family!r} (the port trains "
            f"{TRAINED_FAMILIES})")


def _embed_inputs(cfg: ArchConfig, params, batch):
    """Returns (x (b, s, d), positions (s,)).  vlm: the projected
    ``batch["patch_embeds"]`` (b, n_patches, frontend_dim) go before the
    token embeddings."""
    dev = _device_of(params)
    tokens = torch.as_tensor(batch["tokens"], device=dev).long()
    x = L.embed_tokens(params["embed"], tokens)
    if cfg.family == "vlm":
        w = params["projector"]["w"]
        # bfloat16 patches whatever the weights' dtype, as the reference
        pe = (torch.as_tensor(batch["patch_embeds"], device=dev)
              .to(L.DTYPE).to(w.dtype) @ w)
        x = torch.cat([pe, x], dim=1)
    return x, torch.arange(x.shape[1], device=dev)


def _backbone(cfg: ArchConfig, params, x, positions):
    """Residual-stream pass through the blocks, in the reference's order:
    moe's dense layer 0 first; ssm's segments of mLSTM blocks, each ending
    in its sLSTM, then the trailing mLSTM blocks.  Returns (y, aux): the
    MoE layers' load-balancing losses summed, else 0."""
    _trained(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "ssm":
        for kind, lp, _, _ in _xlstm_blocks(cfg, params):
            apply = X.apply_mlstm_block if kind == "m" else X.apply_slstm_block
            x, _ = apply(cfg, lp, x)
        return x, aux
    rope = L.rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    if cfg.family == "hybrid":
        x = Z.apply_zamba(cfg, params, x, rope)
    elif cfg.family == "moe":
        if cfg.moe.first_layer_dense:
            x = T.apply_block(cfg, params["dense_block"], x, rope)
        auxs = []
        for lp in params["blocks"]:
            x, a = M.apply_moe_block(cfg, lp, x, rope)
            auxs.append(a)
        aux = aux + torch.stack(auxs).sum()
    else:
        for lp in params["blocks"]:
            x = T.apply_block(cfg, lp, x, rope)
    return x, aux


def train_loss(cfg: ArchConfig, params, batch):
    """Mean next-token cross entropy (+ the MoE layers' aux loss).
    ``batch``: {"tokens", "labels"}, (b, s) integers; vlm adds
    ``"patch_embeds"`` (b, n_patches, frontend_dim), whose slots go ahead
    of the tokens and get no loss; audio adds ``"frames"`` (b, t,
    frontend_dim) for the encoder, the tokens being the decoder's.
    Returns (loss, {"loss", "aux"}), float32 0-dim."""
    _trained(cfg)
    if cfg.family == "audio":
        enc = W.encode(cfg, params, batch["frames"])
        logits = W.decode_train(cfg, params, batch["tokens"], enc)
        labels = torch.as_tensor(batch["labels"], device=logits.device)
        loss = L.softmax_xent(logits, labels)
        return loss, {"loss": loss, "aux": torch.zeros(
            (), dtype=torch.float32, device=loss.device)}
    x, positions = _embed_inputs(cfg, params, batch)
    x, aux = _backbone(cfg, params, x, positions)
    x = L.apply_norm(cfg, params["final_norm"], x)
    if cfg.family == "vlm":
        # only the text positions produce logits and loss
        x = x[:, cfg.n_patches:]
    logits = L.unembed(cfg, params["embed"], x)
    labels = torch.as_tensor(batch["labels"], device=x.device)
    xent = L.softmax_xent(logits, labels)
    loss = xent + aux
    return loss, {"loss": xent, "aux": aux}


def _device_of(params) -> torch.device:
    return params["embed"]["tokens"].device


def decode_state_shapes(cfg: ArchConfig, batch: int, max_len: int):
    """{name: (shape, dtype)} of the decode state."""
    f32, bf16 = torch.float32, L.DTYPE
    if cfg.family in ("dense", "vlm", "moe"):
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        return {"k": (shape, bf16), "v": (shape, bf16)}
    if cfg.family == "ssm":
        n_seg, m_per, trailing = _xlstm_layout(cfg)
        m = X.mlstm_state_shape(cfg, batch)
        s = X.slstm_state_shape(cfg, batch)
        out = {}
        if n_seg:
            for k in ("c", "n", "m", "conv"):
                out[f"m_{k}"] = ((n_seg, m_per) + m[k],
                                 bf16 if k == "conv" else f32)
            for k in ("c", "n", "m", "h"):
                out[f"s_{k}"] = ((n_seg,) + s[k], f32)
        if trailing:
            for k in ("c", "n", "m", "conv"):
                out[f"t_{k}"] = ((trailing,) + m[k],
                                 bf16 if k == "conv" else f32)
        return out
    if cfg.family == "hybrid":
        return {k: (v, Z.STATE_DTYPES[k]) for k, v in
                Z.zamba_decode_state_shape(cfg, batch, max_len).items()}
    if cfg.family == "audio":
        return {k: (v, bf16) for k, v in
                W.whisper_cache_shape(cfg, batch, max_len).items()}
    raise ValueError(cfg.family)


def decode_state_specs(cfg: ArchConfig, policy: ShardingPolicy,
                       batch_shardable: bool = True):
    """The placement tree of :func:`decode_state_shapes`' state.
    ``batch_shardable=False`` (long_500k's batch of 1): the batch dim is
    whole and long-context caches place their seq dim over dp instead."""
    dp = policy.dp_axes if batch_shardable else None
    m = policy.model_axis
    kv_m = m if policy.shard_kv_heads else None
    if policy.kv_seq_shard and not batch_shardable:
        kv_spec = (None, None, policy.dp_axes, kv_m, None)
    elif policy.kv_seq_shard:
        kv_spec = (None, dp, m, None, None)
    else:
        kv_spec = (None, dp, None, kv_m, None)
    if cfg.family in ("dense", "vlm", "moe"):
        return {"k": kv_spec, "v": kv_spec}
    if cfg.family == "ssm":
        n_seg, _, trailing = _xlstm_layout(cfg)
        out = {}
        # mLSTM state: dv over model (the heads are few)
        if n_seg:
            out.update(m_c=(None, None, dp, None, None, m),
                       m_n=(None, None, dp, None, None),
                       m_m=(None, None, dp, None),
                       m_conv=(None, None, dp, None, m))
            for k in ("s_c", "s_n", "s_m", "s_h"):
                out[k] = (None, dp, None, m)
        if trailing:
            out.update(t_c=(None, dp, None, None, m), t_n=(None, dp, None, None),
                       t_m=(None, dp, None), t_conv=(None, dp, None, m))
        return out
    if cfg.family == "hybrid":
        if policy.kv_seq_shard and not batch_shardable:
            att = (None, None, policy.dp_axes, m, None)
        elif policy.kv_seq_shard:
            att = (None, dp, m, None, None)
        else:
            att = (None, dp, None, m, None)
        return {
            "seg_ssm": (None, None, dp, m, None, None),
            "seg_conv": (None, None, dp, None, m),
            "attn_k": att,
            "attn_v": att,
            "trail_ssm": (None, dp, m, None, None),
            "trail_conv": (None, dp, None, m),
        }
    if cfg.family == "audio":
        kv2 = ((None, dp, m, None, None) if policy.kv_seq_shard
               else (None, dp, None, m, None))
        return {k: kv2 for k in ("self_k", "self_v", "cross_k", "cross_v")}
    raise ValueError(cfg.family)


def init_decode_state(cfg: ArchConfig, batch: int, max_len: int, device=None):
    """Zero decode state in the reference's layout (the module's
    docstring)."""
    return _zero_state(cfg, batch, max_len, resolve_device(device))


def _zero_state(cfg: ArchConfig, batch: int, max_len: int,
                dev: torch.device):
    """The zero decode state on ``dev`` (the parameters' device: the
    meta device too, for the dry-run's count)."""
    return {k: torch.zeros(shape, dtype=dt, device=dev)
            for k, (shape, dt) in decode_state_shapes(cfg, batch,
                                                      max_len).items()}


def _xlstm_blocks(cfg: ArchConfig, params):
    """Every xLSTM block in order of application with its state slot:
    (kind "m" / "s", params, state-key prefix, slot index)."""
    n_seg, m_per, trailing = _xlstm_layout(cfg)
    for i in range(n_seg):
        for j in range(m_per):
            yield "m", params["mlstm_segments"][i][j], "m", (i, j)
        yield "s", params["slstm_blocks"][i], "s", (i,)
    for j in range(trailing):
        yield "m", params["mlstm_trailing"][j], "t", (j,)


def _store(state, prefix, idx, new):
    for k, v in new.items():
        state[f"{prefix}_{k}"][idx].copy_(v)


def _read(state, prefix, idx, keys):
    return {k: state[f"{prefix}_{k}"][idx] for k in keys}


def prefill(cfg: ArchConfig, params, batch, max_len: int):
    """Process a prompt and build the decode state.

    ``batch["tokens"]``: (b, s) integer tokens (vlm: and
    ``batch["patch_embeds"]`` (b, n_patches, frontend_dim), which take
    positions [0, n_patches) ahead of the text).  K / V of every attention
    layer are written at positions [0, n_patches + s) of a fresh state (and
    every Mamba-2 block's final SSM state and conv tail, or every xLSTM
    block's final state).  Returns (logits of the last position (b, 1, V)
    in bfloat16, state).
    """
    if cfg.family == "audio":
        raise NotImplementedError(
            f"{cfg.name}: prefill of family 'audio' (whisper serves through "
            f"whisper.encode and decode_step)")
    dev = _device_of(params)
    x, positions = _embed_inputs(cfg, params, batch)
    b, s, _ = x.shape
    if s > max_len:
        raise ValueError(f"prompt of {s} positions exceeds max_len {max_len}")
    state = _zero_state(cfg, b, max_len, dev)
    rope = L.rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    if cfg.family == "hybrid":
        x = Z.apply_zamba_prefill(cfg, params, x, rope, state)
    elif cfg.family == "ssm":
        for kind, lp, prefix, idx in _xlstm_blocks(cfg, params):
            apply = X.apply_mlstm_block if kind == "m" else X.apply_slstm_block
            x, new = apply(cfg, lp, x)
            _store(state, prefix, idx, new)
    else:
        layer = 0
        if cfg.family == "moe" and cfg.moe.first_layer_dense:
            x = T.apply_block(cfg, params["dense_block"], x, rope,
                              kv_sink=(state["k"][0], state["v"][0]))
            layer = 1
        for i, lp in enumerate(params["blocks"], start=layer):
            sink = (state["k"][i], state["v"][i])
            if cfg.family == "moe":
                x, _ = M.apply_moe_block(cfg, lp, x, rope, kv_sink=sink)
            else:
                x = T.apply_block(cfg, lp, x, rope, kv_sink=sink)
    x = L.apply_norm(cfg, params["final_norm"], x[:, -1:])
    return L.unembed(cfg, params["embed"], x), state


def _max_len(cfg: ArchConfig, state) -> int:
    """The cache length of an attention state; the ssm family has none."""
    key = {"hybrid": "attn_k", "audio": "self_k", "ssm": None}.get(
        cfg.family, "k")
    return math.inf if key is None else state[key].shape[2]


def decode_step(cfg: ArchConfig, params, state, token, cache_len: int):
    """One-token step.  ``token`` (b, 1) integers; ``cache_len`` (a host
    int) is the number of positions already in the cache (vlm: the patches
    included), and the new token sits at position ``cache_len``.  Returns
    (logits (b, 1, V), state).

    audio: the reference's rule, ``whisper.decode_step`` with ``cross_len =
    cache_len``, so the decoder at step t sees only the first t encoder
    frames (a defect of the reference, ROADMAP C).  At ``cache_len`` 0 the
    reference's mask hides every frame; the port raises there.
    """
    cache_len = int(cache_len)
    max_len = _max_len(cfg, state)
    if not 0 <= cache_len < max_len:
        raise ValueError(f"cache_len {cache_len} outside the cache "
                         f"[0, {max_len})")
    if cfg.family == "audio":
        if cache_len < 1:
            raise ValueError("cache_len 0: the reference's rule cross_len = "
                             "cache_len attends to no encoder frame")
        return W.decode_step(cfg, params, state, token, cache_len, cache_len)
    dev = _device_of(params)
    x = L.embed_tokens(params["embed"], torch.as_tensor(token, device=dev).long())
    rope = L.rope_tables(torch.full((1,), cache_len, device=dev),
                         cfg.head_dim, cfg.rope_theta)
    if cfg.family == "hybrid":
        x = Z.apply_zamba_decode(cfg, params, x, state, cache_len, rope)
    elif cfg.family == "ssm":
        for kind, lp, prefix, idx in _xlstm_blocks(cfg, params):
            if kind == "m":
                x, new = X.apply_mlstm_decode(
                    cfg, lp, x, _read(state, prefix, idx, ("c", "n", "m",
                                                           "conv")))
            else:
                x, new = X.apply_slstm_decode(
                    cfg, lp, x, _read(state, prefix, idx, ("c", "n", "m",
                                                           "h")))
            _store(state, prefix, idx, new)
    else:
        layer = 0
        if cfg.family == "moe" and cfg.moe.first_layer_dense:
            x, _, _ = T.apply_block_decode(cfg, params["dense_block"], x,
                                           state["k"][0], state["v"][0],
                                           cache_len, rope)
            layer = 1
        for i, lp in enumerate(params["blocks"], start=layer):
            if cfg.family == "moe":
                x = M.apply_moe_block_decode(cfg, lp, x, state["k"][i],
                                             state["v"][i], cache_len, rope)
            else:
                x, _, _ = T.apply_block_decode(cfg, lp, x, state["k"][i],
                                               state["v"][i], cache_len, rope)
    x = L.apply_norm(cfg, params["final_norm"], x)
    return L.unembed(cfg, params["embed"], x), state
