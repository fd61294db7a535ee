"""Mamba-2 / SSD block of the port (the zamba2-7b backbone).

Follows ``repro.models.ssm``.  Per head h, with scalar decay:

    a_t = exp(dt_t * A)                       A = -exp(a_log) < 0
    S_t = a_t * S_{t-1} + dt_t * (B_t ⊗ x_t)  S: (N, P) per head
    y_t = C_t · S_t + D * x_t

Prefill runs the chunked form through the hand-written ``ssd_scan`` kernel
where the reference calls its XLA twin ``ssd_chunked`` (on a CPU tensor the
kernel's plain version, which is ``ssd_chunked``).  With grad mode on and
an input that requires grad (training), :func:`apply_mamba2_block` goes
through ``SsdScanFn`` instead: the same kernel forward, and a backward.
Decode keeps S as the cache and takes one recurrent step
(:func:`ssd_decode_step`, plain PyTorch, as the reference's, which has no
Pallas kernel).

Parameters and activations are bfloat16 (``layers.DTYPE``) except
``a_log``, ``d_skip`` and ``dt_bias``, which stay float32; dt, the state and
the gated RMSNorm run in float32, as in the reference.  Decode writes the
SSM state and the conv tail IN PLACE (the reference returns new arrays).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels.ssm_scan.ops import SsdScanFn, expand_groups, ssd_scan
from . import layers as L

__all__ = [
    "ssd_decode_step",
    "mamba2_state_shape",
    "init_mamba2_block",
    "apply_mamba2_block",
    "apply_mamba2_decode",
]


def ssd_decode_step(state, x, dt, a_log, b, c, d_skip):
    """One-token recurrent update.  x (B, H, P); dt (B, H) float32; b, c
    (B, G, N); state (B, H, N, P) float32, updated IN PLACE.  Returns
    (y (B, H, P) in x's dtype, state)."""
    h = x.shape[1]
    a = -torch.exp(a_log.float())
    bf = expand_groups(b, h, 1).float()
    cf = expand_groups(c, h, 1).float()
    dtf = dt.float()
    decay = torch.exp(dtf * a)  # (B, H)
    upd = torch.einsum("bh,bhn,bhp->bhnp", dtf, bf, x.float())
    state.mul_(decay[..., None, None]).add_(upd)
    y = torch.einsum("bhn,bhnp->bhp", cf, state)
    y = y + d_skip.float()[None, :, None] * x.float()
    return y.to(x.dtype), state


def _dims(cfg: ArchConfig):
    d_inner = cfg.ssm.expansion * cfg.d_model
    return d_inner, d_inner // cfg.ssm.head_dim


def _conv_dim(cfg: ArchConfig) -> int:
    return _dims(cfg)[0] + 2 * cfg.ssm.n_groups * cfg.ssm.state_dim


def mamba2_state_shape(cfg: ArchConfig, batch: int):
    ssm = cfg.ssm
    _, n_heads = _dims(cfg)
    return {
        "ssm": (batch, n_heads, ssm.state_dim, ssm.head_dim),
        "conv": (batch, ssm.conv_kernel - 1, _conv_dim(cfg)),
    }


def init_mamba2_block(gen: torch.Generator, cfg: ArchConfig, device):
    """The reference's shapes and scales, drawn from ``gen`` in the order
    in_proj, conv_w, out_proj."""
    ssm = cfg.ssm
    d = cfg.d_model
    d_inner, n_heads = _dims(cfg)
    conv_dim = _conv_dim(cfg)
    proj_out = 2 * d_inner + 2 * ssm.n_groups * ssm.state_dim + n_heads
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "ln": L.init_norm(cfg, device),
        "in_proj": L._normal(gen, (d, proj_out), d ** -0.5, device),
        "conv_w": L._normal(gen, (ssm.conv_kernel, conv_dim), 0.1, device),
        "conv_b": torch.zeros((conv_dim,), dtype=L.DTYPE, device=device),
        "a_log": torch.zeros((n_heads,), **f32),  # A = -exp(0) = -1
        "d_skip": torch.ones((n_heads,), **f32),
        "dt_bias": torch.zeros((n_heads,), **f32),
        "gate_ln": {"scale": torch.ones((d_inner,), dtype=L.DTYPE,
                                        device=device)},
        "out_proj": L._normal(gen, (d_inner, d), d_inner ** -0.5, device),
    }


def _split_proj(cfg: ArchConfig, zxbcdt):
    """(z, xbc, dt) views of the input projection."""
    d_inner, n_heads = _dims(cfg)
    conv_dim = _conv_dim(cfg)
    return zxbcdt.split([d_inner, conv_dim, n_heads], dim=-1)


def _causal_depthwise_conv(x, w, b, prev=None):
    """x: (B, S, C); w: (K, C); prev: (B, K-1, C) left context (decode).
    The reference's sum of K shifted products, in x's dtype."""
    k = w.shape[0]
    if prev is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = prev.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # (B, S+K-1, C)
    s = x.shape[1]
    out = xp[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + xp[:, i: i + s] * w[i]
    return out + b


def _gated_out(params, y, z, x):
    """The gated RMSNorm of Mamba-2, norm(y * silu(z)) in float32 with eps
    1e-6, then the output projection and the residual."""
    gated = y * F.silu(z.float()).to(y.dtype)
    gf = gated.float()
    gf = gf * torch.rsqrt((gf * gf).mean(dim=-1, keepdim=True) + 1e-6)
    gated = (gf * params["gate_ln"]["scale"].float()).to(x.dtype)
    return x + gated @ params["out_proj"]


def _ssm_inputs(cfg: ArchConfig, params, xbc, dt_pre, x_dtype):
    """silu of the conv output split into x (.., H, P) and b, c (.., G, N),
    views of one activation; dt = softplus(dt_pre + dt_bias) in float32.

    The scan reads the views in place, without a copy: P and N are
    multiples of 16 (the kernel's rule, which ``ssd_scan`` checks), so in
    bf16 or float32 every slice and every token row starts on a 32-byte
    boundary of the activation."""
    ssm = cfg.ssm
    d_inner, n_heads = _dims(cfg)
    gn = ssm.n_groups * ssm.state_dim
    xbc = F.silu(xbc.float()).to(x_dtype)
    xs, b, c = xbc.split([d_inner, gn, gn], dim=-1)
    lead = xbc.shape[:-1]
    xs = xs.reshape(*lead, n_heads, ssm.head_dim)
    b = b.reshape(*lead, ssm.n_groups, ssm.state_dim)
    c = c.reshape(*lead, ssm.n_groups, ssm.state_dim)
    dt = F.softplus(dt_pre.float() + params["dt_bias"])
    return xs, b, c, dt


def _scan(xs, dt, a_log, b, c, d_skip, initial_state, chunk: int):
    """The chunked scan: ``SsdScanFn`` when grad mode is on and an input
    requires grad (training), else ``ssd_scan``."""
    ins = (xs, dt, a_log, b, c, d_skip, initial_state)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in ins):
        return SsdScanFn.apply(*ins, chunk)
    return ssd_scan(*ins, chunk=chunk)


def apply_mamba2_block(cfg: ArchConfig, params, x,
                       initial_state: Optional[torch.Tensor] = None):
    """x: (b, s, d) -> (y, {"ssm": final state (b, H, N, P) float32,
    "conv": the last K-1 raw conv inputs (b, K-1, conv_dim)}).  The
    prefill and the training block: differentiable when grad mode is on
    and an input requires grad."""
    ssm = cfg.ssm
    d_inner, _ = _dims(cfg)
    h = L.apply_norm(cfg, params["ln"], x)
    z, xbc_raw, dt_pre = _split_proj(cfg, h @ params["in_proj"])
    xbc = _causal_depthwise_conv(xbc_raw, params["conv_w"], params["conv_b"])
    xs, b, c, dt = _ssm_inputs(cfg, params, xbc, dt_pre, x.dtype)
    y, ssm_state = _scan(xs, dt.contiguous(), params["a_log"], b, c,
                         params["d_skip"], initial_state, ssm.chunk)
    # conv left context for the decode continuation
    bs, s, _ = x.shape
    kconv = ssm.conv_kernel - 1
    tail = xbc_raw[:, max(s - kconv, 0):]
    if s < kconv:
        pad = torch.zeros((bs, kconv - s, xbc_raw.shape[-1]),
                          dtype=xbc_raw.dtype, device=x.device)
        tail = torch.cat([pad, tail], dim=1)
    out = _gated_out(params, y.reshape(bs, s, d_inner), z, x)
    return out, {"ssm": ssm_state, "conv": tail}


def apply_mamba2_decode(cfg: ArchConfig, params, x, state):
    """x: (b, 1, d); state {"ssm": (b, H, N, P) float32, "conv": (b, K-1,
    conv_dim)}, both updated IN PLACE.  Returns (y, state)."""
    d_inner, _ = _dims(cfg)
    h = L.apply_norm(cfg, params["ln"], x)
    z, xbc, dt_pre = _split_proj(cfg, h @ params["in_proj"])
    conv_prev = state["conv"]
    xbc_conv = _causal_depthwise_conv(xbc, params["conv_w"],
                                      params["conv_b"], prev=conv_prev)
    # shift the window left by one and append this token's raw input
    conv_prev.copy_(torch.cat([conv_prev[:, 1:], xbc.to(conv_prev.dtype)],
                              dim=1))
    xs, b, c, dt = _ssm_inputs(cfg, params, xbc_conv, dt_pre, x.dtype)
    bs = x.shape[0]
    y, _ = ssd_decode_step(state["ssm"], xs[:, 0], dt[:, 0], params["a_log"],
                           b[:, 0], c[:, 0], params["d_skip"])
    out = _gated_out(params, y.reshape(bs, 1, d_inner), z, x)
    return out, state
