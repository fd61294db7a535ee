"""xLSTM blocks of the port (xlstm-350m): mLSTM (matrix memory, exponential
gating) and sLSTM (scalar memory with recurrent mixing).

Follows ``repro.models.xlstm``.  mLSTM per head (dk key dim, dv value
dim), stabilised:

    m_t = max(logsig(f~_t) + m_{t-1}, i~_t)
    C_t = e^{logsig(f~)+m_{t-1}-m_t} C_{t-1} + e^{i~_t - m_t} k_t v_t^T
    n_t = e^{logsig(f~)+m_{t-1}-m_t} n_{t-1} + e^{i~_t - m_t} k_t
    h_t = (q_t·C_t) / max(|q_t·n_t|, e^{-m_t})

Prefill runs the chunkwise-parallel form (:func:`mlstm_chunked`, carrying
(C, n, m) across chunks); decode the O(1) recurrence
(:func:`mlstm_decode_step`); :func:`mlstm_sequential` is the oracle.  The
sLSTM keeps the paper's recurrent memory mixing (R h_{t-1} into the gate
preactivations), one step at a time (the reference's ``lax.scan``).

No hand kernel runs here: the reference computes both with XLA ops and no
``pallas_call`` computes them (its Pallas SSD scan is Mamba-2's, another
recurrence), so the port's are tensor ops, float32 inside, as the
reference's.  The functions return new tensors; ``lm`` writes them into
the decode state.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from . import layers as L
from .ssm import _causal_depthwise_conv

__all__ = [
    "mlstm_sequential",
    "mlstm_chunked",
    "mlstm_decode_step",
    "mlstm_state_shape",
    "init_mlstm_block",
    "apply_mlstm_block",
    "apply_mlstm_decode",
    "slstm_state_shape",
    "init_slstm_block",
    "apply_slstm_block",
    "apply_slstm_decode",
]

NEG = -1e30


def _initial(bq, h, dk, dv, device, initial):
    if initial is not None:
        return initial
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.zeros((bq, h, dk, dv), **f32),
            torch.zeros((bq, h, dk), **f32),
            torch.full((bq, h), NEG, **f32))


def mlstm_sequential(q, k, v, i_pre, f_pre, initial=None):
    """Oracle.  q, k: (B, S, H, DK); v: (B, S, H, DV); i_pre, f_pre:
    (B, S, H).  Returns (h (B, S, H, DV) float32, (C, n, m))."""
    bq, s, h, dk = q.shape
    qf = q.float() * dk ** -0.5
    kf, vf = k.float(), v.float()
    lf = F.logsigmoid(f_pre.float())
    li = i_pre.float()
    c, n, m = _initial(bq, h, dk, v.shape[-1], q.device, initial)
    hs = []
    for t in range(s):
        m_new = torch.maximum(lf[:, t] + m, li[:, t])
        fw = torch.exp(lf[:, t] + m - m_new)
        iw = torch.exp(li[:, t] - m_new)
        c = c * fw[..., None, None] + iw[..., None, None] * (
            kf[:, t][..., :, None] * vf[:, t][..., None, :])
        n = n * fw[..., None] + iw[..., None] * kf[:, t]
        num = torch.einsum("bhk,bhkv->bhv", qf[:, t], c)
        den = torch.einsum("bhk,bhk->bh", qf[:, t], n).abs()
        den = torch.maximum(den, torch.exp(-m_new))
        m = m_new
        hs.append(num / den[..., None])
    return torch.stack(hs, dim=1), (c, n, m)


def mlstm_chunked(q, k, v, i_pre, f_pre, chunk: int, initial=None):
    """Chunkwise-parallel stabilised mLSTM.  Same shapes and returns as
    :func:`mlstm_sequential`; raises unless ``chunk`` divides the
    sequence."""
    bq, s, h, dk = q.shape
    dv = v.shape[-1]
    if s % chunk:
        raise ValueError(f"seq {s} % chunk {chunk} != 0")
    nc = s // chunk
    qf = (q.float() * dk ** -0.5).reshape(bq, nc, chunk, h, dk)
    kf = k.float().reshape(bq, nc, chunk, h, dk)
    vf = v.float().reshape(bq, nc, chunk, h, dv)
    lf = F.logsigmoid(f_pre.float()).reshape(bq, nc, chunk, h)
    li = i_pre.float().reshape(bq, nc, chunk, h)

    bcum = torch.cumsum(lf, dim=2)  # inclusive within-chunk decay sums
    btot = bcum[:, :, -1]  # (B, nc, H)
    # intra log-weights D[t, s] = b_t - b_s + li_s (s <= t), (B, nc, H, t, s)
    dmat = (bcum[..., :, None, :] - bcum[..., None, :, :]
            + li[..., None, :, :]).permute(0, 1, 4, 2, 3)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=q.device))
    dmat = torch.where(mask, dmat, NEG)
    m_intra = dmat.amax(dim=-1)  # (B, nc, H, t)
    qk = torch.einsum("bkthd,bkshd->bkhts", qf, kf)
    # chunk-state ingredients: sum_s exp(btot - b_s + li_s - m_new) k v^T
    st_logw = btot[:, :, None] - bcum + li  # (B, nc, cl, H)
    st_max = st_logw.amax(dim=2)  # (B, nc, H)

    c, n, m = _initial(bq, h, dk, dv, q.device, initial)
    outs = []
    for j in range(nc):
        q_c = qf[:, j].transpose(1, 2)  # (B, H, t, dk)
        k_c = kf[:, j].transpose(1, 2)
        v_c = vf[:, j].transpose(1, 2)
        d_c, lf_tot = dmat[:, j], btot[:, j]
        m_inter = bcum[:, j].transpose(1, 2) + m[:, :, None]  # (B, H, t)
        m_t = torch.maximum(m_inter, m_intra[:, j])
        w_intra = torch.exp(d_c - m_t[..., None])  # (B, H, t, s)
        num = torch.einsum("bhts,bhsv->bhtv", qk[:, j] * w_intra, v_c)
        den = torch.einsum("bhts,bhsk->bhtk", w_intra, k_c)
        den = torch.einsum("bhtk,bhtk->bht", q_c, den)
        w_inter = torch.exp(m_inter - m_t)
        num = num + w_inter[..., None] * torch.einsum("bhtk,bhkv->bhtv",
                                                      q_c, c)
        den = den + w_inter * torch.einsum("bhtk,bhk->bht", q_c, n)
        den = torch.maximum(den.abs(), torch.exp(-m_t))
        outs.append(num / den[..., None])  # (B, H, t, DV)
        # carry update
        m_new = torch.maximum(lf_tot + m, st_max[:, j])
        wdec = torch.exp(lf_tot + m - m_new)
        w_in = torch.exp(st_logw[:, j] - m_new[:, None, :])  # (B, cl, H)
        c = c * wdec[..., None, None] + torch.einsum(
            "bsh,bshk,bshv->bhkv", w_in, k_c.transpose(1, 2),
            v_c.transpose(1, 2))
        n = n * wdec[..., None] + torch.einsum(
            "bsh,bshk->bhk", w_in, k_c.transpose(1, 2))
        m = m_new
    hs = torch.stack(outs, dim=1).permute(0, 1, 3, 2, 4).reshape(bq, s, h, dv)
    return hs, (c, n, m)


def mlstm_decode_step(state, q, k, v, i_pre, f_pre):
    """One token.  q, k: (B, H, DK); v: (B, H, DV); gates (B, H); state
    (C, n, m).  Returns (h (B, H, DV) float32, (C, n, m))."""
    c, n, m = state
    qf = q.float() * q.shape[-1] ** -0.5
    lf = F.logsigmoid(f_pre.float())
    li = i_pre.float()
    m_new = torch.maximum(lf + m, li)
    fw = torch.exp(lf + m - m_new)
    iw = torch.exp(li - m_new)
    kf = k.float()
    c = c * fw[..., None, None] + iw[..., None, None] * (
        kf[..., :, None] * v.float()[..., None, :])
    n = n * fw[..., None] + iw[..., None] * kf
    num = torch.einsum("bhk,bhkv->bhv", qf, c)
    den = torch.maximum(torch.einsum("bhk,bhk->bh", qf, n).abs(),
                        torch.exp(-m_new))
    return num / den[..., None], (c, n, m_new)


# ---------------------------------------------------------------------------
# mLSTM block
# ---------------------------------------------------------------------------

def _mdims(cfg: ArchConfig):
    """(d_inner, heads, dk, dv) of an mLSTM block."""
    d_inner = cfg.ssm.expansion * cfg.d_model
    h = cfg.n_heads
    return d_inner, h, cfg.ssm.state_dim, d_inner // h


def mlstm_state_shape(cfg: ArchConfig, batch: int):
    d_inner, h, dk, dv = _mdims(cfg)
    return {
        "c": (batch, h, dk, dv),
        "n": (batch, h, dk),
        "m": (batch, h),
        "conv": (batch, cfg.ssm.conv_kernel - 1, d_inner),
    }


def init_mlstm_block(gen: torch.Generator, cfg: ArchConfig, device):
    """The reference's shapes and scales, drawn from ``gen`` in the order
    w_up, w_z, conv_w, w_q, w_k, w_v, w_if (float32), w_out."""
    d = cfg.d_model
    d_inner, h, dk, dv = _mdims(cfg)
    s_in, s_inner = d ** -0.5, d_inner ** -0.5
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "ln": L.init_norm(cfg, device),
        "w_up": L._normal(gen, (d, d_inner), s_in, device),
        "w_z": L._normal(gen, (d, d_inner), s_in, device),
        "conv_w": L._normal(gen, (cfg.ssm.conv_kernel, d_inner), 0.1, device),
        "conv_b": torch.zeros((d_inner,), dtype=L.DTYPE, device=device),
        "w_q": L._normal(gen, (d_inner, h, dk), s_inner, device),
        "w_k": L._normal(gen, (d_inner, h, dk), s_inner, device),
        "w_v": L._normal(gen, (d_inner, h, dv), s_inner, device),
        "w_if": torch.randn((d_inner, h, 2), generator=gen, **f32) * s_inner,
        # forget-gate bias +3 (the standard LSTM trick)
        "b_if": torch.tensor([0.0, 3.0], **f32).repeat(h, 1),
        "head_ln": {"scale": torch.ones((h, dv), dtype=L.DTYPE,
                                        device=device)},
        "w_out": L._normal(gen, (d_inner, d), s_inner, device),
    }


def _head_rmsnorm(x, scale):
    """Per-head RMSNorm over the value dim.  x: (..., H, DV)."""
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + 1e-6)
    return (y * scale.float()).to(x.dtype)


def _mlstm_proj(cfg: ArchConfig, params, x, conv_prev=None):
    h_in = L.apply_norm(cfg, params["ln"], x)
    up = h_in @ params["w_up"]
    z = h_in @ params["w_z"]
    conv = _causal_depthwise_conv(up, params["conv_w"], params["conv_b"],
                                  conv_prev)
    conv = F.silu(conv.float()).to(x.dtype)
    q = L._project(conv, params["w_q"])
    k = L._project(conv, params["w_k"])
    v = L._project(up, params["w_v"])
    gates = L._project(up.float(), params["w_if"]) + params["b_if"]
    return up, z, q, k, v, gates[..., 0], gates[..., 1]


def _mlstm_out(params, x, hs, z):
    """The per-head norm of h, its gate by silu(z), the output projection
    and the residual."""
    bq, s = x.shape[:2]
    hs = _head_rmsnorm(hs, params["head_ln"]["scale"]).to(x.dtype)
    out = hs.reshape(bq, s, -1) * F.silu(z.float()).to(x.dtype)
    return x + out @ params["w_out"]


def apply_mlstm_block(cfg: ArchConfig, params, x, initial=None):
    """x: (b, s, d) -> (y, state {"c", "n", "m", "conv"}).  The chunk is
    the config's, or s when it does not divide s (the reference's rule)."""
    d_inner = _mdims(cfg)[0]
    bq, s, _ = x.shape
    up, z, q, k, v, i_pre, f_pre = _mlstm_proj(cfg, params, x)
    chunk = min(cfg.ssm.chunk, s)
    if s % chunk:
        chunk = s
    hs, (c, n, m) = mlstm_chunked(q, k, v, i_pre, f_pre, chunk, initial)
    # conv left-context for a decode continuation
    kconv = cfg.ssm.conv_kernel - 1
    pad = torch.zeros((bq, max(kconv - s, 0), d_inner), dtype=up.dtype,
                      device=up.device)
    conv_tail = torch.cat([pad, up[:, max(s - kconv, 0):]], dim=1)
    return (_mlstm_out(params, x, hs, z),
            {"c": c, "n": n, "m": m, "conv": conv_tail})


def apply_mlstm_decode(cfg: ArchConfig, params, x, state):
    """x: (b, 1, d); state as :func:`mlstm_state_shape`.  Returns (y, new
    state)."""
    conv_prev = state["conv"]
    up, z, q, k, v, i_pre, f_pre = _mlstm_proj(cfg, params, x, conv_prev)
    new_conv = torch.cat([conv_prev[:, 1:], up], dim=1)
    hs, (c, n, m) = mlstm_decode_step(
        (state["c"], state["n"], state["m"]),
        q[:, 0], k[:, 0], v[:, 0], i_pre[:, 0], f_pre[:, 0])
    return (_mlstm_out(params, x, hs[:, None], z),
            {"c": c, "n": n, "m": m, "conv": new_conv})


# ---------------------------------------------------------------------------
# sLSTM block (sequential; recurrent memory mixing)
# ---------------------------------------------------------------------------

def slstm_state_shape(cfg: ArchConfig, batch: int):
    h = cfg.n_heads
    shape = (batch, h, cfg.d_model // h)
    return {"c": shape, "n": shape, "m": shape, "h": shape}


def init_slstm_block(gen: torch.Generator, cfg: ArchConfig, device):
    """The reference's shapes and scales, drawn from ``gen`` in the order
    w_in (float32), r (float32), w_out."""
    d, h = cfg.d_model, cfg.n_heads
    dh = d // h
    f32 = dict(dtype=torch.float32, device=device)
    b = torch.zeros((4, h, dh), **f32)
    b[2] = 3.0  # forget bias
    return {
        "ln": L.init_norm(cfg, device),
        # input projections for (z, i, f, o)
        "w_in": torch.randn((d, 4, h, dh), generator=gen, **f32) * d ** -0.5,
        # recurrent block-diagonal mixing per head for (z, i, f, o)
        "r": torch.randn((4, h, dh, dh), generator=gen, **f32) * dh ** -0.5,
        "b": b,
        "head_ln": {"scale": torch.ones((h, dh), dtype=L.DTYPE,
                                        device=device)},
        "w_out": L._normal(gen, (d, d), d ** -0.5, device),
    }


def _slstm_cell(params, carry, pre_t):
    """One sLSTM step.  pre_t: (B, 4, H, DH) input preactivations; carry
    (c, n, m, h).  Returns the new carry."""
    c, n, m, h_prev = carry
    rec = torch.einsum("bhd,ghde->bghe", h_prev, params["r"])
    pre = pre_t + rec + params["b"][None]
    z = torch.tanh(pre[:, 0])
    li = pre[:, 1]  # log input gate (exponential gating)
    lf = F.logsigmoid(pre[:, 2])
    o = torch.sigmoid(pre[:, 3])
    m_new = torch.maximum(lf + m, li)
    iw = torch.exp(li - m_new)
    fw = torch.exp(lf + m - m_new)
    c_new = fw * c + iw * z
    n_new = torch.maximum(fw * n + iw, torch.exp(-m_new))
    return c_new, n_new, m_new, o * c_new / n_new


def apply_slstm_block(cfg: ArchConfig, params, x, initial=None):
    """x: (b, s, d) -> (y, state {"c", "n", "m", "h"}), one step at a
    time."""
    bq, s, d = x.shape
    h = cfg.n_heads
    xin = L.apply_norm(cfg, params["ln"], x)
    w_in = params["w_in"]
    pre = (xin.float() @ w_in.reshape(d, -1)).unflatten(-1, w_in.shape[1:])
    if initial is None:
        zeros = torch.zeros((bq, h, d // h), dtype=torch.float32,
                            device=x.device)
        carry = (zeros, zeros + 1.0, zeros, zeros)
    else:
        carry = (initial["c"], initial["n"], initial["m"], initial["h"])
    hs = []
    for t in range(s):
        carry = _slstm_cell(params, carry, pre[:, t])
        hs.append(carry[3])
    hs = _head_rmsnorm(torch.stack(hs, dim=1), params["head_ln"]["scale"])
    out = hs.reshape(bq, s, d).to(x.dtype) @ params["w_out"]
    c, n, m, hl = carry
    return x + out, {"c": c, "n": n, "m": m, "h": hl}


def apply_slstm_decode(cfg: ArchConfig, params, x, state):
    return apply_slstm_block(cfg, params, x, initial=state)
