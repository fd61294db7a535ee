"""Model primitives of the port: functions on tensors, parameters in dicts.

The names, parameter layouts and numerics follow ``repro.models.layers``:
parameters and activations are bfloat16 (:data:`DTYPE`), norms, RoPE and
the softmax run in float32, and each projection keeps the reference's
einsum layout (wq (d, H, hd), wk and wv (d, KV, hd), wo (H, hd, d)).  A
projection is a plain ``torch.matmul`` on the flattened weight.  The
functional head padding of the reference is not ported: one card holds
every head.

``*_specs`` give each parameter's placement on a production mesh under a
``ShardingPolicy``: a tuple with one entry per tensor dim, each ``None``,
an axis name or a tuple of axis names (a ``PartitionSpec``'s contents),
in the parameter tree's layout.  The port's models do not read them on
one card; ``launch.specs`` and ``launch.dryrun`` do.

``init_*`` draw from an explicit ``torch.Generator`` with the reference's
shapes and scales (normal * fan_in^-0.5, embeddings * 0.02, biases zero,
norm scales one).  The numbers differ from the reference's JAX keys; a test
that compares the two converts the reference's parameters
(:func:`repro_torch.convert.params_from_reference`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig, ShardingPolicy

__all__ = [
    "DTYPE",
    "init_norm",
    "norm_specs",
    "apply_norm",
    "rope_freqs",
    "apply_rope",
    "rope_tables",
    "rotate",
    "init_attention",
    "attention_specs",
    "qkv_project",
    "attn_out",
    "init_mlp",
    "mlp_specs",
    "apply_mlp",
    "init_embedding",
    "embedding_specs",
    "embed_tokens",
    "unembed",
    "softmax_xent",
]

DTYPE = torch.bfloat16


def _normal(gen: torch.Generator, shape, scale: float,
            device: torch.device) -> torch.Tensor:
    if torch.device(device).type == "meta":  # shapes only (dry-run counts)
        return torch.empty(shape, dtype=DTYPE, device=device)
    return (torch.randn(shape, generator=gen, device=device) * scale).to(DTYPE)


def _dp(policy: ShardingPolicy):
    """The axes parameters are FSDP-placed over, or None."""
    return policy.dp_axes if policy.fsdp else None


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_norm(cfg: ArchConfig, device, d: Optional[int] = None):
    d = d or cfg.d_model
    p = {"scale": torch.ones((d,), dtype=DTYPE, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=DTYPE, device=device)
    return p


def norm_specs(cfg: ArchConfig):
    p = {"scale": (None,)}
    if cfg.norm == "layernorm":
        p["bias"] = (None,)
    return p


def apply_norm(cfg: ArchConfig, params, x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "rmsnorm":
        var = (xf * xf).mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + 1e-6)
        return (y * params["scale"].float()).to(x.dtype)
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mean) * torch.rsqrt(var + 1e-5)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embedding
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (exps / head_dim))


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """(cos, sin) of the rotary angles, each (..., seq, 1, head_dim / 2) in
    float32.  A forward pass computes them once and every layer reuses
    them (the reference recomputes them per layer; the values are the
    same)."""
    freqs = rope_freqs(head_dim, theta, positions.device)  # (hd/2,)
    angles = positions[..., :, None].float() * freqs  # (..., s, hd/2)
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def rotate(x: torch.Tensor, rope) -> torch.Tensor:
    """x: (..., seq, heads, head_dim) rotated by ``rope`` = (cos, sin)."""
    cos, sin = rope
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    return rotate(x, rope_tables(positions, x.shape[-1], theta))


# ---------------------------------------------------------------------------
# attention projections
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ArchConfig, device,
                   d_model: Optional[int] = None):
    d = d_model or cfg.d_model
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    scale = d ** -0.5
    p = {
        "wq": _normal(gen, (d, h, hd), scale, device),
        "wk": _normal(gen, (d, kv, hd), scale, device),
        "wv": _normal(gen, (d, kv, hd), scale, device),
        "wo": _normal(gen, (h, hd, d), scale, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h, hd), dtype=DTYPE, device=device)
        p["bk"] = torch.zeros((kv, hd), dtype=DTYPE, device=device)
        p["bv"] = torch.zeros((kv, hd), dtype=DTYPE, device=device)
    if cfg.attn_out_bias:
        p["bo"] = torch.zeros((d,), dtype=DTYPE, device=device)
    return p


def attention_specs(cfg: ArchConfig, policy: ShardingPolicy):
    m = policy.model_axis
    dp = _dp(policy)
    if policy.attn_mode == "heads":
        # padded-head mode: the parameters' head count does not divide the
        # axis, so the weights stay whole on heads (the padded activation
        # is placed)
        h_ax = None if policy.attn_pad_heads else m
        kv_ax = m if policy.shard_kv_heads else None
        q_spec, kv_spec, o_spec = (dp, h_ax, None), (dp, kv_ax, None), (
            h_ax, None, dp)
        bq, bkv = (h_ax, None), (kv_ax, None)
    else:  # head_dim placement (e.g. qwen2-0.5b: 14 heads, 16-way axis)
        q_spec = kv_spec = (dp, None, m)
        o_spec = (None, m, dp)
        bq = bkv = (None, m)
    p = {"wq": q_spec, "wk": kv_spec, "wv": kv_spec, "wo": o_spec}
    if cfg.qkv_bias:
        p["bq"], p["bk"], p["bv"] = bq, bkv, bkv
    if cfg.attn_out_bias:
        p["bo"] = (None,)
    return p


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('bsd,dhk->bshk') as one matmul on the flattened weight."""
    d, heads, hd = w.shape
    return (x @ w.reshape(d, heads * hd)).unflatten(-1, (heads, hd))


def qkv_project(cfg: ArchConfig, params, x, rope=None):
    """x: (b, s, d) -> q (b, s, H, hd), k and v (b, s, KV, hd), rotated by
    ``rope`` = :func:`rope_tables` of the positions (the reference takes
    the positions and builds the tables itself)."""
    q = _project(x, params["wq"])
    k = _project(x, params["wk"])
    v = _project(x, params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    if cfg.use_rope and rope is not None:
        q = rotate(q, rope)
        k = rotate(k, rope)
    return q, k, v


def attn_out(cfg: ArchConfig, params, ctx: torch.Tensor) -> torch.Tensor:
    """einsum('bshk,hkd->bsd', ctx, wo) (+ bo)."""
    h, hd, d = params["wo"].shape
    y = ctx.reshape(*ctx.shape[:-2], h * hd) @ params["wo"].reshape(h * hd, d)
    if cfg.attn_out_bias:
        y = y + params["bo"]
    return y


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, cfg: ArchConfig, device,
             d_ff: Optional[int] = None, d_model: Optional[int] = None):
    d = d_model or cfg.d_model
    f = d_ff or cfg.d_ff
    scale_in, scale_out = d ** -0.5, f ** -0.5
    if cfg.activation == "swiglu":
        p = {
            "wi_gate": _normal(gen, (d, f), scale_in, device),
            "wi_up": _normal(gen, (d, f), scale_in, device),
            "wo": _normal(gen, (f, d), scale_out, device),
        }
    else:  # gelu
        p = {
            "wi_up": _normal(gen, (d, f), scale_in, device),
            "wo": _normal(gen, (f, d), scale_out, device),
        }
    if cfg.mlp_bias:
        p["bi"] = torch.zeros((f,), dtype=DTYPE, device=device)
        p["bo"] = torch.zeros((d,), dtype=DTYPE, device=device)
    return p


def mlp_specs(cfg: ArchConfig, policy: ShardingPolicy):
    m = policy.model_axis
    dp = _dp(policy)
    if cfg.activation == "swiglu":
        p = {"wi_gate": (dp, m), "wi_up": (dp, m), "wo": (m, dp)}
    else:
        p = {"wi_up": (dp, m), "wo": (m, dp)}
    if cfg.mlp_bias:
        p["bi"] = (m,)
        p["bo"] = (None,)
    return p


def apply_mlp(cfg: ArchConfig, params, x: torch.Tensor) -> torch.Tensor:
    if cfg.activation == "swiglu":
        g = x @ params["wi_gate"]
        u = x @ params["wi_up"]
        h = F.silu(g.float()).to(x.dtype) * u
    else:
        u = x @ params["wi_up"]
        if cfg.mlp_bias:
            u = u + params["bi"]
        h = F.gelu(u.float(), approximate="tanh").to(x.dtype)
    y = h @ params["wo"]
    if cfg.mlp_bias:
        y = y + params["bo"]
    return y


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------

def init_embedding(gen: torch.Generator, cfg: ArchConfig, device):
    p = {"tokens": _normal(gen, (cfg.vocab_size, cfg.d_model), 0.02, device)}
    if not cfg.tie_embeddings:
        p["unembed"] = _normal(gen, (cfg.d_model, cfg.vocab_size),
                               cfg.d_model ** -0.5, device)
    return p


def embedding_specs(cfg: ArchConfig, policy: ShardingPolicy):
    m = policy.model_axis if policy.shard_vocab else None
    dp = _dp(policy)
    p = {"tokens": (m, dp)}
    if not cfg.tie_embeddings:
        p["unembed"] = (dp, m)
    return p


def embed_tokens(params, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens, params["tokens"])


def unembed(cfg: ArchConfig, params, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = x @ params["tokens"].T
    else:
        logits = x @ params["unembed"]
    if cfg.logit_softcap > 0:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross entropy in float32; labels already shifted.
    ``mask`` (same shape as ``labels``) weights the positions."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
