"""Plain PyTorch reference of a decoder-only mixture-of-experts LM
(OLMoE-style: RMSNorm, rotary attention, a top-k router over SwiGLU
experts with a per-expert capacity), in float32 by default.

It reads the configuration as the program runs it (the published key
names, each departure's value in place: ``harness.as_run``) and the
weights by name from a flat dict (``blocks.<i>.attn.wq`` and so on, the
layout the benchmark hands the program), and imports nothing of the
program.  Every
matrix product goes through one function, so ``precision="fp8"`` runs the
same model with each product's operands rounded to float8 (e4m3 forward,
e5m2 for the gradients, one scale a tensor): the benchmark's control, the
precision below the bfloat16 the configuration states.

Semantics, as the configuration file states them:

* RMSNorm ``x * rsqrt(mean(x^2) + eps) * scale``;
* rotary embedding on the two halves of each head (``theta``);
* causal softmax attention, scores scaled by ``head_dim ** -0.5``;
* the router's softmax over all experts, the top ``k`` kept and (where
  ``norm_topk_prob``) renormalised; each expert keeps the first
  ``capacity`` of its assignments in order of (token, slot) and drops the
  rest, ``capacity = max(int(capacity_factor * T * k / E + 0.5), k)`` over
  the T tokens of the call; the load-balancing loss
  ``coef * E * sum_e f_e p_e``;
* the mean next-token cross entropy plus the layers' load-balancing losses.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

F32 = torch.float32


# -- precision of the matrix products ----------------------------------

def _fake_quant(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` (a float8 type) under one scale that maps
    its largest magnitude to the type's largest value."""
    top = torch.finfo(dtype).max
    amax = x.detach().abs().amax().clamp_min(1e-30)
    scale = top / amax
    return (x * scale).to(dtype).to(x.dtype) / scale


class _Fp8MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        aq = _fake_quant(a, torch.float8_e4m3fn)
        bq = _fake_quant(b, torch.float8_e4m3fn)
        ctx.save_for_backward(aq, bq)
        return aq @ bq

    @staticmethod
    def backward(ctx, g):
        aq, bq = ctx.saved_tensors
        gq = _fake_quant(g, torch.float8_e5m2)
        return gq @ bq.transpose(-1, -2), aq.transpose(-1, -2) @ gq


def matmul_fn(precision: str):
    if precision == "fp32":
        return torch.matmul
    if precision == "fp8":
        return _Fp8MatMul.apply
    raise ValueError(f"unknown precision {precision!r}")


def router_matmul_fn(precision: str):
    """The router is float32 in the configuration; its control is bf16."""
    if precision == "fp32":
        return torch.matmul
    return lambda a, b: (a.to(torch.bfloat16) @ b.to(torch.bfloat16)).to(F32)


# -- weights ----------------------------------------------------------------

def init_rule(name: str, shape) -> tuple[str, float]:
    """How the benchmark draws leaf ``name``: ("normal", std) or
    ("norm_scale", spread) for 1 + spread * N(0, 1)."""
    last = name.rsplit(".", 1)[-1]
    if last == "scale":
        return "norm_scale", 0.1
    if name == "embed.tokens":
        return "normal", 0.02
    if name == "embed.unembed":
        return "normal", shape[0] ** -0.5
    if last in ("wq", "wk", "wv"):
        return "normal", shape[0] ** -0.5
    if name.endswith("attn.wo"):
        return "normal", (shape[0] * shape[1]) ** -0.5
    if last == "router":
        return "normal", shape[0] ** -0.5
    if last in ("wi_gate", "wi_up"):
        return "normal", shape[1] ** -0.5
    if name.endswith("moe.wo"):
        return "normal", shape[1] ** -0.5
    raise KeyError(f"no init rule for leaf {name}")


def leaf_names(c: dict) -> list[str]:
    """Every weight the model reads, by name."""
    names = ["embed.tokens", "embed.unembed", "final_norm.scale"]
    for i in range(c["num_hidden_layers"]):
        p = f"blocks.{i}."
        names += [p + "ln1.scale", p + "ln2.scale", p + "attn.wq",
                  p + "attn.wk", p + "attn.wv", p + "attn.wo",
                  p + "moe.router", p + "moe.wi_gate", p + "moe.wi_up",
                  p + "moe.wo"]
    return names


# -- the model --------------------------------------------------------------

def rms_norm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * scale


def rope(x, positions, theta):
    """x: (b, s, h, hd); the two halves of hd rotated."""
    hd = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=F32,
                                        device=x.device) / hd))
    ang = positions.to(F32)[:, None] * inv  # (s, hd/2)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(c, W, p, h, mm, kv_out=None):
    """Causal self-attention of one layer; where ``kv_out`` = (positions,
    list) is given, appends this layer's rotated K and V at those
    positions, (b, P, KV heads, head_dim) each."""
    b, s, d = h.shape
    nh, nkv = c["num_attention_heads"], c["num_key_value_heads"]
    hd = c.get("head_dim") or d // nh
    x2 = h.reshape(b * s, d)
    q = mm(x2, W[p + "attn.wq"].reshape(d, nh * hd)).reshape(b, s, nh, hd)
    k = mm(x2, W[p + "attn.wk"].reshape(d, nkv * hd)).reshape(b, s, nkv, hd)
    v = mm(x2, W[p + "attn.wv"].reshape(d, nkv * hd)).reshape(b, s, nkv, hd)
    pos = torch.arange(s, device=h.device)
    q, k = rope(q, pos, c["rope_theta"]), rope(k, pos, c["rope_theta"])
    if kv_out is not None:
        at, out = kv_out
        out.append((k[:, at], v[:, at]))
    if nkv != nh:
        k = k.repeat_interleave(nh // nkv, dim=2)
        v = v.repeat_interleave(nh // nkv, dim=2)
    q, k, v = (t.permute(0, 2, 1, 3) for t in (q, k, v))  # (b, h, s, hd)
    scores = mm(q, k.transpose(-1, -2)) * hd ** -0.5
    mask = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
    scores = scores.masked_fill(~mask, float("-inf"))
    ctx = mm(torch.softmax(scores, dim=-1), v)  # (b, h, s, hd)
    ctx = ctx.permute(0, 2, 1, 3).reshape(b * s, nh * hd)
    return mm(ctx, W[p + "attn.wo"].reshape(nh * hd, d)).reshape(b, s, d)


def moe(c, W, p, h, mm, rmm):
    """Returns (y (b, s, d), load-balancing loss)."""
    b, s, d = h.shape
    t = b * s
    e, k = c["num_experts"], c["num_experts_per_tok"]
    x = h.reshape(t, d)
    probs = torch.softmax(rmm(x, W[p + "moe.router"]), dim=-1)
    top_w, top_e = torch.topk(probs, k, dim=-1)
    if c["norm_topk_prob"]:
        top_w = top_w / top_w.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    flat_e = top_e.reshape(-1)  # (t k,), in order of (token, slot)
    onehot = F.one_hot(flat_e, e)
    frac = onehot.sum(dim=0).to(F32) / (t * k)
    aux = c["router_aux_loss_coef"] * e * torch.sum(frac * probs.mean(dim=0))

    cap = max(int(c["capacity_factor"] * t * k / e + 0.5), k)
    rank = (onehot.cumsum(dim=0) - 1).gather(1, flat_e[:, None])[:, 0]
    keep = rank < cap
    slot = flat_e * cap + rank.clamp(max=cap - 1)
    token = torch.arange(t * k, device=h.device) // k
    slot_token = torch.full((e * cap,), t, dtype=torch.long, device=h.device)
    slot_token[slot[keep]] = token[keep]
    xz = torch.cat([x, x.new_zeros(1, d)])  # an empty slot reads zeros
    xb = xz[slot_token].reshape(e, cap, d)
    gate = mm(xb, W[p + "moe.wi_gate"])
    up = mm(xb, W[p + "moe.wi_up"])
    out = mm(F.silu(gate) * up, W[p + "moe.wo"]).reshape(e * cap, d)
    weight = (top_w.reshape(-1) * keep.to(F32))[:, None]
    y = (out[slot] * weight).reshape(t, k, d).sum(dim=1)
    return y.reshape(b, s, d), aux


def hidden(c, W, tokens, precision="fp32", kv_out=None):
    """The final-normed hidden states (b, s, d) and the summed
    load-balancing loss (``kv_out``: as :func:`attention`'s)."""
    mm, rmm = matmul_fn(precision), router_matmul_fn(precision)
    eps = c["rms_norm_eps"]
    x = W["embed.tokens"][tokens]
    aux = x.new_zeros(())
    for i in range(c["num_hidden_layers"]):
        p = f"blocks.{i}."
        x = x + attention(c, W, p, rms_norm(x, W[p + "ln1.scale"], eps), mm,
                          kv_out)
        y, a = moe(c, W, p, rms_norm(x, W[p + "ln2.scale"], eps), mm, rmm)
        x = x + y
        aux = aux + a
    return rms_norm(x, W["final_norm.scale"], eps), aux


def loss(c, W, tokens, labels, precision="fp32"):
    """Mean next-token cross entropy plus the load-balancing losses."""
    mm = matmul_fn(precision)
    h, aux = hidden(c, W, tokens, precision)
    b, s, d = h.shape
    logits = mm(h.reshape(b * s, d), W["embed.unembed"])
    return F.cross_entropy(logits, labels.reshape(-1)) + aux


def prefill(c, W, tokens, positions, precision="fp32"):
    """Logits (b, V) at the last position of each prompt, and what a
    prefill writes into the cache at ``positions``: every layer's K and V,
    (layers, b, P, KV heads, head_dim) each."""
    mm = matmul_fn(precision)
    kv = []
    h, _ = hidden(c, W, tokens, precision, (positions, kv))
    logits = mm(h[:, -1], W["embed.unembed"])
    return logits, {"k": torch.stack([k for k, _ in kv]),
                    "v": torch.stack([v for _, v in kv])}


__all__ = ["init_rule", "leaf_names", "hidden", "loss", "prefill",
           "matmul_fn"]
