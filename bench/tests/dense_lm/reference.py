"""A second family for the test that adds a cell from files alone: the
plain float32 reference of a dense decoder-only LM (llama-style: RMSNorm,
rotary attention with grouped K/V heads, a SwiGLU MLP).  The test copies
it to ``reference/dense_lm.py``; it imports nothing of the program."""

from __future__ import annotations

import torch
import torch.nn.functional as F

F32 = torch.float32


def init_rule(name: str, shape) -> tuple[str, float]:
    if name.endswith(".scale"):
        return "norm_scale", 0.1
    if name == "embed.tokens":
        return "normal", 0.02
    if name.endswith("attn.wo"):
        return "normal", (shape[0] * shape[1]) ** -0.5
    return "normal", shape[0] ** -0.5  # fan-in first: wq, wk, wv, the MLP


def leaf_names(c: dict) -> list[str]:
    names = ["embed.tokens", "embed.unembed", "final_norm.scale"]
    for i in range(c["num_hidden_layers"]):
        p = f"blocks.{i}."
        names += [p + n for n in ("ln1.scale", "ln2.scale", "attn.wq",
                                  "attn.wk", "attn.wv", "attn.wo",
                                  "mlp.wi_gate", "mlp.wi_up", "mlp.wo")]
    return names


def _norm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * scale


def _rope(x, theta):
    hd, s = x.shape[-1], x.shape[1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=F32) / hd)
    ang = torch.arange(s, dtype=F32)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(c, W, p, h, kv_out):
    b, s, d = h.shape
    nh, nkv = c["num_attention_heads"], c["num_key_value_heads"]
    hd = d // nh
    q = (h @ W[p + "wq"].reshape(d, -1)).reshape(b, s, nh, hd)
    k = (h @ W[p + "wk"].reshape(d, -1)).reshape(b, s, nkv, hd)
    v = (h @ W[p + "wv"].reshape(d, -1)).reshape(b, s, nkv, hd)
    q, k = _rope(q, c["rope_theta"]), _rope(k, c["rope_theta"])
    if kv_out is not None:
        kv_out[1].append((k[:, kv_out[0]], v[:, kv_out[0]]))
    k, v = (t.repeat_interleave(nh // nkv, dim=2) for t in (k, v))
    q, k, v = (t.permute(0, 2, 1, 3) for t in (q, k, v))
    mask = torch.ones(s, s, dtype=torch.bool).tril()
    scores = (q @ k.transpose(-1, -2) * hd ** -0.5).masked_fill(~mask,
                                                                 -torch.inf)
    ctx = (torch.softmax(scores, dim=-1) @ v).permute(0, 2, 1, 3)
    return ctx.reshape(b, s, nh * hd) @ W[p + "wo"].reshape(nh * hd, d)


def _hidden(c, W, tokens, kv_out=None):
    eps = c["rms_norm_eps"]
    x = W["embed.tokens"][tokens]
    for i in range(c["num_hidden_layers"]):
        p = f"blocks.{i}."
        x = x + _attention(c, W, p + "attn.",
                           _norm(x, W[p + "ln1.scale"], eps), kv_out)
        h = _norm(x, W[p + "ln2.scale"], eps)
        x = x + (F.silu(h @ W[p + "mlp.wi_gate"]) * (h @ W[p + "mlp.wi_up"])
                 ) @ W[p + "mlp.wo"]
    return _norm(x, W["final_norm.scale"], eps)


def loss(c, W, tokens, labels, precision="fp32"):
    h = _hidden(c, W, tokens)
    logits = h @ W["embed.unembed"]
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1))


def prefill(c, W, tokens, positions, precision="fp32"):
    kv = []
    h = _hidden(c, W, tokens, (positions, kv))
    return h[:, -1] @ W["embed.unembed"], {
        "k": torch.stack([k for k, _ in kv]),
        "v": torch.stack([v for _, v in kv])}
