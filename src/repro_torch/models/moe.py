"""Mixture-of-Experts FFN of the port (olmoe-1b-7b, deepseek-moe-16b).

Follows ``repro.models.moe``: sort-based capacity dispatch (MegaBlocks /
MaxText style), never the (T, E, C) one-hot of GShard:

  1. top-k routing over the (T, E) float32 gate probabilities, the top-k
     weights renormalised;
  2. the flat (T * k,) assignments stably sorted by expert id;
  3. each assignment's rank within its expert by ``searchsorted``; the
     assignments ranked >= the per-expert capacity C are DROPPED (the
     residual carries their token);
  4. the kept tokens gathered into an (E, C, d) buffer, the per-expert
     SwiGLU as one batched product over experts, and each token's k
     weighted outputs gathered back and summed in float32.

Shared experts (DeepSeekMoE) are a plain dense SwiGLU on every token.  The
router adds the Switch-style load-balancing loss E * sum_e f_e p_e.

One deliberate difference from the reference: an assignment past capacity
writes nothing.  The reference sends each of them to slot ``expert * C +
0`` with value 0 by a scatter on duplicate indices, and where the scatter
applies its updates in order (XLA's CPU backend) that zero overwrites the
expert's legitimate rank-0 token: every overflowing expert loses one token
more than the capacity rule allows, and the wrong one (ROADMAP C).  Here a
dropped assignment goes to one spare slot past the buffer, which is then
cut off, so no kept slot is written twice and the result does not depend
on scatter order.

The dispatch has static shapes and no host sync (no ``.item()``, no
``nonzero``): the capacity comes from the token count, a host int.  The
reference adds the expert outputs back by a scatter-add; on CUDA
``index_add_`` adds in atomic order, so two runs of one prompt could
differ in the last bit and then in a greedy token.  The port gathers each
token's k outputs and sums them in a fixed order instead: the same sum,
associated per token rather than in slot order (float32, so the two agree
within rounding), and the same on every run.  The reference computes the
expert FFN with XLA einsums, outside any Pallas kernel, so the port's is
``torch.matmul``.

A MoE layer (:func:`apply_moe_block`, :func:`apply_moe_block_decode`) is
the dense block's attention half, on the hand-written attention kernels
(``transformer.prefill_attend`` / ``decode_attend``), then the MoE FFN.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig, MoEConfig
from . import layers as L
from . import transformer as T

__all__ = ["router_capacity", "init_moe", "apply_moe", "init_moe_block",
           "apply_moe_block", "apply_moe_block_decode"]


def router_capacity(moe: MoEConfig, n_tokens: int) -> int:
    """Per-expert capacity for a token block of size n_tokens."""
    ideal = n_tokens * moe.top_k / moe.n_experts
    cap = int(moe.capacity_factor * ideal + 0.5)
    return max(cap, moe.top_k)


def init_moe(gen: torch.Generator, cfg: ArchConfig, device):
    """The reference's shapes and scales, drawn from ``gen`` in the order
    router (float32), wi_gate, wi_up, wo, then the shared experts."""
    moe = cfg.moe
    d, f, e = cfg.d_model, moe.d_expert, moe.n_experts
    scale_in, scale_out = d ** -0.5, f ** -0.5
    p = {
        "router": torch.randn((d, e), generator=gen, device=device) * scale_in,
        "wi_gate": L._normal(gen, (e, d, f), scale_in, device),
        "wi_up": L._normal(gen, (e, d, f), scale_in, device),
        "wo": L._normal(gen, (e, f, d), scale_out, device),
    }
    if moe.n_shared > 0:
        p["shared"] = L.init_mlp(gen, cfg, device,
                                 d_ff=moe.n_shared * moe.d_expert)
    return p


def _expert_ffn(params, xb: torch.Tensor) -> torch.Tensor:
    """xb: (E, C, d) -> (E, C, d); the SwiGLU batched over experts."""
    g = torch.matmul(xb, params["wi_gate"])
    u = torch.matmul(xb, params["wi_up"])
    h = F.silu(g.float()).to(xb.dtype) * u
    return torch.matmul(h, params["wo"])


def route(moe: MoEConfig, router: torch.Tensor, xt: torch.Tensor):
    """(probs (T, E), gate weights (T, k) renormalised, gate experts (T, k))
    of the float32 router."""
    probs = torch.softmax(xt.float() @ router.float(), dim=-1)
    gate_w, gate_e = torch.topk(probs, moe.top_k, dim=-1)
    gate_w = gate_w / gate_w.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return probs, gate_w, gate_e


def dispatch(moe: MoEConfig, gate_e: torch.Tensor, cap: int):
    """Sort the flat (T * k) assignments by expert, stably.  Returns
    (sorted expert ids, token of each, its flat index, rank within its
    expert, whether the rank is below ``cap``)."""
    tk = gate_e.numel()
    k = gate_e.shape[-1]
    flat_e = gate_e.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    st = torch.div(order, k, rounding_mode="floor")  # token of each entry
    rank = (torch.arange(tk, device=se.device)
            - torch.searchsorted(se, se, side="left"))
    return se, st, order, rank, rank < cap


def apply_moe(cfg: ArchConfig, params, x: torch.Tensor,
              capacity: Optional[int] = None):
    """x: (b, s, d) -> (y (b, s, d) in x's dtype, aux loss float32 0-dim).

    ``capacity`` overrides :func:`router_capacity` of the b * s tokens."""
    moe = cfg.moe
    b, s, d = x.shape
    t = b * s
    e, k = moe.n_experts, moe.top_k
    cap = capacity if capacity is not None else router_capacity(moe, t)
    xt = x.reshape(t, d)
    probs, gate_w, gate_e = route(moe, params["router"], xt)

    # load-balancing aux loss (Switch): E * sum_e f_e p_e
    me = probs.mean(dim=0)
    counts = torch.zeros((e,), dtype=torch.float32, device=x.device)
    counts.index_add_(0, gate_e.reshape(-1),
                      torch.ones((t * k,), dtype=torch.float32,
                                 device=x.device))
    aux = moe.aux_loss_weight * e * torch.sum(counts / (t * k) * me)

    se, st, order, rank, valid = dispatch(moe, gate_e, cap)
    # kept entries to their slot, dropped ones to the spare slot e * cap
    slot = torch.where(valid, se * cap + rank, e * cap)
    slot_tok = torch.zeros((e * cap + 1,), dtype=torch.long, device=x.device)
    slot_tok[slot] = st
    # gather into (E, C, d) (an empty slot computes on token 0, and no
    # assignment reads it back)
    yb = _expert_ffn(params, xt[slot_tok[: e * cap]].reshape(e, cap, d))
    # combine by a gather: each (token, j) reads its slot's output, and a
    # token's k weighted outputs are summed in float32 in a fixed order
    flat_slot = torch.empty_like(slot)
    flat_slot[order] = slot
    keep = (flat_slot < e * cap).reshape(t, k)
    got = yb.reshape(e * cap, d)[flat_slot.clamp(max=e * cap - 1)]
    y = (got.float().reshape(t, k, d)
         * (gate_w * keep)[..., None]).sum(dim=1)
    y = y.to(x.dtype).reshape(b, s, d)
    if moe.n_shared > 0:
        y = y + L.apply_mlp(cfg, params["shared"], x)
    return y, aux


def init_moe_block(gen: torch.Generator, cfg: ArchConfig, device):
    """{ln1, attn, ln2, moe}: the dense block's attention half and the MoE
    FFN."""
    return {
        "ln1": L.init_norm(cfg, device),
        "attn": L.init_attention(gen, cfg, device),
        "ln2": L.init_norm(cfg, device),
        "moe": init_moe(gen, cfg, device),
    }


def _ffn(cfg: ArchConfig, params, x):
    h2 = L.apply_norm(cfg, params["ln2"], x)
    y, aux = apply_moe(cfg, params["moe"], h2)
    return x + y, aux


def apply_moe_block(cfg: ArchConfig, params, x, rope, kv_sink=None):
    """Prefill block.  x: (b, s, d); ``rope``: the rotary tables of the
    positions; ``kv_sink`` = (k_cache, v_cache) takes this layer's K / V
    at [0, s) in place.  Returns (y, aux loss)."""
    h1 = L.apply_norm(cfg, params["ln1"], x)
    q, k, v = L.qkv_project(cfg, params["attn"], h1, rope)
    if kv_sink is not None:
        kv_sink[0][:, : k.shape[1]] = k
        kv_sink[1][:, : v.shape[1]] = v
    ctx = T.prefill_attend(q, k, v, cfg.logit_softcap)
    return _ffn(cfg, params, x + L.attn_out(cfg, params["attn"], ctx))


def apply_moe_block_decode(cfg: ArchConfig, params, x, k_cache, v_cache,
                           cache_len: int, rope):
    """Single-token block: the new K / V written at ``cache_len`` of the
    caches in place, attention over ``cache_len + 1`` positions, then the
    MoE FFN.  Returns y."""
    h1 = L.apply_norm(cfg, params["ln1"], x)
    q, k, v = L.qkv_project(cfg, params["attn"], h1, rope)
    k_cache[:, cache_len] = k[:, 0]
    v_cache[:, cache_len] = v[:, 0]
    ctx = T.decode_attend(q, k_cache, v_cache, cache_len + 1,
                          cfg.logit_softcap)
    return _ffn(cfg, params, x + L.attn_out(cfg, params["attn"], ctx))[0]
