"""Kernel-substituted roofline: what the memory term becomes when the
attention kernel replaces the unfused attention.

The counterpart of ``repro.roofline.kernel_model``.  The reference
lowers XLA's attention at a cell's per-device shapes and walks its HLO;
the port walks its own plain attention (``flash_attention_plain``, which
materialises the (b, h, sq, skv) score tensors the kernel keeps on chip)
and, for the ssm family, the plain chunked mLSTM (``mlstm_chunked``), with
``op_cost.walk_ops`` on meta tensors, the cost model of the whole step.
That traffic is replaced by the kernel's HBM bytes:

    kernel fwd bytes = read(q) + read(k) + read(v) + write(o)
    kernel bwd bytes ~ 2.5x fwd (dq/dk/dv writes + recompute streams)

applied per attention call site (layers x microbatches x {fwd, recompute,
bwd}).  Everything else in the walked step is unchanged.  The branches
and the arithmetic are the reference's, line for line; its ``xla_bytes``
and ``flash_bytes`` are ``plain_bytes`` and ``kernel_bytes`` here.

What is subtracted is not what the port's plain train walk holds.  The
model takes out, a call site, two plain forwards and one autograd
forward and backward of the plain attention: XLA's forward, its remat
recompute and its backward.  The dry-run's plain walk
(``bytes_per_device_plain``, ``_build.plain_on_meta``) swaps only the
kernel's forward for the plain one; its backward is the port's own
``flash_attention_grad`` (a recompute and a backward in tensor ops, the
scores materialised) in the plain walk and the as-run walk alike, and
there is no second forward.  So in a train cell the subtraction can
exceed the attention the walk holds, and the floor or the cap then sets
the substituted bytes, not the kernel's saving: ``kernel_adjusted_terms``
names which (``bound``).
"""

from __future__ import annotations

import functools

import torch

from .op_cost import walk_ops

__all__ = ["attention_traffic", "floor_bytes", "kernel_adjusted_terms",
           "FLASH_BWD_FACTOR"]

FLASH_BWD_FACTOR = 2.5
META = torch.device("meta")


@functools.lru_cache(maxsize=64)
def _walk_attention(b: int, sq: int, skv: int, h: int, hd: int,
                    with_bwd: bool) -> float:
    """HBM bytes of the plain attention at these per-device shapes,
    walked with the same cost model as the full step."""
    from ..kernels.flash_attention.ops import flash_attention_plain

    q = torch.empty((b, sq, h, hd), dtype=torch.bfloat16, device=META)
    k = torch.empty((b, skv, h, hd), dtype=torch.bfloat16, device=META)
    v = torch.empty_like(k)

    def fwd():
        return flash_attention_plain(q, k, v, causal=True)

    def fwd_bwd():
        qkv = [t.clone().requires_grad_() for t in (q, k, v)]
        out = flash_attention_plain(*qkv, causal=True)
        torch.autograd.grad((out.float() ** 2).sum(), qkv)

    return walk_ops(fwd_bwd if with_bwd else fwd).bytes


@functools.lru_cache(maxsize=16)
def _walk_mlstm(b: int, s: int, h: int, dk: int, dv: int, chunk: int,
                with_bwd: bool) -> float:
    """HBM bytes of the plain chunked mLSTM at per-device shapes, walked
    with the same cost model."""
    from ..models.xlstm import mlstm_chunked

    q = torch.empty((b, s, h, dk), device=META)
    v = torch.empty((b, s, h, dv), device=META)
    g = torch.empty((b, s, h), device=META)

    def fwd():
        return mlstm_chunked(q, q, v, g, g, chunk)[0]

    def fwd_bwd():
        ins = [t.clone().requires_grad_() for t in (q, q, v, g, g)]
        out, _ = mlstm_chunked(*ins, chunk)
        torch.autograd.grad((out ** 2).sum(), ins)

    return walk_ops(fwd_bwd if with_bwd else fwd).bytes


def attention_traffic(cfg, cell, policy, mesh_shape: dict) -> dict:
    """Per-device attention/recurrence HBM bytes per step: the plain path
    vs the kernel (flash attention, or the chunked-scan kernel for SSM)."""
    if cfg.family == "ssm":
        # mLSTM chunk matrices (CL x CL gate/score tiles) are the analogue
        # of attention scores; a chunked-scan kernel keeps them on chip
        if cell.kind != "train":
            return {"plain_bytes": 0.0, "kernel_bytes": 0.0, "calls": 0}
        dp_total = 1
        for a in policy.dp_axes:
            dp_total *= mesh_shape[a]
        b_local = max(
            cell.global_batch // dp_total, 1
        ) // max(policy.num_microbatches, 1) or 1
        ssm = cfg.ssm
        dk, dv, chunk = ssm.state_dim, ssm.head_dim, ssm.chunk
        h = cfg.n_heads
        s_walk = min(cell.seq_len, 4096)
        n_mlstm = cfg.n_layers - len(ssm.slstm_layers)
        n_apps = n_mlstm * policy.num_microbatches
        plain = (
            2 * _walk_mlstm(b_local, s_walk, h, dk, dv, chunk, False)
            + _walk_mlstm(b_local, s_walk, h, dk, dv, chunk, True)
        ) * (cell.seq_len / s_walk)
        qkv = b_local * cell.seq_len * h * (2 * dk + dv) * 4
        kernel = (2 * qkv) * (2 + FLASH_BWD_FACTOR)
        return {"plain_bytes": plain * n_apps,
                "kernel_bytes": kernel * n_apps, "calls": n_apps}
    dp_total = 1
    for a in policy.dp_axes:
        dp_total *= mesh_shape[a]
    model = mesh_shape[policy.model_axis]

    gb = cell.global_batch
    b_local = max(gb // dp_total, 1) // max(policy.num_microbatches, 1)
    b_local = max(b_local, 1)
    heads = policy.attn_pad_heads or cfg.n_heads
    h_local = max(heads // model, 1) if heads % model == 0 else heads
    hd = cfg.head_dim

    if cell.kind == "train":
        sq = skv = cell.seq_len
        # attention applications per step
        if cfg.family == "hybrid":
            n_apps = cfg.n_layers // cfg.hybrid.attn_every
        elif cfg.enc_dec:
            n_apps = 3 * cfg.n_layers  # enc self + dec self + cross
            sq = skv = cell.seq_len  # enc dominates
        else:
            n_apps = cfg.n_layers
        n_apps *= policy.num_microbatches
        # fwd + remat recompute (fwd again) + bwd
        plain = (
            2 * _walk_attention(b_local, min(sq, 4096), min(skv, 4096),
                                h_local, hd, False)
            + _walk_attention(b_local, min(sq, 4096), min(skv, 4096),
                              h_local, hd, True)
        )
        # scale if we clamped the walk shapes (score bytes scale ~ sq*skv)
        scale = (sq * skv) / (min(sq, 4096) * min(skv, 4096))
        plain *= scale
        qkv = b_local * sq * h_local * hd * 2
        kernel = (4 * qkv) * (2 + FLASH_BWD_FACTOR)  # fwd + recompute + bwd
        return {"plain_bytes": plain * n_apps,
                "kernel_bytes": kernel * n_apps, "calls": n_apps}

    if cell.kind == "prefill":
        sq = skv = cell.seq_len
        n_apps = (3 if cfg.enc_dec else 1) * cfg.n_layers
        if cfg.family == "hybrid":
            n_apps = cfg.n_layers // cfg.hybrid.attn_every
        plain = _walk_attention(b_local, min(sq, 4096), min(skv, 4096),
                                h_local, hd, False)
        plain *= (sq * skv) / (min(sq, 4096) ** 2)
        qkv = b_local * sq * h_local * hd * 2
        kernel = 4 * qkv
        return {"plain_bytes": plain * n_apps,
                "kernel_bytes": kernel * n_apps, "calls": n_apps}

    # decode: score tensor is (b, h, 1, skv) -- the plain path and the
    # decode kernel both stream the KV once; substitution is a wash
    return {"plain_bytes": 0.0, "kernel_bytes": 0.0, "calls": 0}


def floor_bytes(cfg, cell, policy, mesh_shape: dict) -> float:
    """Irreducible per-device HBM traffic: weight streams + residual
    activations + logits (what remains once attention is fused)."""
    from ..models.lm import count_params

    model = mesh_shape[policy.model_axis]
    dp_total = 1
    for a in policy.dp_axes:
        dp_total *= mesh_shape[a]
    n = count_params(cfg)  # the full-size tree on the meta device
    passes = 3 if cell.kind == "train" else 1  # fwd + bwd + remat
    micro = policy.num_microbatches if cell.kind == "train" else 1
    weights = (n / model) * 2 * passes * micro
    b_local = max(cell.global_batch // dp_total, 1)
    s = cell.seq_len if cell.kind != "decode" else 1
    depth = cfg.n_layers * (2 if cfg.enc_dec else 1)
    residuals = depth * b_local * s * cfg.d_model * 2 * 2 * passes
    logits = b_local * s * (cfg.vocab_size / model) * 4 * 2 * passes
    return weights + residuals + logits


def kernel_adjusted_terms(report: dict, cfg, cell, policy,
                          mesh_shape: dict) -> dict:
    """``report``'s terms with its memory term's attention traffic
    replaced by the kernel's: ``report["bytes_per_device"]`` is the step
    as walked with the plain attention.  ``bound`` says what set the
    bytes: ``"substitution"`` (the walk less the plain traffic plus the
    kernel's), ``"floor"`` (:func:`floor_bytes` and the kernel's bytes,
    above the substitution) or ``"cap"`` (the walk itself, below both)."""
    from .analysis import HBM_BW

    traffic = attention_traffic(cfg, cell, policy, mesh_shape)
    floor = floor_bytes(cfg, cell, policy, mesh_shape) + traffic["kernel_bytes"]
    substituted = (report["bytes_per_device"] - traffic["plain_bytes"]
                   + traffic["kernel_bytes"])
    adj_bytes = max(
        substituted,
        floor,
    )
    adj_bytes = min(adj_bytes, report["bytes_per_device"])
    # what set the bytes: the substitution itself, the floor under it, or
    # the cap of the walk it started from
    bound = ("substitution" if adj_bytes == substituted
             else "floor" if adj_bytes == floor else "cap")
    terms = dict(report["terms"])
    terms["memory_s"] = adj_bytes / HBM_BW
    dominant = max(terms, key=terms.get)
    return {
        "terms": terms,
        "dominant": dominant,
        "bytes_per_device": adj_bytes,
        "bound": bound,
        "attention_traffic": traffic,
    }
