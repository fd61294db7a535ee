"""Flash attention: the CUDA wrapper and its plain PyTorch version.

:func:`flash_attention` takes q (b, sq, H, d) and k, v (b, skv, KV, d)
with H % KV == 0, as ``repro.kernels.flash_attention.ops.flash_attention``
does, and returns (b, sq, H, d) in q's dtype.  On a CUDA tensor it
launches ``csrc/flash_attention.cu`` (or raises): in bfloat16 the Hopper
kernel (both products on the tensor cores through ``wgmma``, K and V
tiles by TMA), in float32 the FMA kernel (no TF32).  On a CPU tensor it
runs :func:`flash_attention_plain`, which follows ``flash_attention_ref``:
the KV heads repeated group-major, logits in the input dtype then float32,
the causal mask by absolute position with ``q_offset``, a float32
softmax, and the weights cast back to the input dtype before the product
with V.  The kernels keep scores, softmax state and sums in float32 and
scale the float32 scores; in bfloat16 the kernel rounds the unnormalised
weights to bfloat16 per 64-key tile before P V (the reference's
``p.astype(v.dtype)``), so the two differ by the rounding of q * scale,
the logits and the weights (held to 5e-2); in float32 they differ by
summation order only (held to 5e-5).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

__all__ = ["flash_attention", "flash_attention_plain", "repeat_kv"]

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 112, 128)
NEG_INF = -1e30


def repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(b, s, KV, d) -> (b, s, H, d), each KV head repeated H/KV times in
    place (group-major, as ``jnp.repeat`` along the head axis)."""
    kv = k.shape[2]
    if kv == n_heads:
        return k
    return k.repeat_interleave(n_heads // kv, dim=2)


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          q_offset: int = 0) -> torch.Tensor:
    """The reference's numerics on full score rows (no tiling)."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    kf, vf = repeat_kv(k, h), repeat_kv(v, h)
    logits = torch.einsum("bqhd,bshd->bhqs", q * (d ** -0.5), kf).float()
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
        kpos = torch.arange(skv, device=q.device)[None, :]
        logits = torch.where(qpos >= kpos, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqs,bshd->bqhd", w, vf)


def _check(q, k, v, q_offset):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be 4-D: (b, s, heads, d)")
    b, sq, h, d = q.shape
    kb, skv, kv, kd = k.shape
    if tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"v {tuple(v.shape)} must match k {tuple(k.shape)}")
    if kb != b or kd != d:
        raise ValueError(f"k {tuple(k.shape)} does not fit q {tuple(q.shape)}")
    if kv < 1 or h % kv:
        raise ValueError(f"{h} query heads do not group over {kv} KV heads")
    if skv < 1:
        raise ValueError("k and v need at least one position")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, expected {q.device}")
        if t.dtype not in DTYPES or t.dtype != q.dtype:
            raise TypeError(f"{name} has dtype {t.dtype}; expected float32 or "
                            f"bfloat16, the same for q, k and v")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def flash_attention(q, k, v, *, causal: bool = True,
                    q_offset: int = 0) -> torch.Tensor:
    """q: (b, sq, H, d); k, v: (b, skv, KV, d) -> (b, sq, H, d).

    ``q_offset`` is the absolute position of q[:, 0] (causal masking
    against keys at positions 0 .. skv-1).
    """
    q_offset = int(q_offset)
    _check(q, k, v, q_offset)
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    b, sq, h, d = q.shape
    skv, kv = k.shape[1], k.shape[2]
    lib = _build.load("flash_attention")
    out = torch.empty_like(q)
    code = lib.flash_attention_launch(
        ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k.data_ptr()),
        ctypes.c_void_p(v.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        b, sq, skv, h, kv, d, int(bool(causal)), q_offset, DTYPES[q.dtype],
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _build.check(lib, code, "flash_attention launch")
    _build.count_launch("flash_attention")
    return out
