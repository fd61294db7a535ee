"""Split-KV decode attention: the CUDA wrapper and its plain PyTorch version.

:func:`decode_attention` takes one query per head, q (b, H, d), and caches
(b, S_max, KV, d) with H % KV == 0, and attends over the first
``cache_len`` positions, as ``repro.kernels.decode_attention.ops
.decode_attention`` does.  On a CUDA tensor it launches the split kernel
of ``csrc/decode_attention.cu`` and then its log-sum-exp merge (two
launches, each counted), or raises; on a CPU tensor it runs
:func:`decode_attention_plain`, which follows ``decode_attention_ref``
(logits in the input dtype then float32, float32 softmax, weights cast to
the input dtype before the product with V).  The kernel is held to it at
5e-5 in float32, and in bfloat16 within a tenth of the plain output's RMS
(the outputs, averages over the cache, are small: flash attention's 5e-2
would be as large as they are).
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import _build
from ..flash_attention.ops import DTYPES, HEAD_DIMS, NEG_INF, repeat_kv

__all__ = ["decode_attention", "decode_attention_plain"]


def decode_attention_plain(q, k_cache, v_cache, cache_len: int) -> torch.Tensor:
    """The reference's numerics over the whole (masked) cache."""
    b, h, d = q.shape
    smax = k_cache.shape[1]
    kf, vf = repeat_kv(k_cache, h), repeat_kv(v_cache, h)
    logits = torch.einsum("bhd,bshd->bhs", q * (d ** -0.5), kf).float()
    mask = torch.arange(smax, device=q.device) < cache_len
    logits = torch.where(mask, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhs,bshd->bhd", w, vf)


def _check(q, k_cache, v_cache, cache_len):
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError("q must be (b, H, d) and the caches (b, S_max, KV, d)")
    b, h, d = q.shape
    cb, smax, kv, cd = k_cache.shape
    if tuple(v_cache.shape) != tuple(k_cache.shape):
        raise ValueError("k_cache and v_cache must have the same shape")
    if cb != b or cd != d:
        raise ValueError(f"caches {tuple(k_cache.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if kv < 1 or h % kv:
        raise ValueError(f"{h} query heads do not group over {kv} KV heads")
    if h // kv > 64:
        raise ValueError(f"{h // kv} query heads per KV head (at most 64)")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if not 1 <= cache_len <= smax:
        raise ValueError(f"cache_len {cache_len} outside [1, {smax}]")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, expected {q.device}")
        if t.dtype not in DTYPES or t.dtype != q.dtype:
            raise TypeError(f"{name} has dtype {t.dtype}; expected float32 or "
                            f"bfloat16, the same for q and the caches")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def decode_attention(q, k_cache, v_cache, cache_len: int) -> torch.Tensor:
    """q: (b, H, d); caches (b, S_max, KV, d); ``cache_len`` (a host int,
    1 <= cache_len <= S_max) valid positions.  Returns (b, H, d)."""
    cache_len = int(cache_len)
    _check(q, k_cache, v_cache, cache_len)
    dev = q.device
    if dev.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, cache_len)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    b, h, d = q.shape
    smax, kv = k_cache.shape[1], k_cache.shape[2]
    lib = _build.load("decode_attention")
    n_splits = math.ceil(smax / lib.decode_attention_split_len(d))
    f32 = dict(dtype=torch.float32, device=dev)
    m = torch.empty((b, h, n_splits), **f32)
    l = torch.empty((b, h, n_splits), **f32)
    acc = torch.empty((b, h, n_splits, d), **f32)
    out = torch.empty_like(q)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    code = lib.decode_attention_split_launch(
        ptr(q), ptr(k_cache), ptr(v_cache), ptr(m), ptr(l), ptr(acc),
        b, h, kv, smax, d, cache_len, n_splits, DTYPES[q.dtype], stream)
    _build.check(lib, code, "decode_attention split launch")
    _build.count_launch("decode_attention")
    code = lib.decode_attention_merge_launch(
        ptr(m), ptr(l), ptr(acc), ptr(out), b, h, d, n_splits,
        DTYPES[q.dtype], stream)
    _build.check(lib, code, "decode_attention merge launch")
    _build.count_launch("decode_attention")
    return out
