"""Split-KV decode attention: the CUDA wrapper and its plain PyTorch version.

:func:`decode_attention` takes one query per head, q (b, H, d), and caches
(b, S_max, KV, d) with H % KV == 0, and attends over the first
``cache_len`` positions, as ``repro.kernels.decode_attention.ops
.decode_attention`` does.  On a CUDA tensor it launches
``csrc/decode_attention.cu`` once (one counted launch: the splits of a
(batch row, KV head) form a thread-block cluster that merges its partials
in the kernel, and no scratch tensor is allocated), or raises; on a CPU
tensor it runs :func:`decode_attention_plain`, which follows
``decode_attention_ref`` (logits in the input dtype then float32, float32
softmax, weights cast to the input dtype before the product with V).
:func:`split_plan` sizes the splits to ``cache_len``.  The kernel is held
to the plain version at 5e-5 in float32, and in bfloat16 within a tenth of
the plain output's RMS (the outputs, averages over the cache, are small:
flash attention's 5e-2 would be as large as they are).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..flash_attention.ops import DTYPES, HEAD_DIMS, NEG_INF, repeat_kv

__all__ = ["decode_attention", "decode_attention_plain",
           "decode_attention_work", "split_plan"]

SMS = 132  # streaming multiprocessors of an H100 SXM
MAX_SPLITS = 8  # the portable thread-block cluster size
SPLIT_ALIGN = 16  # split lengths are whole multiples of this many positions
# K and V bytes (bf16) a split reads at least: each block of a cluster
# costs barriers and a share of the merge, and on the H100 splits of fewer
# than about 256 positions at d = 64 measured slower
MIN_SPLIT_BYTES = 64 * 1024


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def split_plan(b: int, kv: int, d: int, cache_len: int) -> tuple[int, int]:
    """(n_splits, split_len) for a decode launch over ``cache_len`` positions.

    Enough splits that the b * kv * n_splits blocks fill about one wave of
    the card's :data:`SMS` SMs, at most :data:`MAX_SPLITS` (one cluster),
    and none shorter than :data:`MIN_SPLIT_BYTES` of K and V at head dim
    ``d``; the split length is a multiple of :data:`SPLIT_ALIGN`.  The
    splits [i * split_len, min((i + 1) * split_len, cache_len)) cover
    [0, cache_len) exactly and none is empty:
    (n_splits - 1) * split_len < cache_len <= n_splits * split_len.
    """
    if b < 1 or kv < 1 or d < 1 or cache_len < 1:
        raise ValueError(f"no split plan for b={b}, kv={kv}, d={d}, "
                         f"cache_len={cache_len}")
    min_len = _cdiv(_cdiv(MIN_SPLIT_BYTES, 4 * d), SPLIT_ALIGN) * SPLIT_ALIGN
    n = max(1, min(MAX_SPLITS, _cdiv(SMS, b * kv), _cdiv(cache_len, min_len)))
    split_len = _cdiv(_cdiv(cache_len, n), SPLIT_ALIGN) * SPLIT_ALIGN
    return _cdiv(cache_len, split_len), split_len


def decode_attention_work(b: int, h: int, kv: int, d: int, cache_len: int,
                          itemsize: int = 2) -> tuple[float, float]:
    """(operations, bytes) of one call: 4 d operations a head and cached
    position, q read and the output written, and the first ``cache_len``
    positions of K and V read once.  The bound of the kernel table and the
    roofline's count of a call."""
    flops = 4.0 * b * h * d * cache_len
    nbytes = itemsize * (2 * b * h * d + 2 * b * cache_len * kv * d)
    return flops, float(nbytes)


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
    1 <= cache_len <= S_max) valid positions.  Returns (b, H, d).  The
    kernel has no backward: with grad mode on and an input that requires
    grad it raises ``RuntimeError``."""
    _build.refuse_grad("decode_attention", q, k_cache, v_cache)
    cache_len = int(cache_len)
    _check(q, k_cache, v_cache, cache_len)
    dev = q.device
    if dev.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, cache_len)
    if dev.type == "meta":
        b, h, d = q.shape
        _build.note_meta_work("decode_attention", *decode_attention_work(
            b, h, k_cache.shape[2], d, cache_len, q.element_size()))
        return torch.empty_like(q)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    b, h, d = q.shape
    smax, kv = k_cache.shape[1], k_cache.shape[2]
    n_splits, split_len = split_plan(b, kv, d, cache_len)
    lib = _build.load("decode_attention")
    out = torch.empty_like(q)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    code = lib.decode_attention_launch(
        ptr(q), ptr(k_cache), ptr(v_cache), ptr(out), b, h, kv, smax, d,
        cache_len, n_splits, split_len, DTYPES[q.dtype],
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _build.check(lib, code, "decode_attention launch")
    _build.count_launch("decode_attention")
    return out
