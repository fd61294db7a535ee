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

:func:`flash_attention` has no backward: with grad mode on and an input
that requires grad it raises ``RuntimeError`` (the kernel's output would
carry no autograd graph).  :class:`FlashAttentionFn` is the trainable
form.  Its forward is the same kernel launch, which on a CUDA tensor also
writes each row's log-sum-exp (LSE, float32 (b, H, sq)) and, in
bfloat16, each output element's bf16 rounding residual; inference passes
neither buffer and runs nothing more.  Its backward, on a CUDA tensor,
launches ``csrc/flash_attention_bwd.cu`` (or raises): an FA2-style
backward that rebuilds P = exp(S - LSE), forms Delta = rowsum(dO o out)
from the float32 output (the bf16 output plus its residual) and writes
dQ from one kernel and the group-summed dK and dV from another, in
float32 registers with no atomics, so two passes are bit-equal; in
bfloat16 both on ``wgmma`` with TMA-fed tiles, and where the dkdv grid is
under a wave of the card (:func:`dkdv_splits`) each KV head's group is
split over several blocks whose float32 partials a third launch sums in
split order.  On a CPU tensor the backward is :func:`flash_attention_grad`,
the plain backward (the gradient of the reference's numerics as tensor
ops), which is also the card's oracle in ``chip_smoke.py``.  The
reference has no backward kernel: its training differentiates an XLA
twin of the attention.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

__all__ = ["FlashAttentionFn", "dkdv_splits", "flash_attention",
           "flash_attention_grad",
           "flash_attention_grad_work", "flash_attention_plain",
           "flash_attention_work", "repeat_kv"]

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 112, 128)
NEG_INF = -1e30
SMS = 132  # the H100's streaming multiprocessors: one wave of blocks
TILE = 64  # the backward kernel's query and key tiles


def dkdv_splits(b: int, skv: int, kv: int, group: int) -> int:
    """How many blocks the bf16 backward's dkdv launch cuts each KV head's
    group of ``group`` query heads into: 1 where its grid of one block a
    (64-key tile, KV head, batch row) fills a wave of the card, else
    enough splits for about two blocks a SM (one block's softmax math
    beside another's tensor-core products), at most one a head.  Split i
    takes the group's heads [i group // splits, (i + 1) group // splits)."""
    blocks = b * -(-skv // TILE) * kv
    if blocks >= SMS:
        return 1
    return max(1, min(group, -(-2 * SMS // blocks)))


def repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(b, s, KV, d) -> (b, s, H, d), each KV head repeated H/KV times in
    place (group-major, as ``jnp.repeat`` along the head axis)."""
    kv = k.shape[2]
    if kv == n_heads:
        return k
    return k.repeat_interleave(n_heads // kv, dim=2)


def _visible_pairs(sq: int, skv: int, causal: bool, q_offset: int) -> int:
    """(query, key) pairs a head sees: all of them, or under the causal
    mask those with key <= query + q_offset (about half)."""
    if not causal:
        return sq * skv
    full = min(max(skv - q_offset, 0), sq)  # rows that stop before skv
    return full * q_offset + full * (full + 1) // 2 + (sq - full) * skv


def flash_attention_work(b: int, sq: int, skv: int, h: int, kv: int, d: int,
                         causal: bool, q_offset: int = 0,
                         itemsize: int = 2) -> tuple[float, float]:
    """(operations, bytes) of one forward call: 4 d operations a visible
    (query, key) pair and head (Q K^T and P V; a causal call sees about
    half the pairs), and q, k, v read once and the output written once.
    The bound of the kernel table and the roofline's count of a call."""
    flops = 4.0 * b * h * d * _visible_pairs(sq, skv, causal, q_offset)
    nbytes = itemsize * (2 * b * sq * h * d + 2 * b * skv * kv * d)
    return flops, float(nbytes)


def flash_attention_grad_work(b: int, sq: int, skv: int, h: int, kv: int,
                              d: int, causal: bool, q_offset: int = 0,
                              itemsize: int = 2) -> tuple[float, float]:
    """(operations, bytes) of one backward call, the minimal work: 10 d
    operations a visible (query, key) pair and head (S = Q K^T again,
    dV = P^T dO, dP = dO V^T, dQ = dS K and dK = dS^T Q; causal about
    half), q, k, v, out and dO read once in their dtype and the float32
    LSE, dq, dk and dv written once.  The kernel recomputes S and dP in
    both of its launches (14 d a pair), which this count leaves out.  The
    bound of the kernel table and the roofline's count of a call."""
    flops = 10.0 * b * h * d * _visible_pairs(sq, skv, causal, q_offset)
    q_elems, kv_elems = b * sq * h * d, b * skv * kv * d
    nbytes = (itemsize * (3 * q_elems + 2 * kv_elems)  # q, out, dO; k, v
              + 4 * b * h * sq  # LSE
              + itemsize * (q_elems + 2 * kv_elems))  # dq, dk, dv
    return flops, float(nbytes)


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
    against keys at positions 0 .. skv-1).  Raises ``RuntimeError`` when
    grad mode is on and an input requires grad (see the module's
    docstring).
    """
    _build.refuse_grad("flash_attention", q, k, v)
    return _attend(q, k, v, causal, int(q_offset))


def _attend(q, k, v, causal: bool, q_offset: int, with_lse: bool = False):
    """The kernel on a CUDA tensor, the plain version on a CPU one; on a
    meta tensor only the output's shape, and the kernel's work noted (in
    ``_build.plain_on_meta``, the plain version's ops).  With ``with_lse``
    (the trainable form) returns (out, LSE, out_lo): on a CUDA tensor the
    LSE, float32 (b, H, sq), and in bfloat16 out_lo, the bf16 residual of
    each output element (out + out_lo is the float32 output, which the
    backward's Delta reads); None elsewhere (the CPU and meta backwards
    read neither)."""
    _check(q, k, v, q_offset)
    dev = q.device
    if dev.type == "cpu" or (dev.type == "meta" and _build.meta_runs_plain()):
        out = flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset)
        return (out, None, None) if with_lse else out
    if dev.type == "meta":
        b, sq, h, d = q.shape
        _build.note_meta_work("flash_attention", *flash_attention_work(
            b, sq, k.shape[1], h, k.shape[2], d, causal, q_offset,
            q.element_size()))
        out = torch.empty_like(q)
        return (out, None, None) if with_lse else out
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    b, sq, h, d = q.shape
    skv, kv = k.shape[1], k.shape[2]
    lib = _build.load("flash_attention")
    out = torch.empty_like(q)
    lse = out_lo = None
    if with_lse:
        lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
        if q.dtype == torch.bfloat16:
            out_lo = torch.empty_like(q)
    ptr = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())  # noqa: E731
    code = lib.flash_attention_launch(
        ptr(q), ptr(k), ptr(v), ptr(out), ptr(lse), ptr(out_lo),
        b, sq, skv, h, kv, d, int(bool(causal)), q_offset, DTYPES[q.dtype],
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _build.check(lib, code, "flash_attention launch")
    _build.count_launch("flash_attention")
    return (out, lse, out_lo) if with_lse else out


def _attend_grad(q, k, v, out, out_lo, lse, dout, causal: bool,
                 q_offset: int):
    """(dq, dk, dv) by device, with the forwards' rule: the plain backward
    on a CPU tensor; on a meta tensor the outputs' shapes and the backward
    kernel's work noted (in ``_build.plain_on_meta``, the plain backward's
    ops); on a CUDA tensor the backward kernel, or a raise; anything else
    raises."""
    dev = q.device
    if dev.type == "cpu" or (dev.type == "meta" and _build.meta_runs_plain()):
        return flash_attention_grad(q, k, v, dout, causal=causal,
                                    q_offset=q_offset)
    _check(q, k, v, q_offset)
    if tuple(dout.shape) != tuple(q.shape) or dout.dtype != q.dtype or (
            dout.device != dev):
        raise ValueError(f"dout {tuple(dout.shape)} {dout.dtype} must match "
                         f"q {tuple(q.shape)} {q.dtype} on {dev}")
    b, sq, h, d = q.shape
    skv, kv = k.shape[1], k.shape[2]
    if dev.type == "meta":
        _build.note_meta_work("flash_attention_bwd", *flash_attention_grad_work(
            b, sq, skv, h, kv, d, causal, q_offset, q.element_size()))
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if lse is None or tuple(lse.shape) != (b, h, sq) or (
            lse.dtype != torch.float32):
        raise ValueError("the backward kernel needs the forward's float32 "
                         f"LSE of shape {(b, h, sq)}")
    if out_lo is None and q.dtype == torch.bfloat16:
        raise ValueError("the bf16 backward kernel needs the forward's "
                         "output residual out_lo")
    rows = [("out", out), ("dout", dout)]
    if out_lo is not None:
        rows.append(("out_lo", out_lo))
    for name, t in rows:
        if (tuple(t.shape) != tuple(q.shape) or t.dtype != q.dtype
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {tuple(q.shape)} "
                             f"{q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v), *rows):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    lib = _build.load("flash_attention_bwd")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    f32 = dict(dtype=torch.float32, device=dev)
    sqp = -(-sq // TILE) * TILE
    stats = torch.empty((2, b, h, sqp), **f32)  # LSE (log2) and Delta
    splits = (dkdv_splits(b, skv, kv, h // kv) if q.dtype == torch.bfloat16
              else 1)
    part = (torch.empty((2, splits, b, skv, kv, d), **f32) if splits > 1
            else None)
    ptr = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())  # noqa: E731
    code = lib.flash_attention_bwd_launch(
        ptr(q), ptr(k), ptr(v), ptr(out), ptr(out_lo), ptr(dout), ptr(lse),
        ptr(stats), ptr(part), ptr(dq), ptr(dk), ptr(dv), b, sq, skv, h, kv,
        d, int(bool(causal)), q_offset, splits, DTYPES[q.dtype],
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _build.check(lib, code, "flash_attention_bwd launch")
    _build.count_launch("flash_attention_bwd")
    return dq, dk, dv


def flash_attention_grad(q, k, v, dout, *, causal: bool = True,
                         q_offset: int = 0):
    """(dq, dk, dv) of :func:`flash_attention_plain` at (q, k, v) for the
    output cotangent ``dout`` (b, sq, H, d), in q's dtype: the plain
    backward (the CPU's, the tests', and the card's oracle in
    ``chip_smoke.py``; on the card :class:`FlashAttentionFn` launches the
    backward kernel instead).

    The gradient of the reference's numerics: the logits recomputed in the
    input dtype from (q * d^-0.5) and K then taken to float32, the causal
    mask, the float32 softmax P, the weights cast to the input dtype before
    P V; then dV = P^T dO, dP = dO V^T (to float32), dS = P o (dP -
    rowsum(dP o P)) (cast to the input dtype), d(q * scale) = dS K, dq =
    that times the scale, and dK = dS^T (q * scale).  Query heads are laid
    out (KV, group) group-major, so each KV head's dK and dV are the sums
    over its query group, taken in float32.  Peak memory: four float32
    (b, H, sq, skv) tensors.
    """
    _check(q, k, v, int(q_offset))
    if tuple(dout.shape) != tuple(q.shape) or dout.dtype != q.dtype:
        raise ValueError(f"dout {tuple(dout.shape)} {dout.dtype} must match "
                         f"q {tuple(q.shape)} {q.dtype}")
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    dtype = q.dtype
    scale = d ** -0.5
    # (b, KV, group, s, d): query head kv * g + j is group kv, member j
    qs = q.reshape(b, sq, kvh, g, d).permute(0, 2, 3, 1, 4) * scale
    do = dout.reshape(b, sq, kvh, g, d).permute(0, 2, 3, 1, 4)
    kt = k.permute(0, 2, 1, 3)[:, :, None]  # (b, KV, 1, skv, d)
    vt = v.permute(0, 2, 1, 3)[:, :, None]
    logits = torch.matmul(qs, kt.transpose(-1, -2)).float()
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + int(q_offset)
        kpos = torch.arange(skv, device=q.device)[None, :]
        logits = torch.where(qpos >= kpos, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    del logits
    dv = torch.matmul(p.to(dtype).transpose(-1, -2), do)  # (b, KV, g, skv, d)
    dp = torch.matmul(do, vt.transpose(-1, -2)).float()
    ds = (p * (dp - (dp * p).sum(dim=-1, keepdim=True))).to(dtype)
    del p, dp
    dq = torch.matmul(ds, kt) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qs)
    dq = dq.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d)
    dk = dk.float().sum(dim=2).to(dtype).permute(0, 2, 1, 3)
    dv = dv.float().sum(dim=2).to(dtype).permute(0, 2, 1, 3)
    return dq, dk.contiguous(), dv.contiguous()


class FlashAttentionFn(torch.autograd.Function):
    """Trainable flash attention: ``FlashAttentionFn.apply(q, k, v, causal,
    q_offset)``.  The forward is :func:`flash_attention`'s launch (the
    Hopper kernel on a CUDA tensor, which also writes the rows' LSE and,
    in bfloat16, the output's residual, or a raise; the plain version on a
    CPU one) and saves q, k, v, the output, its residual and the LSE.  The
    backward dispatches as the forward does: on a CUDA tensor the backward
    kernel (``csrc/flash_attention_bwd.cu``, one count
    of ``flash_attention_bwd`` a call), or a raise; on a CPU tensor
    :func:`flash_attention_grad`; on a meta tensor the kernel's work noted.
    Not a fallback: on the card both directions always launch kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool = True, q_offset: int = 0):
        out, lse, out_lo = _attend(q, k, v, causal, int(q_offset),
                                   with_lse=True)
        ctx.save_for_backward(q, k, v, out, out_lo, lse)
        ctx.causal, ctx.q_offset = causal, int(q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, out_lo, lse = ctx.saved_tensors
        dq, dk, dv = _attend_grad(q, k, v, out, out_lo, lse,
                                  dout.contiguous(), ctx.causal, ctx.q_offset)
        return dq, dk, dv, None, None
