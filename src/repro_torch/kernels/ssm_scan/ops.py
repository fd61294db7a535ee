"""The SSD chunked scan: the CUDA wrapper and its plain PyTorch version.

:func:`ssd_scan` takes x (B, S, H, P), dt (B, S, H), a_log (H,) (A =
-exp(a_log)), b and c (B, S, G, N) with H % G == 0, d_skip (H,) and an
optional float32 ``initial_state`` (B, H, N, P), as ``repro.models.ssm
.ssd_chunked`` does, and returns (y (B, S, H, P) in x's dtype, the final
state (B, H, N, P) in float32).  Head h reads B/C group h // (H / G), the
group-major order of the reference's ``jnp.repeat``.  x, b and c may be
views with any batch and token strides (multiples of 16 bytes) as long as
their last two dims are packed, such as the model's slices of one
activation; dt, a_log, d_skip and the initial state are contiguous.

On a CUDA tensor it launches ``csrc/ssd_scan.cu`` (or raises), which walks
the sequence in fixed chunks of 64 positions and masks the ragged tail:
bfloat16 runs the chunk's products on the tensor cores (bf16 operands,
float32 accumulation, the float32 weights and the state update's float32
operand each split into two bf16 parts), float32 runs them on the FMA
units.  On a CPU tensor it runs :func:`ssd_scan_plain`, which follows
``ssd_chunked`` with the reference model's chunk rule: chunks of
``min(chunk, S)``, or one chunk of S when that does not divide S.
Chunking is exact in real arithmetic, so the two differ by rounding only:
the kernel is held to the plain version within 1e-4 * (1 + |plain|) in
float32 and 5e-2 * (1 + |plain|) in bfloat16 (the output's rounding), its
final state within 1e-4 * (1 + |plain|) in both, on inputs whose
per-chunk decay stays mild.

:func:`ssd_scan` has no backward: with grad mode on and an input that
requires grad it raises ``RuntimeError``.  :class:`SsdScanFn` is the
trainable form: its forward is the same launch (or, on a CPU tensor, the
plain version), and its backward is the gradient of the reference's
``ssd_chunked`` at the reference model's chunk rule, taken by autograd
through a recompute of :func:`ssd_scan_plain` (tensor ops).  The reference
has no backward kernel: its training forward differentiates the XLA twin.

:func:`ssd_sequential` is the reference's step-by-step oracle.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build

__all__ = ["CHUNK", "SsdScanFn", "effective_chunk", "expand_groups",
           "ssd_scan", "ssd_scan_grad", "ssd_scan_plain", "ssd_scan_work",
           "ssd_sequential"]

CHUNK = 128  # the reference's default chunk (zamba2's SSMConfig.chunk)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_DIM = 128  # P and N: multiples of 16, at most this


def expand_groups(t: torch.Tensor, h: int, dim: int) -> torch.Tensor:
    """B/C groups along ``dim`` expanded to ``h`` heads, group-major (the
    reference's ``jnp.repeat``)."""
    g = t.shape[dim]
    return t if g == h else t.repeat_interleave(h // g, dim=dim)


def ssd_sequential(x, dt, a_log, b, c, d_skip):
    """Oracle: the step-by-step recurrence.  Returns (y, final_state)."""
    bs, s, h, p = x.shape
    n = b.shape[3]
    a = -torch.exp(a_log.float())  # (H,)
    bx = expand_groups(b, h, 2).float()
    cx = expand_groups(c, h, 2).float()
    xf, dtf = x.float(), dt.float()
    state = torch.zeros((bs, h, n, p), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        decay = torch.exp(dtf[:, t] * a)  # (B, H)
        upd = torch.einsum("bh,bhn,bhp->bhnp", dtf[:, t], bx[:, t], xf[:, t])
        state = state * decay[..., None, None] + upd
        ys.append(torch.einsum("bhn,bhnp->bhp", cx[:, t], state))
    y = torch.stack(ys, dim=1) + d_skip.float()[None, None, :, None] * xf
    return y.to(x.dtype), state


def effective_chunk(s: int, chunk: int = CHUNK) -> int:
    """The reference model's chunk rule (``apply_mamba2_block``)."""
    eff = min(chunk, s)
    return s if s % eff else eff


def ssd_scan_work(bs: int, s: int, h: int, g: int, p: int, n: int,
                  itemsize: int = 2, initial_state: bool = False,
                  chunk: int = CHUNK) -> tuple[float, float]:
    """(operations, bytes) of one call, at the reference's chunk rule
    (:func:`effective_chunk`): a (batch row, head, chunk) forms C B^T and
    the weighted x (2 cl^2 N + 2 cl^2 P), the chunk state and the
    inter-chunk product (4 cl N P); x, b and c read once in their dtype,
    dt (float32), a_log and d_skip, the initial state if given, y written
    in x's dtype and the float32 final state.  The bound of the kernel
    table and the roofline's count of a call."""
    cl = effective_chunk(s, chunk)
    flops = (2.0 * bs * h * (s // cl)
             * (cl * cl * (n + p) + 2 * cl * n * p))
    state = bs * h * n * p * 4
    nbytes = (itemsize * (2 * bs * s * h * p + 2 * bs * s * g * n)
              + 4 * (bs * s * h + 2 * h) + state * (2 if initial_state else 1))
    return flops, float(nbytes)


def ssd_scan_plain(x, dt, a_log, b, c, d_skip, initial_state=None,
                   chunk: int = CHUNK):
    """``ssd_chunked`` at :func:`effective_chunk` (s, chunk).  Returns
    (y in x's dtype, final state in float32)."""
    bs, s, h, p = x.shape
    n = b.shape[3]
    cl = effective_chunk(s, chunk)
    nc = s // cl
    a = -torch.exp(a_log.float())
    xf = x.float().reshape(bs, nc, cl, h, p)
    dtf = dt.float().reshape(bs, nc, cl, h)
    bf = expand_groups(b, h, 2).float().reshape(bs, nc, cl, h, n)
    cf = expand_groups(c, h, 2).float().reshape(bs, nc, cl, h, n)

    cum = torch.cumsum(dtf * a, dim=2)  # (B, nc, cl, H) inclusive log decay
    total = cum[:, :, -1]  # (B, nc, H)

    # intra-chunk: y_t = sum_{s<=t} (C_t . B_s) exp(L_t - L_s) dt_s x_s;
    # the decay is masked BEFORE the exp (above the diagonal L_t - L_s > 0)
    cb = torch.einsum("bkthn,bkshn->bkhts", cf, bf)
    ldiff = (cum[..., :, None, :] - cum[..., None, :, :]).permute(0, 1, 4, 2, 3)
    mask = torch.ones((cl, cl), dtype=torch.bool, device=x.device).tril()
    w = torch.where(mask, cb * torch.exp(torch.where(mask, ldiff, 0.0)), 0.0)
    xdt = xf * dtf[..., None]
    y = torch.einsum("bkhts,bkshp->bkthp", w, xdt)

    # per-chunk input states, then the recurrence over chunks
    decay_to_end = torch.exp(total[:, :, None] - cum)  # (B, nc, cl, H)
    sk = torch.einsum("bksh,bkshn,bkshp->bkhnp", decay_to_end * dtf, bf, xf)
    chunk_decay = torch.exp(total)  # (B, nc, H)
    state = (torch.zeros((bs, h, n, p), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.float())
    prev = []
    for k in range(nc):
        prev.append(state)  # the state BEFORE chunk k
        state = state * chunk_decay[:, k, :, None, None] + sk[:, k]
    prev_states = torch.stack(prev, dim=1)  # (B, nc, H, N, P)
    y = y + torch.einsum("bkth,bkthn,bkhnp->bkthp", torch.exp(cum), cf,
                         prev_states)
    y = y.reshape(bs, s, h, p) + d_skip.float()[None, None, :, None] * x.float()
    return y.to(x.dtype), state


def _rows_ok(t: torch.Tensor) -> bool:
    """Last two dims packed, and every batch and token stride that matters
    (its dim longer than 1) a multiple of 16 bytes."""
    es = t.element_size()
    return (t.stride(3) == 1
            and (t.shape[2] == 1 or t.stride(2) == t.shape[3])
            and all(t.shape[d] == 1 or t.stride(d) * es % 16 == 0
                    for d in (0, 1)))


def _check(x, dt, a_log, b, c, d_skip, initial_state):
    if x.dim() != 4 or b.dim() != 4 or c.dim() != 4 or dt.dim() != 3:
        raise ValueError("x must be (B, S, H, P), dt (B, S, H) and b, c "
                         "(B, S, G, N)")
    bs, s, h, p = x.shape
    _, _, g, n = b.shape
    if tuple(c.shape) != tuple(b.shape):
        raise ValueError(f"c {tuple(c.shape)} must match b {tuple(b.shape)}")
    if tuple(b.shape[:2]) != (bs, s) or tuple(dt.shape) != (bs, s, h):
        raise ValueError(f"dt {tuple(dt.shape)} / b {tuple(b.shape)} do not "
                         f"fit x {tuple(x.shape)}")
    if g < 1 or h % g:
        raise ValueError(f"{h} heads do not group over {g} B/C groups")
    if s < 1 or bs < 1:
        raise ValueError("need at least one batch row and one position")
    for name, dim in (("head dim P", p), ("state dim N", n)):
        if dim % 16 or not 16 <= dim <= MAX_DIM:
            raise ValueError(f"{name} {dim} must be a multiple of 16 in "
                             f"[16, {MAX_DIM}]")
    if tuple(a_log.shape) != (h,) or tuple(d_skip.shape) != (h,):
        raise ValueError(f"a_log and d_skip must be ({h},)")
    if x.dtype not in DTYPES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(f"x, b and c have dtypes {x.dtype}, {b.dtype}, "
                        f"{c.dtype}; expected float32 or bfloat16, all one")
    tensors = [("x", x), ("dt", dt), ("a_log", a_log), ("b", b), ("c", c),
               ("d_skip", d_skip)]
    if initial_state is not None:
        if tuple(initial_state.shape) != (bs, h, n, p):
            raise ValueError(f"initial_state must be {(bs, h, n, p)}")
        tensors.append(("initial_state", initial_state))
    for name, t in tensors:
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, expected {x.device}")
        if name in ("dt", "a_log", "d_skip", "initial_state") and (
                t.dtype != torch.float32):
            raise TypeError(f"{name} has dtype {t.dtype}; expected float32")
        if name in ("x", "b", "c"):
            if not _rows_ok(t):
                raise ValueError(
                    f"{name} must be contiguous in its last two dims, with "
                    f"batch and token strides of 16-byte multiples; got "
                    f"strides {t.stride()}")
        elif not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if any(b.shape[d] > 1 and b.stride(d) != c.stride(d) for d in (0, 1)):
        raise ValueError(f"b and c must share batch and token strides, got "
                         f"{b.stride()} and {c.stride()}")


def ssd_scan(x, dt, a_log, b, c, d_skip,
             initial_state: Optional[torch.Tensor] = None, *,
             chunk: int = CHUNK):
    """x (B, S, H, P); dt (B, S, H) float32; a_log, d_skip (H,) float32;
    b, c (B, S, G, N) in x's dtype; initial_state (B, H, N, P) float32 or
    None.  Returns (y (B, S, H, P) in x's dtype, final_state (B, H, N, P)
    float32).  ``chunk`` is the plain version's chunk (the CPU path); the
    kernel keeps its own 64.  x, b and c may be token-strided views (see
    the module's docstring).  The kernel has no backward: with grad mode on
    and an input that requires grad it raises ``RuntimeError`` (the
    trainable form is :class:`SsdScanFn`)."""
    _build.refuse_grad("ssd_scan", x, dt, a_log, b, c, d_skip, initial_state)
    return _scan(x, dt, a_log, b, c, d_skip, initial_state, chunk)


def _scan(x, dt, a_log, b, c, d_skip, initial_state, chunk: int):
    """The kernel on a CUDA tensor, the plain version on a CPU one."""
    _check(x, dt, a_log, b, c, d_skip, initial_state)
    dev = x.device
    if dev.type == "cpu":
        return ssd_scan_plain(x, dt, a_log, b, c, d_skip, initial_state,
                              chunk)
    bs, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if dev.type == "meta":
        _build.note_meta_work("ssd_scan", *ssd_scan_work(
            bs, s, h, g, p, n, x.element_size(), initial_state is not None,
            chunk))
        return (torch.empty(x.shape, dtype=x.dtype, device=dev),
                torch.empty((bs, h, n, p), dtype=torch.float32, device=dev))
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for name, t in (("x", x), ("b", b), ("c", c)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    lib = _build.load("ssd_scan")
    y = torch.empty(x.shape, dtype=x.dtype, device=dev)
    state = torch.empty((bs, h, n, p), dtype=torch.float32, device=dev)
    ptr = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())  # noqa: E731
    code = lib.ssd_scan_launch(
        ptr(x), ptr(dt), ptr(a_log), ptr(b), ptr(c), ptr(d_skip),
        ptr(initial_state), ptr(y), ptr(state), bs, s, h, g, p, n,
        DTYPES[x.dtype], x.stride(0), x.stride(1), b.stride(0), b.stride(1),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _build.check(lib, code, "ssd_scan launch")
    _build.count_launch("ssd_scan")
    return y, state


def ssd_scan_grad(x, dt, a_log, b, c, d_skip, initial_state, dy, dstate,
                  chunk: int = CHUNK, needs=(True,) * 7):
    """The gradients of :func:`ssd_scan_plain` at these inputs for the
    cotangents ``dy`` (of y, in x's dtype) and ``dstate`` (of the final
    state, float32), either None where its output is not used: (dx, ddt,
    da_log, db, dc, dd_skip, dinitial_state), each None where ``needs``
    says so (or, for the initial state, where none was given).

    This is the gradient of the reference's ``ssd_chunked`` at
    :func:`effective_chunk` (S, ``chunk``), its float32 numerics (x, b and
    c cast to float32, the group-major expansion of B and C summed back
    over each group's heads, y cast back to x's dtype), taken by autograd
    through a recompute of the plain version under grad mode: tensor ops,
    with the intra-chunk (B, nc, H, cl, cl) float32 tensors kept for the
    backward of the recompute only.  Each gradient has its input's shape
    and dtype, whatever the input's strides."""
    inputs = (x, dt, a_log, b, c, d_skip, initial_state)
    leaves = [None if t is None else t.detach().requires_grad_(bool(n))
              for t, n in zip(inputs, needs)]
    wanted = [t for t in leaves if t is not None and t.requires_grad]
    if not wanted:
        return (None,) * len(inputs)
    with torch.enable_grad():
        outs = ssd_scan_plain(*leaves, chunk=chunk)
        used = [(o, c) for o, c in zip(outs, (dy, dstate)) if c is not None]
        grads = iter(torch.autograd.grad([o for o, _ in used],
                                         wanted, [c for _, c in used],
                                         allow_unused=True))
    out = []
    for t in leaves:
        if t is None or not t.requires_grad:
            out.append(None)
            continue
        g = next(grads)
        out.append(torch.zeros_like(t) if g is None else g)
    return tuple(out)


class SsdScanFn(torch.autograd.Function):
    """Trainable SSD scan: ``SsdScanFn.apply(x, dt, a_log, b, c, d_skip,
    initial_state, chunk)`` returns (y, final_state) as :func:`ssd_scan`.

    The forward is :func:`ssd_scan`'s launch: ``csrc/ssd_scan.cu`` on a
    CUDA tensor (``ssd_mma_kernel`` in bfloat16, 64-position chunks), or
    a raise; the plain version on a CPU tensor.  x, b and c reach the
    kernel as the views they are, without a copy.  The forward saves its
    inputs; the backward returns :func:`ssd_scan_grad`: the gradient of
    the reference's float32 chunked numerics at its chunk rule, so on the
    card the forward and the backward follow different roundings (the
    kernel's bf16 tensor-core products against float32 tensor ops).  Not a
    fallback: on the card the forward always launches the kernel."""

    @staticmethod
    def forward(ctx, x, dt, a_log, b, c, d_skip, initial_state=None,
                chunk: int = CHUNK):
        y, state = _scan(x, dt, a_log, b, c, d_skip, initial_state,
                         int(chunk))
        ctx.save_for_backward(x, dt, a_log, b, c, d_skip, initial_state)
        ctx.chunk = int(chunk)
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        grads = ssd_scan_grad(*ctx.saved_tensors, dy, dstate, ctx.chunk,
                              ctx.needs_input_grad[:7])
        return (*grads, None)
