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
trainable form.  Its forward is the same launch, which on a CUDA tensor
also writes the float32 state before each 64-position chunk (B, H, nc,
N, P); inference passes no such buffer and runs nothing more.  Its
backward, on a CUDA tensor, launches ``csrc/ssd_scan_bwd.cu`` (or
raises): from those saved states, in bfloat16 three launches (a float32
reverse scan of the state cotangent over the chunks, one block a (head,
row), which leaves each chunk its dS'; then every chunk's gradients on
their own, one block a (head, chunk, row); then the group sums of dB and
dC in head order), in float32 one reverse walk a (head, row); dx, ddt,
dB and dC (per head in float32, summed over each group's heads here) and
the parts of da_log and dd_skip (a chunk's in bfloat16, a row's in
float32), summed here over the chunks and the batch rows in a fixed
order (no atomics: two passes are bit-equal).  On a
CPU tensor the backward is :func:`ssd_scan_grad`, the plain backward
(autograd through a recompute of :func:`ssd_scan_plain`), which is also
the card's oracle in ``chip_smoke.py``.  The reference has no backward
kernel: its training forward differentiates the XLA twin.

:func:`ssd_sequential` is the reference's step-by-step oracle.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build

__all__ = ["CHUNK", "KERNEL_CHUNK", "SsdScanFn", "effective_chunk",
           "expand_groups", "ssd_scan", "ssd_scan_grad", "ssd_scan_grad_work",
           "ssd_scan_plain", "ssd_scan_work", "ssd_sequential"]

CHUNK = 128  # the reference's default chunk (zamba2's SSMConfig.chunk)
KERNEL_CHUNK = 64  # the kernels' own chunk (csrc/ssd_scan.cu, ssd_scan_bwd.cu)
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


def ssd_scan_grad_work(bs: int, s: int, h: int, g: int, p: int, n: int,
                       itemsize: int = 2, initial_state: bool = False,
                       dstate: bool = False) -> tuple[float, float]:
    """(operations, bytes) of one backward call, the minimal work of the
    chunked gradient at the kernel's chunk L = 64 (nc = ceil(S / 64)): a
    (batch row, head, chunk) forms G = C B^T, Q = dy x^T, W^T dy, M^T C
    and M B (2 L^2 (3 N + 2 P)) and the four state products x dS'^T,
    B dS', dy S_k^T and C^T dy (8 L N P); x, b, c and dy read once in
    their dtype, dt, a_log and d_skip, the float32 chunk states the forward
    saved and the final state's cotangent if given; dx, db and dc written
    in their dtype, ddt, da_log and d_skip's gradient, and the initial
    state's if one was given.  The kernel's bf16 hi + lo products and its
    per-head dB / dC partials are left out.  The bound of the kernel table
    and the roofline's count of a call."""
    cl = KERNEL_CHUNK
    nc = -(-s // cl)
    flops = (2.0 * bs * h * nc
             * (cl * cl * (3 * n + 2 * p) + 4 * cl * n * p))
    state = bs * h * n * p * 4
    act = itemsize * (2 * bs * s * h * p + 2 * bs * s * g * n)  # x, dy; b, c
    nbytes = (act + 4 * (bs * s * h + 2 * h)  # inputs; dt, a_log, d_skip
              + nc * state + (state if dstate else 0)  # chunk states; dstate
              + act - itemsize * bs * s * h * p  # dx, db, dc
              + 4 * (bs * s * h + 2 * h)  # ddt, da_log, dd_skip
              + (state if initial_state else 0))
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


def _scan(x, dt, a_log, b, c, d_skip, initial_state, chunk: int,
          with_states: bool = False):
    """The kernel on a CUDA tensor, the plain version on a CPU one.  With
    ``with_states`` returns (y, state, chunk states): the float32 state
    before each of the kernel's chunks, from the kernel on a CUDA tensor
    and None elsewhere (the CPU and meta backwards do not read it)."""
    _check(x, dt, a_log, b, c, d_skip, initial_state)
    dev = x.device
    if dev.type == "cpu" or (dev.type == "meta" and _build.meta_runs_plain()):
        out = ssd_scan_plain(x, dt, a_log, b, c, d_skip, initial_state, chunk)
        return (*out, None) if with_states else out
    bs, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if dev.type == "meta":
        _build.note_meta_work("ssd_scan", *ssd_scan_work(
            bs, s, h, g, p, n, x.element_size(), initial_state is not None,
            chunk))
        out = (torch.empty(x.shape, dtype=x.dtype, device=dev),
               torch.empty((bs, h, n, p), dtype=torch.float32, device=dev))
        return (*out, None) if with_states else out
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for name, t in (("x", x), ("b", b), ("c", c)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    lib = _build.load("ssd_scan")
    y = torch.empty(x.shape, dtype=x.dtype, device=dev)
    state = torch.empty((bs, h, n, p), dtype=torch.float32, device=dev)
    nc = -(-s // KERNEL_CHUNK)
    states = (torch.empty((bs, h, nc, n, p), dtype=torch.float32, device=dev)
              if with_states else None)
    ptr = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())  # noqa: E731
    code = lib.ssd_scan_launch(
        ptr(x), ptr(dt), ptr(a_log), ptr(b), ptr(c), ptr(d_skip),
        ptr(initial_state), ptr(y), ptr(state), ptr(states), bs, s, h, g, p,
        n, DTYPES[x.dtype], x.stride(0), x.stride(1), b.stride(0),
        b.stride(1),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _build.check(lib, code, "ssd_scan launch")
    _build.count_launch("ssd_scan")
    return (y, state, states) if with_states else (y, state)


def _scan_grad(x, dt, a_log, b, c, d_skip, initial_state, states, dy,
               dstate, chunk: int, needs):
    """The seven gradients by device, with the forwards' rule: the plain
    backward on a CPU tensor; on a meta tensor the needed gradients'
    shapes and the backward kernel's work noted (in
    ``_build.plain_on_meta``, the plain backward's ops); on a CUDA tensor
    the backward kernel, or a raise; anything else raises."""
    dev = x.device
    if dev.type == "cpu" or (dev.type == "meta" and _build.meta_runs_plain()):
        return ssd_scan_grad(x, dt, a_log, b, c, d_skip, initial_state, dy,
                             dstate, chunk, needs)
    inputs = (x, dt, a_log, b, c, d_skip, initial_state)
    if not any(nd and t is not None for t, nd in zip(inputs, needs)):
        return (None,) * len(inputs)
    bs, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if dev.type == "meta":
        _build.note_meta_work("ssd_scan_bwd", *ssd_scan_grad_work(
            bs, s, h, g, p, n, x.element_size(), initial_state is not None,
            dstate is not None))
        return tuple(None if t is None or not nd else torch.empty_like(t)
                     for t, nd in zip(inputs, needs))
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    nc = -(-s // KERNEL_CHUNK)
    if states is None or tuple(states.shape) != (bs, h, nc, n, p):
        raise ValueError("the backward kernel needs the forward's chunk "
                         f"states of shape {(bs, h, nc, n, p)}")
    dy = (torch.zeros(x.shape, dtype=x.dtype, device=dev) if dy is None
          else dy.to(x.dtype).contiguous())
    if dstate is not None:
        dstate = dstate.float().contiguous()
        if dstate.data_ptr() % 16:  # the kernel reads it by 16 bytes
            dstate = dstate.clone()
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty(x.shape, dtype=x.dtype, device=dev)
    ddt = torch.empty((bs, s, h), **f32)
    dbh = torch.empty((bs, s, h, n), **f32)
    dch = torch.empty((bs, s, h, n), **f32)
    # da_log's and dd_skip's parts: one a chunk in bfloat16, one a batch
    # row in float32; bfloat16 also takes the reverse scan's float32 carry
    # (each chunk's dS') and returns dB and dC summed over each group's
    # heads in head order and da_log's and dd_skip's sums (float32 leaves
    # those sums to this function)
    bf16 = x.dtype == torch.bfloat16
    parts = nc if bf16 else 1
    da_part = torch.empty((bs, h, parts), **f32)
    dd_part = torch.empty((bs, h, parts), **f32)
    dinit = torch.empty((bs, h, n, p), **f32)
    carry = db = dc = da = dd = None
    if bf16:
        carry = torch.empty((bs, h, nc, n, p), **f32)
        db = torch.empty((bs, s, g, n), dtype=b.dtype, device=dev)
        dc = torch.empty((bs, s, g, n), dtype=b.dtype, device=dev)
        da = torch.empty((h,), **f32)
        dd = torch.empty((h,), **f32)
    lib = _build.load("ssd_scan_bwd")
    ptr = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())  # noqa: E731
    code = lib.ssd_scan_bwd_launch(
        ptr(x), ptr(dt), ptr(a_log), ptr(b), ptr(c), ptr(d_skip),
        ptr(states), ptr(dy), ptr(dstate), ptr(dx), ptr(ddt), ptr(dbh),
        ptr(dch), ptr(da_part), ptr(dd_part), ptr(dinit), ptr(carry),
        ptr(db), ptr(dc), ptr(da), ptr(dd), bs, s, h, g, p, n,
        DTYPES[x.dtype], x.stride(0), x.stride(1), b.stride(0), b.stride(1),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _build.check(lib, code, "ssd_scan_bwd launch")
    _build.count_launch("ssd_scan_bwd")

    def group_sum(t):  # per-head (B, S, H, N) -> (B, S, G, N), fixed order
        return t.view(bs, s, g, h // g, n).sum(dim=3).to(b.dtype)

    if not bf16:
        db, dc = group_sum(dbh), group_sum(dch)
        da, dd = da_part.sum(dim=2).sum(dim=0), dd_part.sum(dim=2).sum(dim=0)
    grads = (dx, ddt, da, db, dc, dd, dinit)
    return tuple(None if t is None or not nd else gr
                 for t, nd, gr in zip(inputs, needs, grads))


def ssd_scan_grad(x, dt, a_log, b, c, d_skip, initial_state, dy, dstate,
                  chunk: int = CHUNK, needs=(True,) * 7):
    """The gradients of :func:`ssd_scan_plain` at these inputs for the
    cotangents ``dy`` (of y, in x's dtype) and ``dstate`` (of the final
    state, float32), either None where its output is not used: (dx, ddt,
    da_log, db, dc, dd_skip, dinitial_state), each None where ``needs``
    says so (or, for the initial state, where none was given).  The plain
    backward: the CPU's, the tests', and the card's oracle in
    ``chip_smoke.py`` (on the card :class:`SsdScanFn` launches the
    backward kernel instead).

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
    CUDA tensor (``ssd_mma_kernel`` in bfloat16, 64-position chunks),
    which also writes the state before each chunk, or a raise; the plain
    version on a CPU tensor.  x, b and c reach the kernel as the views
    they are, without a copy.  The forward saves its inputs and the chunk
    states.  The backward dispatches as the forward does: on a CUDA tensor
    the backward kernel (``csrc/ssd_scan_bwd.cu``, one count of
    ``ssd_scan_bwd`` a call), or a raise; on a CPU tensor
    :func:`ssd_scan_grad`, the gradient of the reference's float32 chunked
    numerics at its chunk rule; on a meta tensor the kernel's work noted.
    Not a fallback: on the card both directions always launch kernels."""

    @staticmethod
    def forward(ctx, x, dt, a_log, b, c, d_skip, initial_state=None,
                chunk: int = CHUNK):
        y, state, states = _scan(x, dt, a_log, b, c, d_skip, initial_state,
                                 int(chunk), with_states=True)
        ctx.save_for_backward(x, dt, a_log, b, c, d_skip, initial_state,
                              states)
        ctx.chunk = int(chunk)
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        *inputs, states = ctx.saved_tensors
        grads = _scan_grad(*inputs, states, dy, dstate, ctx.chunk,
                           ctx.needs_input_grad[:7])
        return (*grads, None)
