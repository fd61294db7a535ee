"""The benchmark's yardstick: the chip's peaks and the work of each
hand-written kernel a roofline metric reads (a family's model FLOPs are in
``models/<family>.py``).

Everything here is frozen with the benchmark.  The kernel work functions
are copies of the port's ``flash_attention_work``,
``flash_attention_grad_work``, ``ssd_scan_work`` and ``ssd_scan_grad_work``
as they stood when the benchmark was written (``bench/tests`` holds them
equal at the cells' shapes); the benchmark never calls the port's own, so
a change there cannot move the count a kernel is judged by.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at the 700 W
# power limit: bf16 tensor-core peak and HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12

SSD_CHUNK = 128  # the chunk of the port's Mamba-2 blocks (its SSMConfig.chunk)
SSD_KERNEL_CHUNK = 64  # the SSD kernels' own chunk


def bound_seconds(flops: float, nbytes: float) -> float:
    """The least time the chip could take for (flops, bytes)."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S)


def visible_pairs(sq: int, skv: int, causal: bool, q_offset: int = 0) -> int:
    """(query, key) pairs a head sees: all, or under the causal mask those
    with key <= query + q_offset."""
    if not causal:
        return sq * skv
    full = min(max(skv - q_offset, 0), sq)
    return full * q_offset + full * (full + 1) // 2 + (sq - full) * skv


def flash_attention_work(b, sq, skv, h, kv, d, causal, q_offset=0,
                         itemsize=2):
    """(operations, bytes) of one flash forward: 4 d a visible pair and
    head; q, k, v read once, the output written once."""
    flops = 4.0 * b * h * d * visible_pairs(sq, skv, causal, q_offset)
    nbytes = itemsize * (2 * b * sq * h * d + 2 * b * skv * kv * d)
    return flops, float(nbytes)


def flash_attention_grad_work(b, sq, skv, h, kv, d, causal, q_offset=0,
                              itemsize=2):
    """(operations, bytes) of one flash backward, the minimal work: 10 d a
    visible pair and head; q, k, v, out, dO read once, the float32 LSE,
    dq, dk, dv written once."""
    flops = 10.0 * b * h * d * visible_pairs(sq, skv, causal, q_offset)
    q_elems, kv_elems = b * sq * h * d, b * skv * kv * d
    nbytes = (itemsize * (3 * q_elems + 2 * kv_elems)
              + 4 * b * h * sq
              + itemsize * (q_elems + 2 * kv_elems))
    return flops, float(nbytes)


def ssd_effective_chunk(s: int, chunk: int = SSD_CHUNK) -> int:
    eff = min(chunk, s)
    return s if s % eff else eff


def ssd_scan_work(bs, s, h, g, p, n, itemsize=2, initial_state=False,
                  chunk=SSD_CHUNK):
    """(operations, bytes) of one SSD scan forward at the reference's chunk
    rule."""
    cl = ssd_effective_chunk(s, chunk)
    flops = (2.0 * bs * h * (s // cl)
             * (cl * cl * (n + p) + 2 * cl * n * p))
    state = bs * h * n * p * 4
    nbytes = (itemsize * (2 * bs * s * h * p + 2 * bs * s * g * n)
              + 4 * (bs * s * h + 2 * h) + state * (2 if initial_state else 1))
    return flops, float(nbytes)


def ssd_scan_grad_work(bs, s, h, g, p, n, itemsize=2, initial_state=False,
                       dstate=False):
    """(operations, bytes) of one SSD scan backward, the minimal work at the
    kernel's chunk."""
    cl = SSD_KERNEL_CHUNK
    nc = -(-s // cl)
    flops = (2.0 * bs * h * nc
             * (cl * cl * (3 * n + 2 * p) + 4 * cl * n * p))
    state = bs * h * n * p * 4
    act = itemsize * (2 * bs * s * h * p + 2 * bs * s * g * n)
    nbytes = (act + 4 * (bs * s * h + 2 * h)
              + nc * state + (state if dstate else 0)
              + act - itemsize * bs * s * h * p
              + 4 * (bs * s * h + 2 * h)
              + (state if initial_state else 0))
    return flops, float(nbytes)
