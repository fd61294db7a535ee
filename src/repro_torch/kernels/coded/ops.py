"""Coded encode/decode on a device, and the wall-clock overhead probe.

:func:`coded_combine` is the one seam both ends of a coded job go through:
encode is ``combine(G (n, k), blocks (k, d))`` before dispatch, decode is
``combine(W (k', m), responses (m, d))`` on the k-th completion.
:func:`measure_coding_overhead` times both (plus the host-side
decode-weight solve) on the requested device and returns seconds — the
numbers the planner writes into a ``CodingCandidate`` whose overheads were
left ``None``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ...core.coding import CodingCandidate, MDSCode
from ...core.gradient_coding import CyclicGradientCode
from ...device import resolve_device
from .kernel import combine

__all__ = [
    "coded_combine",
    "decode_combine",
    "encode_matrix",
    "measure_coding_overhead",
]


def coded_combine(coeffs, blocks, *, device=None) -> torch.Tensor:
    """(R, K) coefficient rows x (K, D) stacked blocks -> (R, D) coded rows.

    Host arrays are moved to ``device`` as float32 (the reference's
    device lane with ``jax_enable_x64`` off) and multiplied by the
    ``combine`` kernel (its plain twin on the CPU).
    """
    dev = resolve_device(device)
    coeffs = torch.as_tensor(np.asarray(coeffs)).to(dev, torch.float32)
    blocks = torch.as_tensor(np.asarray(blocks)).to(dev, torch.float32)
    return combine(coeffs.contiguous(), blocks.contiguous())


def decode_combine(weights, responses, *, device=None) -> torch.Tensor:
    """Decode-side combine: same kernel, (k', m) weights x (m, d) responses."""
    return coded_combine(weights, responses, device=device)


def encode_matrix(candidate, n_workers: int) -> np.ndarray:
    """The scheme's (n_workers, n_blocks) encode/coefficient matrix.

    * cyclic — Tandon coefficients over the N unit batches;
    * mds / poly — the real Vandermonde generator at Chebyshev nodes.
    """
    if not isinstance(candidate, CodingCandidate):
        raise TypeError(
            f"expected CodingCandidate, got {type(candidate).__name__}")
    k = candidate.k(n_workers)
    if candidate.scheme == "cyclic":
        return CyclicGradientCode(n_workers, candidate.s).coefficients()
    return MDSCode(n_workers, k).generator()


def _decode_solver(candidate, n_workers: int, gen: np.ndarray):
    """Host-side solve producing the decode weight matrix for the first-k
    completion subset (part of the measured decode cost)."""
    k = candidate.k(n_workers)
    alive = np.zeros(n_workers, dtype=bool)
    alive[:k] = True
    if candidate.scheme == "cyclic":
        code = CyclicGradientCode(n_workers, candidate.s)

        def solve():
            return code.decode_weights(alive)[None, :]  # (1, k)
    else:
        g_alive = gen[alive]

        def solve():
            return np.linalg.inv(g_alive)  # (k, k)
    return alive, solve


def _best_of(fn, repeats: int, dev: torch.device) -> float:
    best = np.inf
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        best = min(best, time.perf_counter() - t0)
    return float(best)


def measure_coding_overhead(
    candidate,
    n_workers: int,
    *,
    block_dim: int = 2048,
    repeats: int = 3,
    seed: int = 0,
    device=None,
) -> tuple[float, float]:
    """Wall-clock (encode_seconds, decode_seconds) of one coded job.

    Encode: the coefficient-combine over the data blocks before dispatch
    (doubled for ``poly``, which encodes both factors).  Decode: the
    weight solve for the first-k completion subset plus the combine over
    the k responses.  Min-of-``repeats`` after one warmup call; each timed
    call ends in ``torch.cuda.synchronize()`` on the GPU, so the time is
    the device's and not the enqueue's.
    """
    dev = resolve_device(device)
    gen = encode_matrix(candidate, n_workers)
    k_blocks = gen.shape[1]
    rng = np.random.default_rng(seed)
    blocks = rng.standard_normal((k_blocks, block_dim))
    n_encodes = 2 if candidate.scheme == "poly" else 1

    def encode():
        out = None
        for _ in range(n_encodes):
            out = coded_combine(gen, blocks, device=dev)
        return out

    encode()  # warmup (kernel load)
    enc = _best_of(encode, repeats, dev)

    alive, solve = _decode_solver(candidate, n_workers, gen)
    responses = gen[alive] @ blocks

    def decode():
        return decode_combine(solve(), responses, device=dev)

    decode()  # warmup
    dec = _best_of(decode, repeats, dev)
    return enc, dec
