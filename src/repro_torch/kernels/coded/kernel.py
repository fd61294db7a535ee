"""The coded encode/decode product: CUDA wrapper and plain twin.

:func:`combine` multiplies (R, K) float32 coefficients into (K, D) float32
blocks.  On a CUDA tensor it launches the tiled SGEMM of
``csrc/combine.cu`` (or raises); on a CPU tensor it runs
:func:`combine_plain`, a rank-1 update per coefficient column summed in K
order.  The two sum in different orders, so they agree within
``1e-5 * (|coeffs| @ |blocks|)`` elementwise, not bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

__all__ = ["combine", "combine_plain", "COMBINE_RTOL"]

# |kernel - plain| <= COMBINE_RTOL * (|coeffs| @ |blocks|), elementwise
COMBINE_RTOL = 1e-5


def combine_plain(coeffs: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    """(R, K) x (K, D) -> (R, D) as K rank-1 updates, summed in K order."""
    n_rows, k = coeffs.shape
    out = torch.zeros((n_rows, blocks.shape[1]), dtype=blocks.dtype,
                      device=blocks.device)
    for j in range(k):
        out = out + coeffs[:, j:j + 1] * blocks[j:j + 1, :]
    return out


def combine(coeffs: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    """(R, K) coefficient rows x (K, D) stacked blocks -> (R, D) float32."""
    if coeffs.dim() != 2 or blocks.dim() != 2:
        raise ValueError("coeffs and blocks must be 2-D")
    n_rows, k = coeffs.shape
    k2, d = blocks.shape
    if k != k2:
        raise ValueError(f"coeffs k={k} != blocks k={k2}")
    dev = blocks.device
    for name, t in (("coeffs", coeffs), ("blocks", blocks)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} has dtype {t.dtype}, expected float32")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dev.type == "cpu":
        return combine_plain(coeffs, blocks)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    lib = _build.load("combine")
    out = torch.empty((n_rows, d), dtype=torch.float32, device=dev)
    code = lib.combine_launch(
        ctypes.c_void_p(coeffs.data_ptr()), ctypes.c_void_p(blocks.data_ptr()),
        ctypes.c_void_p(out.data_ptr()), n_rows, k, d,
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    _build.check(lib, code, "combine launch")
    _build.count_launch("combine")
    return out
