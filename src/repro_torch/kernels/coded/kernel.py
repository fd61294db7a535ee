"""The coded encode/decode product: CUDA wrapper and plain twin.

:func:`combine` multiplies (R, K) float32 coefficients into (K, D) float32
blocks.  On a CUDA tensor it launches ``csrc/combine.cu`` (a strip kernel
for R <= 32, a tiled SGEMM otherwise; or raises); on a CPU tensor it runs
:func:`combine_plain`, a rank-1 update per coefficient column summed in K
order.  The kernels sum in K order too, but with fused multiply-adds, so
the two agree within ``1e-5 * (|coeffs| @ |blocks|)`` elementwise, not bit
for bit.
"""

from __future__ import annotations

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


_F32 = torch.float32


def _reject(coeffs: torch.Tensor, blocks: torch.Tensor) -> None:
    dev = blocks.device
    for name, t in (("coeffs", coeffs), ("blocks", blocks)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != _F32:
            raise TypeError(f"{name} has dtype {t.dtype}, expected float32")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def combine(coeffs: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    """(R, K) coefficient rows x (K, D) stacked blocks -> (R, D) float32.

    Each call checks its inputs as cheaply as it can: on the planner's
    shapes the call's host time, not the kernel, sets its wall time.
    """
    if coeffs.dim() != 2 or blocks.dim() != 2:
        raise ValueError("coeffs and blocks must be 2-D")
    n_rows, k = coeffs.shape
    k2, d = blocks.shape
    if k != k2:
        raise ValueError(f"coeffs k={k} != blocks k={k2}")
    if (coeffs.device != blocks.device or coeffs.dtype != _F32
            or blocks.dtype != _F32 or not coeffs.is_contiguous()
            or not blocks.is_contiguous()):
        _reject(coeffs, blocks)
    if not blocks.is_cuda:
        if blocks.device.type == "cpu":
            return combine_plain(coeffs, blocks)
        raise ValueError(f"unsupported device {blocks.device}")
    lib = _build.load("combine")
    out = blocks.new_empty((n_rows, d))
    # plain ints: the declared argtypes make them pointers.  The stream is
    # PyTorch's current one as a raw handle, through the private accessor
    # that CUDA builds of PyTorch 2.0 and later have (TorchInductor's code
    # calls it): it skips building a ``torch.cuda.Stream`` object on every
    # call (about 5 us)
    code = lib.combine_launch(
        coeffs.data_ptr(), blocks.data_ptr(), out.data_ptr(), n_rows, k, d,
        torch._C._cuda_getCurrentRawStream(blocks.get_device()))
    if code:
        _build.check(lib, code, "combine launch")
    _build.count_launch("combine")
    return out
