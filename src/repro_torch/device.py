"""The device rule of the port.

Every entry point takes ``device=None``.  ``None`` means ``"cuda"``: the
port is written for the GPU, and a missing card is an error, never a quiet
move to the host.  The CPU runs only when the caller names it (the tests
do, with ``device="cpu"``).
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "device_name"]


def resolve_device(device=None) -> torch.device:
    """The torch device an entry point runs on.

    ``None`` and ``"cuda"`` require a visible CUDA device and raise
    ``RuntimeError`` without one; ``"cpu"`` (or a ``torch.device``) is taken
    as given.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; the port runs on the GPU by default "
            "(pass device='cpu' to run the plain PyTorch versions on the host)"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (expected cuda or cpu)")
    return dev


def device_name(device: torch.device) -> str:
    """Provenance label recorded on results and plans: 'cuda' or 'cpu'."""
    return torch.device(device).type
