"""Sojourn/policy cell sweep and k-of-N coded cells on one device.

``kernel`` holds the CUDA wrappers and their plain PyTorch versions;
``ops`` is the seam the simulator sweeps call.
"""

from .kernel import (
    KIND_CLONE,
    KIND_HEDGED,
    KIND_NONE,
    KIND_RELAUNCH,
    coded_cells,
    coded_cells_plain,
    sojourn_cells,
    sojourn_cells_plain,
)
from .ops import (
    coded_completion_cells,
    hedge_mask,
    needs_resolve,
    policy_kind_code,
    sojourn_policy_cells,
)

__all__ = [
    "KIND_NONE",
    "KIND_CLONE",
    "KIND_RELAUNCH",
    "KIND_HEDGED",
    "coded_cells",
    "coded_cells_plain",
    "sojourn_cells",
    "sojourn_cells_plain",
    "coded_completion_cells",
    "hedge_mask",
    "needs_resolve",
    "policy_kind_code",
    "sojourn_policy_cells",
]
