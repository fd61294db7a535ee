"""Encode/decode combine for coded computation, on a device.

Coding is only a win if its overhead is MEASURED, not assumed free: a
coded plan pays an encode (coefficient-combine of the data blocks before
dispatch) and a decode (weight-combine of the first k responses) that
replication never pays.  ``kernel`` holds the ``combine`` CUDA wrapper and
its plain twin; ``ops`` the seam and :func:`~.ops.measure_coding_overhead`.
"""

from .kernel import COMBINE_RTOL, combine, combine_plain
from .ops import (
    coded_combine,
    decode_combine,
    encode_matrix,
    measure_coding_overhead,
)

__all__ = [
    "COMBINE_RTOL",
    "combine",
    "combine_plain",
    "coded_combine",
    "decode_combine",
    "encode_matrix",
    "measure_coding_overhead",
]
