"""Hand-written CUDA kernels of the port, their wrappers and plain twins.

``_build`` compiles ``csrc/*.cu`` with nvcc at first use and keeps the
per-kernel launch counters (:func:`launch_counts`,
:func:`reset_launch_counts`).
"""

from ._build import build_all, launch_counts, reset_launch_counts

__all__ = ["build_all", "launch_counts", "reset_launch_counts"]
