"""PyTorch and CUDA port of the replication planner (``repro``'s twin).

The package runs the planning path — ``ClusterSpec`` + ``Objective`` ->
``SimulatedPlanner.plan()`` -> ``Plan`` — on an NVIDIA GPU, through
hand-written CUDA kernels for the sojourn scan (``sojourn_cells``), the
k-of-N selection (``coded_cells``) and the coded combine (``combine``).
It imports ``torch`` and numpy, never ``jax`` and nothing of ``repro``.

Device rule: every entry point takes ``device=None``, which means
``"cuda"`` and raises ``RuntimeError`` when no card is visible; the CPU
runs only when asked for (``device="cpu"``), through the kernels' plain
PyTorch versions.
"""

from .device import device_name, resolve_device

__all__ = ["device_name", "resolve_device"]
