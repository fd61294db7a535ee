"""Checkpointing of the port, in the reference's on-disk layout."""

from .checkpoint import Checkpointer, latest_step

__all__ = ["Checkpointer", "latest_step"]
