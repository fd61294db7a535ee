"""The port's synthetic token pipeline (numpy only)."""

from .pipeline import TokenPipeline, make_batch_shapes

__all__ = ["TokenPipeline", "make_batch_shapes"]
