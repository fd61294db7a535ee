"""Entry points of the port: ``python -m repro_torch.launch.serve``."""

from .serve import Generation, ServeConfig, generate, run_serving

__all__ = ["Generation", "ServeConfig", "generate", "run_serving"]
