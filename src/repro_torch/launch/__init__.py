"""Entry points of the port: ``python -m repro_torch.launch.serve``,
``python -m repro_torch.launch.train`` and
``python -m repro_torch.launch.cluster``."""

from .serve import Generation, ServeConfig, generate, run_serving
from .train import Trainer, TrainerConfig, TrainResult

__all__ = ["Generation", "ServeConfig", "generate", "run_serving",
           "Trainer", "TrainerConfig", "TrainResult"]
