"""Entry points of the port: ``python -m repro_torch.launch.serve``,
``python -m repro_torch.launch.train``, ``python -m
repro_torch.launch.cluster`` and ``python -m repro_torch.launch.dryrun``
(policy, placements and the H100 roofline of every cell, counted on the
meta device); the production mesh shapes, the auto policy and the step
functions with their arguments' placements."""

from .mesh import dp_axes_of, production_mesh_shape, rdp_production_mesh_shape
from .policies import auto_policy
from .serve import Generation, ServeConfig, generate, run_serving
from .specs import input_specs, params_shapes
from .steps import make_decode_step, make_prefill_step, make_train_step
from .train import Trainer, TrainerConfig, TrainResult

__all__ = ["Generation", "ServeConfig", "generate", "run_serving",
           "Trainer", "TrainerConfig", "TrainResult",
           "auto_policy", "dp_axes_of", "input_specs", "make_decode_step",
           "make_prefill_step", "make_train_step", "params_shapes",
           "production_mesh_shape", "rdp_production_mesh_shape"]
