"""The port's H100 roofline: FLOPs and bytes of each step counted on the
meta device (``analysis``), its memory term from a walk of the aten ops
the step dispatches (``op_cost``, the counterpart of the reference's XLA
HLO walker ``hlo_cost``), the attention-kernel substitution model
(``kernel_model``) and the hill-climb over the dry-run's reports
(``hillclimb``)."""

from .analysis import (CARD_BYTES, HBM_BW, PEAK_FLOPS, analyze_cell,
                       count_step, model_flops)

__all__ = ["CARD_BYTES", "HBM_BW", "PEAK_FLOPS", "analyze_cell",
           "count_step", "model_flops"]
