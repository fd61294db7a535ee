"""The port's H100 roofline: FLOPs and bytes of each step counted on the
meta device (``analysis``).  The reference's XLA HLO walker
(``hlo_cost``), its attention-kernel model (``kernel_model``, which
lowers XLA attention) and the hill-climb over their reports
(``hillclimb``) have no counterpart here."""

from .analysis import (CARD_BYTES, HBM_BW, PEAK_FLOPS, analyze_cell,
                       count_step, model_flops)

__all__ = ["CARD_BYTES", "HBM_BW", "PEAK_FLOPS", "analyze_cell",
           "count_step", "model_flops"]
