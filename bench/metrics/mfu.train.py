"""Model step: a training step's model FLOPs (the yardstick's count
from the configuration's widths) over the host-clock window times the
chip's bf16 peak, in %."""

import harness


def read(r):
    return harness.model_flops_share(r)
