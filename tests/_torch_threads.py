"""Caps torch's CPU threads in the test process.

Every ``tests/test_torch_*.py`` imports this module first.  Under pytest
with xdist each worker imports every test module while it collects, so
the cap holds for the whole worker process, the reference's tests that run
in it included.  Without it each worker's torch sizes its intra-op pool to
every core of the host, and six workers on an eight-core host ask for
about six times the cores there are: the run's wall grows with the
oversubscription, and the reference's live-cluster tests, whose worker
processes must answer heartbeats within 0.3 s, can miss them.

One intra-op thread a process, measured on an eight-core host with the
tier-1 command (``-n 6 --dist loadfile``): 1643 passed in 396 s at one
thread, 436 s at two, 1357 s uncapped; every port test passed at both
caps, so no result depends on the count.
"""

import torch

TORCH_THREADS = 1

torch.set_num_threads(TORCH_THREADS)
try:
    torch.set_num_interop_threads(1)
except RuntimeError:  # the inter-op pool already ran work in this process
    pass
