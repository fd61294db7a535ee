"""Device: the share of the profiled sub-window in which no device
operation ran, in %."""

import harness


def read(r):
    return harness.idle_share(r)
