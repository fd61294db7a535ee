"""Kernels: the flash attention forward launches' roofline bound over
their device time, in % (``kernels/flash_attention.json``)."""

import harness


def read(r):
    return harness.roofline_share(r, "flash_attention")
