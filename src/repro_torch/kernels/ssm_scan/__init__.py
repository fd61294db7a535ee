"""Mamba-2 SSD chunked scan: the CUDA wrapper, its plain version and the
sequential oracle."""

from .ops import (CHUNK, effective_chunk, ssd_scan, ssd_scan_plain,
                  ssd_sequential)

__all__ = ["CHUNK", "effective_chunk", "ssd_scan", "ssd_scan_plain",
           "ssd_sequential"]
