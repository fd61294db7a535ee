"""Mamba-2 SSD chunked scan: the CUDA wrapper, its trainable form, its
plain version and the sequential oracle."""

from .ops import (CHUNK, SsdScanFn, effective_chunk, ssd_scan, ssd_scan_grad,
                  ssd_scan_plain, ssd_sequential)

__all__ = ["CHUNK", "SsdScanFn", "effective_chunk", "ssd_scan",
           "ssd_scan_grad", "ssd_scan_plain", "ssd_sequential"]
