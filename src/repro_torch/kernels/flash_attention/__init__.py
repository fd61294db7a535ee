"""Flash attention (prefill): the CUDA wrapper and its plain version."""

from .ops import flash_attention, flash_attention_plain, repeat_kv

__all__ = ["flash_attention", "flash_attention_plain", "repeat_kv"]
