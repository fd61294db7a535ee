"""Flash attention (prefill): the CUDA wrapper, its trainable form (with a
backward kernel) and its plain versions."""

from .ops import (FlashAttentionFn, flash_attention, flash_attention_grad,
                  flash_attention_grad_work, flash_attention_plain,
                  repeat_kv)

__all__ = ["FlashAttentionFn", "flash_attention", "flash_attention_grad",
           "flash_attention_grad_work", "flash_attention_plain", "repeat_kv"]
