"""Qwen2-0.5B: GQA kv=2 with QKV bias, tied embeddings.

[arXiv:2407.10671; hf:Qwen/Qwen2-0.5B] 24L d_model=896 14H (GQA kv=2)
d_ff=4864 vocab=151936.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151936,
    qkv_bias=True,
    norm="rmsnorm",
    activation="swiglu",
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)
