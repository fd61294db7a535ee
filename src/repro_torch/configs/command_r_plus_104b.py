"""Cohere Command R+ (104B): parallel attention/FFN blocks, no biases,
LayerNorm (non-RMS), tied embeddings, GQA kv=8.

[hf:CohereForAI/c4ai-command-r-plus] 64L d_model=12288 96H (GQA kv=8)
d_ff=33792 vocab=256000.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=33792,
    vocab_size=256000,
    qkv_bias=False,
    parallel_block=True,  # Cohere: x + attn(ln(x)) + mlp(ln(x))
    norm="layernorm",
    activation="swiglu",
    rope_theta=75_000_000.0,
    tie_embeddings=True,
)
