"""Whisper-medium: encoder-decoder; conv frontend STUBBED to precomputed
frame embeddings (B, T, frontend_dim).

[arXiv:2212.04356] 24L (each stack) d_model=1024 16H d_ff=4096 vocab=51865.
LayerNorm + GELU + biases everywhere, sinusoidal/learned positions (no RoPE).
Decode shapes exercise the DECODER (self-attn KV cache + cached cross-KV).
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,  # per stack: 24 encoder + 24 decoder
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    qkv_bias=True,
    mlp_bias=True,
    attn_out_bias=True,
    norm="layernorm",
    activation="gelu",
    use_rope=False,
    tie_embeddings=True,  # whisper ties decoder input/output embeddings
    enc_dec=True,
    frontend="frames",
    frontend_dim=128,  # stubbed mel/conv output dim
    subquadratic=False,
)
