"""IBM Granite-34B-Code: llama-arch with MQA (kv=1).

[arXiv:2405.04324; hf] 88L d_model=6144 48H (MQA kv=1) d_ff=24576 vocab=49152.

One KV head serves all 48 query heads: the attention kernels read it in
place for the whole group (``decode_attention`` takes groups of up to
64).
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    qkv_bias=False,
    mlp_bias=True,  # granite code models use biases in MLP
    norm="layernorm",
    activation="gelu",
    rope_theta=10_000.0,
    tie_embeddings=True,
)
