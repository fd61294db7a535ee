"""InternVL2-76B backbone: InternViT frontend (stubbed) + InternLM2-76B LM.

[arXiv:2404.16821] 80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.
The modality frontend is a STUB: input_specs() supplies precomputed patch
embeddings (n_patches x frontend_dim) which a learned MLP projects into the
token stream (the transformer BACKBONE is what the cells exercise).
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    qkv_bias=False,
    norm="rmsnorm",
    activation="swiglu",
    rope_theta=1_000_000.0,
    frontend="patch",
    frontend_dim=1024,  # stubbed InternViT output dim (pre-projector)
    n_patches=256,
    subquadratic=False,
)
