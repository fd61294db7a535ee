"""Zamba2-7B: Mamba2 backbone + shared full-attention block.

[arXiv:2411.15242] 81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000,
ssm_state=64.  One shared-weight attention+MLP block is applied after every
6th Mamba2 block (13 applications over 81 layers + 3 trailing SSM blocks).
"""

from .base import ArchConfig, HybridConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    norm="rmsnorm",
    activation="swiglu",
    rope_theta=10_000.0,
    ssm=SSMConfig(
        state_dim=64,
        head_dim=64,
        expansion=2,
        conv_kernel=4,
        n_groups=1,
        chunk=128,
    ),
    hybrid=HybridConfig(attn_every=6),
    subquadratic=True,
)
