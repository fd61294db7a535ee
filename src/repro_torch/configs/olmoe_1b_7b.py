"""OLMoE-1B-7B: 64 experts, top-8, fine-grained d_expert=1024.

[arXiv:2409.02060; hf:allenai/OLMoE-1B-7B-0924] 16L d_model=2048 16H
(kv=16, MHA) d_ff=1024(per expert) vocab=50304, MoE 64e top-8.
"""

from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    norm="rmsnorm",
    activation="swiglu",
    rope_theta=10_000.0,
    moe=MoEConfig(n_experts=64, top_k=8, d_expert=1024, n_shared=0),
    subquadratic=False,
)
