"""DeepSeekMoE-16B: fine-grained experts, 2 shared + 64 routed top-6,
first layer dense.

[arXiv:2401.06066; hf:deepseek-ai/deepseek-moe-16b-base] 28L d_model=2048
16H (MHA) d_ff=1408(per expert) vocab=102400, MoE 64e top-6 + 2 shared.
Dense first-layer FFN width = 2 shared + 6 routed equivalents ~ 10944; we use
8 * d_expert = 11264 (8 expert-equivalents) for the dense layer, matching the
activated-expert budget.
"""

from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=11264,  # dense layer-0 FFN width (8 expert-equivalents)
    vocab_size=102400,
    norm="rmsnorm",
    activation="swiglu",
    rope_theta=10_000.0,
    moe=MoEConfig(
        n_experts=64,
        top_k=6,
        d_expert=1408,
        n_shared=2,
        first_layer_dense=True,
    ),
    subquadratic=False,
)
