"""xLSTM-350M: 24 blocks, 21 mLSTM + 3 sLSTM (7:1 ratio), no separate FFN
(d_ff=0; the blocks carry their own up/down projections).

[arXiv:2405.04517] 24L d_model=1024 4H d_ff=0 vocab=50304.

Sub-quadratic: recurrent state decode -> runs the long_500k cell.
mLSTM uses the chunkwise stabilized exponential-gating form; sLSTM keeps
the paper's per-head (block-diagonal) recurrent memory mixing, one step at
a time (``repro_torch.models.xlstm``).
"""

from .base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    norm="rmsnorm",
    use_rope=False,
    ssm=SSMConfig(
        state_dim=256,  # mLSTM qk dim per head
        head_dim=512,  # v dim per head (2x expansion / 4 heads)
        expansion=2,
        conv_kernel=4,
        chunk=128,
        slstm_layers=(7, 15, 23),  # 7:1 mLSTM:sLSTM ratio over 24 blocks
    ),
    subquadratic=True,
)
