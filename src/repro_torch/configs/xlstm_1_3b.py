"""xLSTM 1.3B [arXiv:2405.04517]: 48 blocks, d_model 2048, mLSTM:sLSTM 7:1.

d_ff=0 per the assignment: xLSTM blocks carry their own up/down projections
(mLSTM pre-up-projection x2, sLSTM post-up-projection 4/3) instead of a separate
FFN.  4 heads with GQA kv=4 (i.e. MHA at the memory level).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    # xLSTM[7:1]: one sLSTM block per 7 mLSTM blocks, period 8 (48 = 6 * 8).
    block_pattern=("mlstm",) * 7 + ("slstm",),
    rope=False,
    mlstm_chunk=256,
)

SMOKE_CONFIG = ModelConfig(
    name="xlstm-smoke",
    family="ssm",
    num_layers=4,
    d_model=64,
    num_heads=2,
    num_kv_heads=2,
    d_ff=0,
    vocab_size=256,
    block_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
    rope=False,
    mlstm_chunk=16,
)
