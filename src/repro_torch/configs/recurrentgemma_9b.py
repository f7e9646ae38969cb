"""RecurrentGemma-9B / Griffin [arXiv:2402.19427]: RG-LRU + local attention, 1:2.

38 layers isn't divisible by the 3-block Griffin period (rglru, rglru, local);
the published model runs the pattern cyclically with the tail truncated.  We use
period 2 x (rglru, rglru, local_attn) groups... 38 = 12*3 + 2: to keep the
scan-over-superblocks exact we follow the paper's repeating unit and pad the
layer count to the nearest multiple in the SMOKE config only; for the full
config we use 36 pattern layers + 2 trailing rglru layers folded as one extra
period of (rglru, rglru) -- expressed here as pattern period 19 over 38 layers:
(rglru, rglru, local) * 6 + (rglru,) -- exact for 38 = 2 * 19.
"""

from repro_torch.configs.base import ModelConfig

_PATTERN = (("rglru", "rglru", "local_attn") * 6 + ("rglru",))  # 19 blocks; 38 = 2*19

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,      # MQA in the local-attention blocks
    d_ff=12288,
    vocab_size=256000,
    block_pattern=_PATTERN,
    rope=True,
    local_window=2048,
    rglru_conv_width=4,
)

SMOKE_CONFIG = ModelConfig(
    name="recurrentgemma-smoke",
    family="hybrid",
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=1,
    d_ff=128,
    vocab_size=256,
    block_pattern=("rglru", "rglru", "local_attn"),
    rope=True,
    local_window=16,
    rglru_conv_width=4,
)
