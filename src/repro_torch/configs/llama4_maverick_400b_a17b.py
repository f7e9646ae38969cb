"""Llama-4 Maverick 400B-A17B [arXiv/unverified]: interleaved MoE (1 dense : 1
MoE per pair), 128 routed experts top-1.  ~400B total / ~17B active.

Pure-bf16 optimizer state + bf16 params so that train-state bytes/device fit
v5e HBM at 256 chips (see DESIGN.md §Hardware-adaptation).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    block_pattern=("attn", "moe"),   # early-fusion interleaved MoE
    num_experts=128,
    top_k=1,
    param_dtype="bfloat16",
    optimizer_dtype="bfloat16",
)

SMOKE_CONFIG = ModelConfig(
    name="llama4-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=96,
    vocab_size=256,
    block_pattern=("attn", "moe"),
    num_experts=8,
    top_k=1,
)
