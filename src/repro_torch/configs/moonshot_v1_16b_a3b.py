"""Moonshot/Moonlight 16B-A3B [hf:moonshotai/Moonlight-16B-A3B]: MoE 64e top-6."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,            # per-expert FFN width
    vocab_size=163840,
    block_pattern=("moe",),
    num_experts=64,
    top_k=6,
)

SMOKE_CONFIG = ModelConfig(
    name="moonshot-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=64,
    vocab_size=256,
    block_pattern=("moe",),
    num_experts=8,
    top_k=2,
)
