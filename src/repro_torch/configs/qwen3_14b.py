"""Qwen3-14B [hf:Qwen/Qwen3-14B]: dense GQA decoder with qk-norm."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=17408,
    vocab_size=151936,
    qk_norm=True,
)

SMOKE_CONFIG = ModelConfig(
    name="qwen3-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    qk_norm=True,
)
