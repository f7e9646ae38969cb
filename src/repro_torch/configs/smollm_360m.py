"""SmolLM-360M [hf:HuggingFaceTB/SmolLM-360M]: llama-architecture small model."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    num_layers=32,
    d_model=960,
    num_heads=15,
    num_kv_heads=5,
    d_ff=2560,
    vocab_size=49152,
)

SMOKE_CONFIG = ModelConfig(
    name="smollm-smoke",
    family="dense",
    num_layers=2,
    d_model=60,      # keeps the 15-head/4-per-head flavour at tiny scale
    num_heads=3,
    num_kv_heads=1,
    d_ff=160,
    vocab_size=256,
)
