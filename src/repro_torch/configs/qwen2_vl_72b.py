"""Qwen2-VL-72B [arXiv:2409.12191]: M-RoPE decoder backbone, dynamic resolution.

The vision frontend (ViT + patch merger) is a STUB per the assignment:
`input_specs()` supplies precomputed patch/text embeddings plus 3-component
M-RoPE position ids (temporal, height, width).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    mrope=True,
    input_mode="embeddings",
    kv_cache_dtype="int8",   # 80L x 32k decode cache: int8 to fit HBM
)

SMOKE_CONFIG = ModelConfig(
    name="qwen2vl-smoke",
    family="vlm",
    num_layers=2,
    d_model=96,
    num_heads=6,
    num_kv_heads=2,
    d_ff=192,
    vocab_size=256,
    mrope=True,
    input_mode="embeddings",
)
