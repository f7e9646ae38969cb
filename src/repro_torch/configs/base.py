"""Model / run configuration and the --arch registry."""

from __future__ import annotations

import dataclasses
import importlib
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads

    # Block pattern, cycled over layers (period must divide num_layers).
    # kinds: "attn" | "moe" | "mlstm" | "slstm" | "rglru" | "local_attn"
    block_pattern: tuple = ("attn",)

    # attention details
    rope: bool = True
    mrope: bool = False              # M-RoPE (qwen2-vl): 3-section rotary
    qk_norm: bool = False
    local_window: int = 0            # window for "local_attn" blocks
    # recurrent details
    rglru_conv_width: int = 4
    mlstm_chunk: int = 256           # chunkwise-parallel mLSTM chunk length
    # moe details
    num_experts: int = 0
    top_k: int = 0
    # encoder-decoder
    encoder_layers: int = 0          # >0 -> enc-dec; decoder uses num_layers
    # modality frontend stub: "tokens" or "embeddings"
    input_mode: str = "tokens"

    # attention implementation: "flash" (chunked online-softmax; O(bq*bk) mem)
    # or "naive" (materialized S^2 scores; the un-optimized baseline)
    attn_impl: str = "flash"
    flash_block_q: int = 1024
    flash_block_k: int = 1024

    # numerics / memory policy
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    optimizer_dtype: str = "float32"  # "bfloat16" => pure-bf16 optimizer state
    kv_cache_dtype: str = "bfloat16"  # "int8" => quantized KV cache
    remat: str = "block"              # "none" | "block" (checkpoint each block)

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        assert self.num_layers % len(self.block_pattern) == 0, (
            self.name, "block pattern period must divide num_layers")

    @property
    def sub_quadratic(self) -> bool:
        """True if no block attends globally with O(S^2) cost (long_500k rule).
        'moe' blocks carry full attention; 'local_attn' is windowed."""
        return all(k not in ("attn", "moe") for k in self.block_pattern)

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    def padded_vocab(self, multiple: int = 512) -> int:
        v = self.vocab_size
        return ((v + multiple - 1) // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

ARCH_IDS: tuple[str, ...] = (
    "xlstm-1.3b",
    "recurrentgemma-9b",
    "phi3-medium-14b",
    "smollm-360m",
    "stablelm-12b",
    "qwen3-14b",
    "moonshot-v1-16b-a3b",
    "llama4-maverick-400b-a17b",
    "seamless-m4t-large-v2",
    "qwen2-vl-72b",
)

_MODULES = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCH_IDS}")
    mod = importlib.import_module(_MODULES[arch])
    return mod.CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    mod = importlib.import_module(_MODULES[arch])
    return mod.SMOKE_CONFIG


def cell_is_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """The assignment's skip rules: long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "skipped: pure full attention is O(S^2) at 512k"
    return True, "ok"
