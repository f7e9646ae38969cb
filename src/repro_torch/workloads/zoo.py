"""Zoo workload generation: `ModelConfig` -> named `ConvLayer` sets.

Every matmul-shaped term in `repro_torch.models.flops` becomes a `ConvLayer` in the
standard GEMM-as-1x1-conv encoding (d_in -> C, d_out -> K, token tile -> P);
the one genuinely convolutional term (the rglru temporal conv) becomes a real
conv layer.  A per-block-kind extractor registry (`BLOCK_EXTRACTORS`) emits
`(role, layer, count)` items per block instance; assembly dedups identical
shapes (e.g. a Q and O projection when `num_heads * head_dim == d_model`, or
a dense FFN and a same-shaped MoE expert) by summing their counts, so the
searched set stays small (4-10 unique layers per model) while the counts keep
the full-model MACs bookkeeping exact.

The contract that keeps generated shapes provably consistent with the repo's
own cost math: `2 * sum(count * layer.macs)` must equal
`forward_flops(cfg, ZOO_SHAPE)` up to the *documented* non-matmul remainder
-- attention scores+PV at the 64-token tile (ctx averages 32), and a handful
of elementwise gate/normalizer terms.  Generation raises if coverage falls
outside `[1 - MACS_RTOL, 1]`; the measured per-model coverage ships in
`ZooWorkload.coverage` and is pinned by tests.

Extractor registry contract (for adding a block kind): an extractor takes the
`ModelConfig` and returns `[(role, ConvLayer, count_per_block), ...]` covering
every matmul term of the matching `_<kind>_flops_per_token` formula in
`repro_torch/models/flops.py` exactly, skipping only sub-quadratic terms -- then
the cross-check holds automatically for every model using that kind.
"""

from __future__ import annotations

import dataclasses
import functools

from repro_torch.configs.base import ARCH_IDS, ModelConfig, ShapeConfig, get_config
from repro_torch.models.flops import forward_flops
from repro_torch.timeloop.workloads import (_TOKENS, MODEL_LAYERS, ConvLayer, fc,
                                            merge_shapes)
from repro_torch.workloads.mla_decode import DECODE_SETS, decode_set

# The shape cell every zoo set is generated (and cross-checked) at: one
# 64-token training tile, matching the paper workloads' `_TOKENS` GEMM
# encoding. `forward_flops` at this shape uses tokens = 64 and causal average
# context 32.
ZOO_SHAPE = ShapeConfig(name="zoo_tile", seq_len=_TOKENS, global_batch=1,
                        kind="train")

# Measured non-matmul remainder across the 10-model zoo: 0.03%-0.54%, worst
# on smollm-360m (smallest d_model, so the skipped scores+PV and elementwise
# terms weigh the most); generation fails loudly outside [1 - MACS_RTOL, 1].
MACS_RTOL = 0.01

_Item = tuple[str, ConvLayer, int]


def _attn_items(cfg: ModelConfig, tokens: int = _TOKENS) -> list[_Item]:
    # proj = 2*D*(H + 2*KV)*hd + 2*H*hd*D; scores+pv (2*2*ctx*H*hd) skipped.
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return [
        ("attn_q", fc("attn_q", D, H * hd, tokens), 1),
        ("attn_kv", fc("attn_kv", D, KV * hd, tokens), 2),
        ("attn_o", fc("attn_o", H * hd, D, tokens), 1),
    ]


def _mlp_items(cfg: ModelConfig, tokens: int = _TOKENS) -> list[_Item]:
    # 6*D*d_ff = gated up + gate (2x) + down (1x).
    if not cfg.d_ff:
        return []
    D, F = cfg.d_model, cfg.d_ff
    return [
        ("mlp_up", fc("mlp_up", D, F, tokens), 2),
        ("mlp_down", fc("mlp_down", F, D, tokens), 1),
    ]


def _moe_items(cfg: ModelConfig) -> list[_Item]:
    # router = 2*D*E, experts = top_k * 6*D*d_ff (active experts only).
    D, E, k, F = cfg.d_model, cfg.num_experts, cfg.top_k, cfg.d_ff
    return [
        ("moe_router", fc("moe_router", D, E, _TOKENS), 1),
        ("moe_up", fc("moe_up", D, F, _TOKENS), 2 * k),
        ("moe_down", fc("moe_down", F, D, _TOKENS), k),
    ]


def _mlstm_items(cfg: ModelConfig) -> list[_Item]:
    # proj = 2*D*Din*2 + 2*Din*D + 3*2*Din*dh (+ 2*4*Din elementwise, skipped);
    # cell = 4*Lc*Din (intra-chunk, Lc = mlstm_chunk in train) + 6*dh*Din.
    D = cfg.d_model
    Din = 2 * D
    dh = Din // cfg.num_heads
    Lc = cfg.mlstm_chunk
    return [
        ("mlstm_in", fc("mlstm_in", D, Din, _TOKENS), 2),
        ("mlstm_out", fc("mlstm_out", Din, D, _TOKENS), 1),
        ("mlstm_qkv", fc("mlstm_qkv", Din, dh, _TOKENS), 3),
        ("mlstm_intra", fc("mlstm_intra", Lc, Din, _TOKENS), 2),
        ("mlstm_cell", fc("mlstm_cell", dh, Din, _TOKENS), 3),
    ]


def _slstm_items(cfg: ModelConfig) -> list[_Item]:
    # 4*2*D*D (gates) + 4*2*D*dh (recurrent) + 2*D*D (out) + 6*D*F (FFN);
    # fully matmul -- this extractor is exact.
    D = cfg.d_model
    dh = D // cfg.num_heads
    F = ((4 * D // 3 + 63) // 64) * 64
    return [
        ("slstm_gates", fc("slstm_gates", D, D, _TOKENS), 4),
        ("slstm_rec", fc("slstm_rec", D, dh, _TOKENS), 4),
        ("slstm_out", fc("slstm_out", D, D, _TOKENS), 1),
        ("slstm_ffn_up", fc("slstm_ffn_up", D, F, _TOKENS), 2),
        ("slstm_ffn_down", fc("slstm_ffn_down", F, D, _TOKENS), 1),
    ]


def _rglru_items(cfg: ModelConfig) -> list[_Item]:
    # 5*2*D*D (gate/proj matmuls) + 2*W*D temporal conv (+ 12*D elementwise,
    # skipped).  The conv is a real depthwise temporal conv over the token
    # axis: R = conv_width taps, K = d_model channels.
    D, W = cfg.d_model, cfg.rglru_conv_width
    conv = ConvLayer(name="rglru_conv", R=W, S=1, P=_TOKENS, Q=1, C=1, K=D)
    return [
        ("rglru_proj", fc("rglru_proj", D, D, _TOKENS), 5),
        ("rglru_conv", conv, 1),
    ]


BLOCK_EXTRACTORS = {
    "attn": lambda cfg: _attn_items(cfg) + _mlp_items(cfg),
    # local attention narrows the (skipped) scores context only; the
    # projections and FFN are identical to global attention.
    "local_attn": lambda cfg: _attn_items(cfg) + _mlp_items(cfg),
    "moe": lambda cfg: _attn_items(cfg) + _moe_items(cfg),
    "mlstm": _mlstm_items,
    "slstm": _slstm_items,
    "rglru": lambda cfg: _rglru_items(cfg) + _mlp_items(cfg),
}


@dataclasses.dataclass(frozen=True)
class ZooWorkload:
    """A generated workload set plus its MACs-vs-flops audit trail."""

    arch: str                       # dashed config id ("qwen3-14b")
    name: str                       # registry name ("qwen3_14b")
    layers: tuple[ConvLayer, ...]   # unique shapes, first-occurrence order
    counts: tuple[int, ...]         # full-model replication per layer
    total_macs: int                 # sum(count * layer.macs)
    model_flops: float              # forward_flops(cfg, ZOO_SHAPE)
    coverage: float                 # 2 * total_macs / model_flops


def _norm(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


ZOO_NAMES: tuple[str, ...] = tuple(_norm(a) for a in ARCH_IDS)
_ARCH_BY_NAME: dict[str, str] = {_norm(a): a for a in ARCH_IDS}


def generate_workload(arch: str, cfg: ModelConfig | None = None,
                      tolerance: float = MACS_RTOL) -> ZooWorkload:
    """Build (and MACs-cross-check) the workload set for one model config."""
    cfg = cfg if cfg is not None else get_config(arch)
    pattern = cfg.block_pattern
    if cfg.num_layers % len(pattern) != 0:
        raise ValueError(
            f"{arch}: num_layers={cfg.num_layers} not divisible by the "
            f"{len(pattern)}-entry block_pattern; counts would be fractional")
    per_entry = cfg.num_layers // len(pattern)

    name = _norm(arch)
    items: list[_Item] = []

    def add(role: str, layer: ConvLayer, count: int) -> None:
        items.append((role, layer, count))

    for kind in pattern:
        if kind not in BLOCK_EXTRACTORS:
            raise ValueError(
                f"{arch}: no extractor for block kind {kind!r}; known: "
                f"{sorted(BLOCK_EXTRACTORS)}")
        for role, layer, count in BLOCK_EXTRACTORS[kind](cfg):
            add(role, layer, count * per_entry)

    # Tied unembed: tokens * 2 * D * padded_vocab in the train shape.
    add("unembed", fc("unembed", cfg.d_model, cfg.padded_vocab(), _TOKENS), 1)

    if cfg.family == "encdec" and cfg.encoder_layers:
        # Encoder blocks run at the source tile S_src = max(S // 8, 16): a
        # genuinely smaller-token GEMM, kept as distinct `enc_*` shapes.
        s_src = max(ZOO_SHAPE.seq_len // 8, 16)
        for role, layer, count in (_attn_items(cfg, tokens=s_src)
                                   + _mlp_items(cfg, tokens=s_src)):
            add(f"enc_{role}", layer, count * cfg.encoder_layers)
        # Decoder cross-attention: flops.py counts Q/K/V projections but no
        # output projection (`cross` has no `2*H*hd*D` term) -- mirror that.
        for role, layer, count in _attn_items(cfg):
            if role != "attn_o":
                add(role, layer, count * cfg.num_layers)

    layers, counts = merge_shapes(name, items)
    total_macs = sum(c * l.macs for c, l in zip(counts, layers))
    flops = forward_flops(cfg, ZOO_SHAPE)
    coverage = 2.0 * total_macs / flops
    if not (1.0 - tolerance <= coverage <= 1.0 + 1e-9):
        raise ValueError(
            f"zoo workload {name}: extracted MACs cover {coverage:.4f} of "
            f"forward_flops (2*{total_macs} vs {flops:.6g}); expected within "
            f"[{1.0 - tolerance:.3f}, 1.0] -- extractor and "
            "repro_torch/models/flops.py disagree")
    return ZooWorkload(arch=arch, name=name, layers=layers, counts=counts,
                       total_macs=total_macs, model_flops=flops,
                       coverage=coverage)


@functools.lru_cache(maxsize=None)
def _cached_workload(arch: str) -> ZooWorkload:
    return generate_workload(arch)


def zoo_workload(name: str) -> ZooWorkload:
    """Generated (and cross-checked) workload for a zoo model name (dashed
    arch ids and underscored registry names both accepted)."""
    key = _norm(name)
    if key not in _ARCH_BY_NAME:
        raise ValueError(
            f"unknown zoo model {name!r}; known: {sorted(ZOO_NAMES)}")
    return _cached_workload(_ARCH_BY_NAME[key])


def workload_set(name: str) -> list[ConvLayer]:
    """`MODEL_LAYERS`-compatible layer list for a zoo model name."""
    return list(zoo_workload(name).layers)


def known_workloads() -> tuple[str, ...]:
    """Every addressable workload name: the paper's four, the zoo, and the
    decode steps of `mla_decode`."""
    return (tuple(sorted(MODEL_LAYERS)) + tuple(sorted(ZOO_NAMES))
            + tuple(sorted(DECODE_SETS)))


def resolve_workload(name: str) -> list[ConvLayer]:
    """Resolve any workload name -- paper set ("resnet"), zoo model
    ("llama4_maverick_400b_a17b") or decode step ("deepseek_v3"), dashed
    aliases accepted -- to layers."""
    if name in MODEL_LAYERS:
        return list(MODEL_LAYERS[name])
    if _norm(name) in _ARCH_BY_NAME:
        return workload_set(name)
    if _norm(name) in DECODE_SETS:
        return list(decode_set(_norm(name)).layers)
    raise ValueError(
        f"unknown workload {name!r}; known: {list(known_workloads())}")
