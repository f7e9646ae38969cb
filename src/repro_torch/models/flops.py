"""Analytic FLOP and HBM-byte accounting per (architecture x shape) cell.

A copy of the reference's `repro.models.flops` with its import path changed
(tests/test_torch_lm.py holds the two equal).  `chip_smoke.py` takes the
roofline of a served prefill and of a decode step from it.

Conventions: 1 MAC = 2 FLOPs; causal attention scores count the true lower
triangle (S_ctx averages S/2); training = 3x forward (fwd + 2x bwd); remat
recompute is reported separately as a multiplier, not counted as useful work.
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeConfig


def _attn_flops_per_token(cfg: ModelConfig, ctx: float) -> float:
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    proj = 2 * D * (H + 2 * KV) * hd + 2 * H * hd * D
    attn = 2 * 2 * ctx * H * hd  # scores + pv
    return proj + attn


def _mlp_flops_per_token(cfg: ModelConfig) -> float:
    return 6 * cfg.d_model * cfg.d_ff if cfg.d_ff else 0.0


def _moe_flops_per_token(cfg: ModelConfig) -> float:
    router = 2 * cfg.d_model * cfg.num_experts
    return router + cfg.top_k * 6 * cfg.d_model * cfg.d_ff


def _mlstm_flops_per_token(cfg: ModelConfig, decode: bool) -> float:
    D = cfg.d_model
    Din = 2 * D
    dh = Din // cfg.num_heads
    proj = 2 * D * Din * 2 + 2 * Din * D + 3 * 2 * Din * dh + 2 * 4 * Din
    Lc = 1 if decode else cfg.mlstm_chunk
    cell = 4 * Lc * Din + 6 * dh * Din  # intra-chunk + state/inter
    return proj + cell


def _slstm_flops_per_token(cfg: ModelConfig) -> float:
    D = cfg.d_model
    dh = D // cfg.num_heads
    F = ((4 * D // 3 + 63) // 64) * 64
    return 4 * 2 * D * D + 4 * 2 * D * dh + 2 * D * D + 6 * D * F


def _rglru_flops_per_token(cfg: ModelConfig) -> float:
    D = cfg.d_model
    return 5 * 2 * D * D + 2 * cfg.rglru_conv_width * D + 12 * D


def _block_flops_per_token(cfg: ModelConfig, kind: str, ctx: float,
                           decode: bool) -> float:
    if kind == "attn":
        return _attn_flops_per_token(cfg, ctx) + _mlp_flops_per_token(cfg)
    if kind == "local_attn":
        local_ctx = min(ctx, float(cfg.local_window or ctx))
        return _attn_flops_per_token(cfg, local_ctx) + _mlp_flops_per_token(cfg)
    if kind == "moe":
        return _attn_flops_per_token(cfg, ctx) + _moe_flops_per_token(cfg)
    if kind == "mlstm":
        return _mlstm_flops_per_token(cfg, decode)
    if kind == "slstm":
        return _slstm_flops_per_token(cfg)
    if kind == "rglru":
        return _rglru_flops_per_token(cfg) + _mlp_flops_per_token(cfg)
    raise ValueError(kind)


def forward_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Global forward FLOPs for one step of this cell."""
    B, S = shape.global_batch, shape.seq_len
    decode = shape.kind == "decode"
    if decode:
        tokens = float(B)          # one new token per sequence
        ctx = float(S)             # attends over the full cache
    else:
        tokens = float(B) * S
        ctx = S / 2.0              # causal average context

    per_tok = sum(_block_flops_per_token(cfg, k, ctx, decode)
                  for k in cfg.block_pattern) / len(cfg.block_pattern)
    total = tokens * per_tok * cfg.num_layers
    # unembed (tied): logits for every processed token in train; last/one token
    # in prefill/decode
    V = cfg.padded_vocab()
    if shape.kind == "train":
        total += tokens * 2 * cfg.d_model * V
    else:
        total += float(B) * 2 * cfg.d_model * V
    if cfg.family == "encdec":
        S_src = max(S // 8, 16)
        enc_tokens = float(B) * S_src
        enc_per_tok = _attn_flops_per_token(cfg, S_src / 2.0) + _mlp_flops_per_token(cfg)
        total += enc_tokens * enc_per_tok * cfg.encoder_layers
        # decoder cross-attention
        cross = 2 * cfg.d_model * (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim \
            + 2 * 2 * S_src * cfg.num_heads * cfg.head_dim
        total += tokens * cross * cfg.num_layers
    return total


def param_count(cfg: ModelConfig) -> float:
    """Total parameters from the config (cheap, no tracing)."""
    D, V = cfg.d_model, cfg.padded_vocab()
    per_layer = 0.0
    for kind in cfg.block_pattern:
        H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        attn = D * (H + 2 * KV) * hd + H * hd * D
        mlp = 3 * D * cfg.d_ff
        if kind in ("attn", "local_attn"):
            per_layer += attn + mlp
        elif kind == "moe":
            per_layer += attn + D * cfg.num_experts + cfg.num_experts * 3 * D * cfg.d_ff
        elif kind == "mlstm":
            Din = 2 * D
            per_layer += 2 * D * Din + Din * D + 3 * Din * (Din // H) + 2 * Din * H
        elif kind == "slstm":
            F = ((4 * D // 3 + 63) // 64) * 64
            per_layer += 4 * (D * D + D * (D // H)) + 3 * D * F + D * D
        elif kind == "rglru":
            per_layer += 5 * D * D + mlp
    total = V * D + per_layer * cfg.num_layers / len(cfg.block_pattern)
    if cfg.family == "encdec":
        total += (4 * D * D + 3 * D * cfg.d_ff) * cfg.encoder_layers
        total += 4 * D * D * cfg.num_layers  # cross-attention
        total += 32768 * D                   # positional table
    return total


def _bytes_of(dtype: str) -> int:
    return {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1}[dtype]


def cell_bytes(cfg: ModelConfig, shape: ShapeConfig, n_dev: int,
               model_par: int) -> dict:
    """Analytic HBM traffic per device per step, assuming block-level fusion
    (flash blocks stay in VMEM; weights read once per use).  XLA's
    'bytes accessed' has no fusion model and overestimates ~30x, so the
    roofline memory term uses this estimate and reports the HLO number as an
    upper bound."""
    P = param_count(cfg)
    pb = _bytes_of(cfg.param_dtype)
    ob = _bytes_of(cfg.optimizer_dtype)
    ab = _bytes_of(cfg.compute_dtype)
    dp = max(n_dev // model_par, 1)
    B, S = shape.global_batch, shape.seq_len
    P_dev = P / n_dev  # params sharded over the whole mesh (TP x FSDP)

    if shape.kind == "train":
        # fwd read + bwd read + grad write (param dtype) + AdamW read/write of
        # p, mu, nu (optimizer dtype)
        param_traffic = P_dev * (3 * pb + 2 * (pb + 2 * ob))
        tokens_dev = B * S / dp  # model ranks replicate tokens
        act_traffic = tokens_dev * cfg.d_model * ab * 10 * cfg.num_layers / model_par \
            + tokens_dev * cfg.d_model * ab * 4 * cfg.num_layers  # unsharded boundary IO
        logits_traffic = tokens_dev * (cfg.padded_vocab() / model_par) * ab * 2
        total = param_traffic + act_traffic + logits_traffic
    elif shape.kind == "prefill":
        param_traffic = P_dev * pb
        tokens_dev = B * S / dp
        act_traffic = tokens_dev * cfg.d_model * ab * 6 * cfg.num_layers / model_par
        cache_traffic = (tokens_dev * cfg.num_kv_heads * cfg.head_dim * 2
                         * _bytes_of(cfg.kv_cache_dtype) * cfg.num_layers)
        total = param_traffic + act_traffic + cache_traffic
    else:  # decode: params + full cache read once
        param_traffic = P_dev * pb
        cache_bytes = (B * S * cfg.num_kv_heads * cfg.head_dim * 2
                       * _bytes_of(cfg.kv_cache_dtype) * cfg.num_layers)
        if cfg.sub_quadratic:
            # recurrent state instead of a KV cache
            cache_bytes = (B * (2 * cfg.d_model) ** 2 / cfg.num_heads * 4
                           * cfg.num_layers)
        total = param_traffic + cache_bytes / n_dev
    return {"bytes_per_dev": total}


def cell_flops(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    fwd = forward_flops(cfg, shape)
    if shape.kind == "train":
        useful = 3.0 * fwd
        hw_factor = 4.0 / 3.0 if cfg.remat == "block" else 1.0
    else:
        useful = fwd
        hw_factor = 1.0
    return {"forward": fwd, "useful": useful,
            "expected_hw": useful * hw_factor}
