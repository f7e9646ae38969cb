"""A plain PyTorch reference of one DeepSeek-V3 decoder layer, in float32.

Source: https://huggingface.co/deepseek-ai/DeepSeek-V3/blob/main/config.json
and the DeepSeek-V3 technical report (arXiv 2412.19437, sections 2.1.1-2.1.2).
The layer is

    h   = x + MLA(RMSNorm(x))
    out = h + FFN(RMSNorm(h))

with FFN the dense SwiGLU of the first `first_k_dense_replace` layers or
DeepSeekMoE in the rest.  Multi-head latent attention (MLA) is written in
both of its forms:

- `mla_naive`: the latent c_kv is expanded through W_UK and W_UV into each
  head's keys and values, and the heads attend over them (prefill's form);
- `mla_decode`: one new token a sequence attends over a cache of the latent
  and the shared rope key, [kv_lora_rank + qk_rope_head_dim] a position.
  W_UK is absorbed into the query and W_UV into the output, so every GEMM
  of the step has one operand that all heads of a sequence share.

Weights are stored [in, out], so each projection is one `x @ W` and every
GEMM of a step is an `aten.mm` or `aten.bmm` whose operands' shapes read
(rows, in, out).  Nothing here imports the port or the JAX package; it uses
plain `torch` operations only, and no cache or batching beyond the shapes
of the step.

Departures from the published model, none of which changes a shape:
- no YaRN scaling of RoPE (`rope_scaling`) and no YaRN softmax factor:
  plain RoPE at `rope_theta`, softmax scale 1/sqrt(qk_nope + qk_rope);
- RoPE pairs the two halves of the rope dims (rotate-half), where the
  published weights pair neighbours: a fixed permutation of W's columns;
- no multi-token-prediction module, no embedding and no output head;
- ties in the router's top-k follow `torch.topk`.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass(frozen=True)
class Config:
    """The published keys the layer's arithmetic reads (DeepSeek-V3's values
    by default)."""

    hidden_size: int = 7168
    num_attention_heads: int = 128
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    intermediate_size: int = 18432
    moe_intermediate_size: int = 2048
    n_routed_experts: int = 256
    num_experts_per_tok: int = 8
    n_shared_experts: int = 1
    n_group: int = 8
    topk_group: int = 4
    routed_scaling_factor: float = 2.5
    norm_topk_prob: bool = True
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0


def _weight(gen, shape, fan_in, device, dtype):
    if torch.device(device).type == "meta":
        # Shapes only: a published-width layer's experts would take 45 GB.
        return torch.empty(shape, device="meta", dtype=dtype)
    w = torch.randn(shape, generator=gen, dtype=torch.float32)
    return (w / math.sqrt(fan_in)).to(device=device, dtype=dtype)


def _norm_weight(gen, n, device, dtype):
    w = 1.0 + 0.1 * torch.randn(n, generator=gen, dtype=torch.float32)
    return w.to(device=device, dtype=dtype)


def init_mla(cfg: Config, gen: torch.Generator, device="cpu",
             dtype=torch.float32) -> dict:
    """Seeded random weights of the attention half of a layer, drawn on the
    host (`gen` a CPU generator); on the `meta` device, shapes only."""
    D, H = cfg.hidden_size, cfg.num_attention_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    w = lambda shape, fan_in: _weight(gen, shape, fan_in, device, dtype)
    n = lambda size: _norm_weight(gen, size, device, dtype)
    return {
        "attn_norm": n(D),
        "wq_a": w((D, qr), D), "q_norm": n(qr),
        "wq_b": w((qr, H * (dn + dr)), qr),
        "wkv_a": w((D, kvr + dr), D), "kv_norm": n(kvr),
        "wkv_b": w((kvr, H * (dn + dv)), kvr),
        "wo": w((H * dv, D), H * dv),
    }


def init_ffn(cfg: Config, gen: torch.Generator, moe: bool, device="cpu",
             dtype=torch.float32) -> dict:
    """Seeded random weights of the FFN half: DeepSeekMoE, or the dense
    SwiGLU of the leading layers."""
    D = cfg.hidden_size
    w = lambda shape, fan_in: _weight(gen, shape, fan_in, device, dtype)
    out = {"ffn_norm": _norm_weight(gen, D, device, dtype)}
    if not moe:
        I = cfg.intermediate_size
        out.update(w1=w((D, I), D), w3=w((D, I), D), w2=w((I, D), I))
        return out
    E, Fe = cfg.n_routed_experts, cfg.moe_intermediate_size
    Fs = Fe * cfg.n_shared_experts
    out.update(
        router=w((D, E), D),
        # The correction bias of the auxiliary-loss-free balancing: it
        # moves the choice of experts, never their weights.
        e_bias=(0.1 * torch.randn(E, generator=gen)).to(device, dtype),
        w1=w((E, D, Fe), D), w3=w((E, D, Fe), D), w2=w((E, Fe, D), Fe),
        sw1=w((D, Fs), D), sw3=w((D, Fs), D), sw2=w((Fs, D), Fs))
    return out


def rms_norm(x, weight, eps):
    var = x.pow(2).mean(-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * weight


def rope(x, pos, theta):
    """RoPE on the last dim of `x` (rotate-half pairing); `pos` holds the
    positions of x's second-to-last dim, or is one int."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) * 2 / x.shape[-1])
    pos = torch.as_tensor(pos, dtype=torch.float32, device=x.device)
    ang = pos[..., None] * freq
    cos, sin = ang.cos().to(x.dtype), ang.sin().to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _scale(cfg: Config) -> float:
    return 1.0 / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)


def _latent(p, cfg: Config, x):
    """(c_kv after its norm, the shared rope key before RoPE) of `x`."""
    kv = x @ p["wkv_a"]
    c_kv, k_pe = kv.split([cfg.kv_lora_rank, cfg.qk_rope_head_dim], dim=-1)
    return rms_norm(c_kv, p["kv_norm"], cfg.rms_norm_eps), k_pe


def _query(p, cfg: Config, x):
    c_q = rms_norm(x @ p["wq_a"], p["q_norm"], cfg.rms_norm_eps)
    q = (c_q @ p["wq_b"]).unflatten(
        -1, (cfg.num_attention_heads,
             cfg.qk_nope_head_dim + cfg.qk_rope_head_dim))
    return q.split([cfg.qk_nope_head_dim, cfg.qk_rope_head_dim], dim=-1)


def mla_naive(p, cfg: Config, x, n_queries: int | None = None):
    """MLA over a whole sequence, with each head's keys and values expanded
    from the latent: x [B, T, D] (normed) -> [B, n_queries, D], the outputs
    of the last `n_queries` positions (all T by default), causally masked."""
    B, T, _ = x.shape
    H = cfg.num_attention_heads
    dn, dv = cfg.qk_nope_head_dim, cfg.v_head_dim
    nq = T if n_queries is None else n_queries
    pos = torch.arange(T, device=x.device)
    c_kv, k_pe = _latent(p, cfg, x)
    k_pe = rope(k_pe, pos, cfg.rope_theta)                  # [B, T, dr]
    kv = (c_kv @ p["wkv_b"]).unflatten(-1, (H, dn + dv))    # [B, T, H, .]
    k_nope, v = kv.split([dn, dv], dim=-1)
    q_nope, q_pe = _query(p, cfg, x[:, T - nq:])            # [B, nq, H, .]
    q_pe = rope(q_pe.transpose(1, 2), pos[T - nq:],
                cfg.rope_theta).transpose(1, 2)
    scores = (torch.einsum("bqhd,bkhd->bhqk", q_nope, k_nope)
              + torch.einsum("bqhd,bkd->bhqk", q_pe, k_pe)) * _scale(cfg)
    mask = pos[None, :] > pos[T - nq:, None]                # [nq, T]
    probs = scores.masked_fill(mask, float("-inf")).softmax(-1)
    o = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    return o.flatten(2) @ p["wo"]


def latent_cache(p, cfg: Config, x):
    """The decode cache of positions 0..T-1 of x [B, T, D] (normed):
    [B, T, kv_lora_rank + qk_rope_head_dim], the normed latent beside the
    shared rope key after RoPE."""
    c_kv, k_pe = _latent(p, cfg, x)
    pos = torch.arange(x.shape[1], device=x.device)
    return torch.cat([c_kv, rope(k_pe, pos, cfg.rope_theta)], dim=-1)


def mla_decode(p, cfg: Config, x, cache):
    """One decode step of MLA in its absorbed form: x [B, D] (normed), the
    token at position T-1 of each sequence, over `cache` [B, T-1, kvr + dr].
    Returns ([B, D], the cache with this token's entry appended)."""
    B = x.shape[0]
    H, kvr = cfg.num_attention_heads, cfg.kv_lora_rank
    dn, dv = cfg.qk_nope_head_dim, cfg.v_head_dim
    pos = cache.shape[1]
    q_nope, q_pe = _query(p, cfg, x)                        # [B, H, .]
    q_pe = rope(q_pe, pos, cfg.rope_theta)
    c_kv, k_pe = _latent(p, cfg, x)
    entry = torch.cat([c_kv, rope(k_pe, pos, cfg.rope_theta)], dim=-1)
    cache = torch.cat([cache, entry[:, None]], dim=1)       # [B, T, kvr+dr]
    wkv_b = p["wkv_b"].unflatten(-1, (H, dn + dv))          # [kvr, H, dn+dv]
    w_uk = wkv_b[:, :, :dn].permute(1, 2, 0)                # [H, dn, kvr]
    w_uv = wkv_b[:, :, dn:].transpose(0, 1)                 # [H, kvr, dv]
    q_abs = torch.bmm(q_nope.transpose(0, 1), w_uk)         # [H, B, kvr]
    q = torch.cat([q_abs.transpose(0, 1), q_pe], dim=-1)    # [B, H, kvr+dr]
    scores = torch.bmm(q, cache.transpose(1, 2)) * _scale(cfg)
    probs = scores.softmax(-1)                              # [B, H, T]
    o_lat = torch.bmm(probs, cache[:, :, :kvr])             # [B, H, kvr]
    o = torch.bmm(o_lat.transpose(0, 1), w_uv)              # [H, B, dv]
    return o.transpose(0, 1).reshape(B, H * dv) @ p["wo"], cache


def route(cfg: Config, scores, bias):
    """DeepSeekMoE's choice from sigmoid scores [N, E]: made on score +
    correction bias, within the `topk_group` groups whose two best biased
    scores sum highest.  Returns the expert ids [N, k]."""
    N = scores.shape[0]
    E, G = cfg.n_routed_experts, cfg.n_group
    choice = scores + bias
    groups = choice.view(N, G, E // G).topk(2, dim=-1).values.sum(-1)
    keep = torch.zeros_like(groups, dtype=torch.bool).scatter(
        1, groups.topk(cfg.topk_group, dim=-1).indices, True)
    choice = choice.masked_fill(
        ~keep.repeat_interleave(E // G, dim=1), float("-inf"))
    return choice.topk(cfg.num_experts_per_tok, dim=-1).indices


def _swiglu(x, w1, w3, w2):
    return (F.silu(x @ w1) * (x @ w3)) @ w2


def moe(p, cfg: Config, x, assignment=None):
    """DeepSeekMoE on tokens x [N, D]: each routed expert on the tokens
    chosen for it, weighted, plus the shared expert on every token.
    `assignment`, a host tensor of expert ids [N, k], stands in for the
    router's choice where the tokens carry no values (the `meta` device);
    the router's GEMM runs either way and the weights stay its own."""
    scores = (x @ p["router"]).sigmoid()
    if assignment is None:
        idx = route(cfg, scores, p["e_bias"])
        ids = idx.cpu()
    else:
        idx, ids = assignment.to(x.device), assignment
    # The weights come from the unbiased scores, normalised and scaled.
    w = scores.gather(1, idx)
    if cfg.norm_topk_prob:
        w = w / w.sum(-1, keepdim=True)
    w = w * cfg.routed_scaling_factor
    out = _swiglu(x, p["sw1"], p["sw3"], p["sw2"])
    for e in range(cfg.n_routed_experts):
        tok, slot = (ids == e).nonzero(as_tuple=True)
        if not len(tok):
            continue
        tok, slot = tok.to(x.device), slot.to(x.device)
        y = _swiglu(x[tok], p["w1"][e], p["w3"][e], p["w2"][e])
        out = out.index_add(0, tok, y * w[tok, slot, None])
    return out


def dense_ffn(p, cfg: Config, x):
    """The leading layers' SwiGLU FFN."""
    return _swiglu(x, p["w1"], p["w3"], p["w2"])


def ffn(p, cfg: Config, x, assignment=None):
    if "router" in p:
        return moe(p, cfg, x, assignment)
    return dense_ffn(p, cfg, x)


def layer_naive(attn, mlp, cfg: Config, x):
    """The whole layer over x [B, T, D], attention in the naive form."""
    B, T, D = x.shape
    h = x + mla_naive(attn, cfg, rms_norm(x, attn["attn_norm"],
                                          cfg.rms_norm_eps))
    y = ffn(mlp, cfg, rms_norm(h, mlp["ffn_norm"], cfg.rms_norm_eps)
            .reshape(B * T, D))
    return h + y.reshape(B, T, D)


def layer_decode(attn, mlp, cfg: Config, x, cache, assignment=None):
    """One decode step of the whole layer: x [B, D] over `cache`, attention
    in the absorbed form.  Returns ([B, D], the grown cache)."""
    a, cache = mla_decode(attn, cfg, rms_norm(x, attn["attn_norm"],
                                              cfg.rms_norm_eps), cache)
    h = x + a
    y = ffn(mlp, cfg, rms_norm(h, mlp["ffn_norm"], cfg.rms_norm_eps),
            assignment)
    return h + y, cache
