"""Transformer primitives of the LM: norms, RoPE and M-RoPE, GQA attention
(train, prefill and cached decode; causal or local-window, with the rolling
window cache), the KV cache (bf16, f32 or int8), the SwiGLU MLP, the tied
embedding and the cross-entropy -- `repro.models.layers` on one card, as
plain functions on tensors and parameter dicts.

The port runs on one card, so the reference's `sharding.act` constraints
have no counterpart.  The projections (`h @ wq`, the MLP, the unembedding)
stay `torch.matmul`: the reference leaves them to XLA, outside any Pallas
kernel.  The causal prefill attention goes to `kernels.ops.attention`
(kernel K3 on the card) when `cfg.attn_impl == "flash"`.  Windowed attention
stays plain PyTorch, as the reference computes it in jnp outside its Pallas
kernel: K3 has no window.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r}; choose from "
                         f"{tuple(_DTYPES)}")
    return _DTYPES[name]


# ---------------------------------------------------------------- init helpers

def dense_init(generator: torch.Generator, shape, scale=None) -> torch.Tensor:
    """Normal(0, 1) * scale in f32 (scale defaults to fan_in^-0.5), drawn on
    the generator's device: a CPU generator gives the same weights on every
    device, a CUDA one draws a large model on the card in seconds."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else fan_in ** -0.5
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=generator.device).mul_(scale)


# ---------------------------------------------------------------------- norms

def rmsnorm(x, scale, eps=1e-6):
    dtype = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + scale.float())).to(dtype)


def head_rmsnorm(x, scale, eps=1e-6):
    """qk-norm: rmsnorm over the head_dim axis."""
    return rmsnorm(x, scale, eps)


# ----------------------------------------------------------------------- rope

def rope_freqs(head_dim: int, theta: float = 10000.0, device=None):
    """theta^(-i / (hd/2)), computed in f64 and rounded once to f32, so the
    card and the host get the same bits (an f32 pow one ulp apart moves the
    angle at position p by p ulps)."""
    half = head_dim // 2
    return (theta ** (-torch.arange(0, half, dtype=torch.float64,
                                    device=device) / half)).float()


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (..., S, H, hd); positions: (..., S) integers.  Split halves, not
    interleaved; f32 angles."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)          # (hd/2,)
    angles = positions[..., None].float() * freqs           # (..., S, hd/2)
    angles = angles[..., None, :]                           # (..., S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x, positions3, theta: float = 10000.0):
    """M-RoPE (Qwen2-VL): the rotary pairs split into 3 sections (t/h/w),
    each rotated by its own position stream.  positions3: (3, ..., S); the
    temporal section takes the remainder of hd/2 over 3."""
    hd = x.shape[-1]
    half = hd // 2
    sect = [half - 2 * (half // 3), half // 3, half // 3]
    freqs = rope_freqs(hd, theta, device=x.device)
    pieces, start = [], 0
    for comp in range(3):
        f = freqs[start:start + sect[comp]]
        pieces.append(positions3[comp][..., None].float() * f)
        start += sect[comp]
    angles = torch.cat(pieces, dim=-1)[..., None, :]      # (..., S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------- attention

def init_attention(generator, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "ln": torch.zeros((D,)),
        "wq": dense_init(generator, (D, H * hd)),
        "wk": dense_init(generator, (D, KV * hd)),
        "wv": dense_init(generator, (D, KV * hd)),
        "wo": dense_init(generator, (H * hd, D), scale=(H * hd) ** -0.5),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((hd,))
        p["k_norm"] = torch.zeros((hd,))
    return p


def _qkv(p, cfg: ModelConfig, x, positions):
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    h = rmsnorm(x, p["ln"])
    q = (h @ p["wq"]).reshape(B, S, H, hd)
    k = (h @ p["wk"]).reshape(B, S, KV, hd)
    v = (h @ p["wv"]).reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q = head_rmsnorm(q, p["q_norm"])
        k = head_rmsnorm(k, p["k_norm"])
    if cfg.mrope:
        q = apply_mrope(q, positions)
        k = apply_mrope(k, positions)
    elif cfg.rope:
        q = apply_rope(q, positions)
        k = apply_rope(k, positions)
    return q, k, v


def _sdpa(q, k, v, mask, q_per_kv: int):
    """q: (B,Sq,H,hd), k/v: (B,Sk,KV,hd), mask: (B,1,Sq,Sk) or broadcastable.
    The score product runs in the compute dtype and only then goes to f32, so
    bf16 scores are rounded before the softmax, as in the reference."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    q = q.reshape(B, Sq, KV, q_per_kv, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", q, k).float()
    scores = scores * (hd ** -0.5)
    scores = torch.where(mask[:, :, None] if mask.dim() == 4 else mask,
                         scores, -1e30)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", w, v)
    return out.reshape(B, Sq, H * hd)


def windowed_sdpa(q, k, v, q_per_kv: int, window: int, bq: int = 1024):
    """Causal attention over the last `window` keys, in plain PyTorch: the
    reference's `flash_sdpa` window branch.  Query chunks of `bq` rows (halved
    until they divide Sq) each read one static slice of `window + bq` keys;
    scores in the compute dtype, then f32 (bf16 scores are rounded before the
    softmax, as in the reference).  q: (B,Sq,H,hd), k/v: (B,Sk,KV,hd) ->
    (B,Sq,H*hd)."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    bq = min(bq, Sq)
    while Sq % bq:
        bq //= 2
    span = min(window + bq, Sk)
    scale = hd ** -0.5
    qc = q.reshape(B, Sq // bq, bq, KV, q_per_kv, hd)
    outs = []
    for i in range(Sq // bq):
        start = min(max(i * bq + bq - span, 0), Sk - span)
        kb, vb = k[:, start:start + span], v[:, start:start + span]
        qpos = i * bq + torch.arange(bq, device=q.device)
        kpos = start + torch.arange(span, device=q.device)
        m = ((kpos[None] <= qpos[:, None])
             & (kpos[None] > qpos[:, None] - window))
        s = torch.einsum("bqkgh,bskh->bkgqs", qc[:, i], kb).float() * scale
        s = torch.where(m[None, None, None], s, -1e30)
        w = torch.softmax(s, dim=-1).to(vb.dtype)
        outs.append(torch.einsum("bkgqs,bskh->bqkgh", w, vb))
    return torch.cat(outs, dim=1).reshape(B, Sq, H * hd).to(q.dtype)


def causal_mask(S: int, window: int = 0, device=None):
    i = torch.arange(S, device=device)[:, None]
    j = torch.arange(S, device=device)[None, :]
    m = j <= i
    if window > 0:
        m = m & (j > i - window)
    return m[None, None]  # (1,1,S,S)


def full_seq_sdpa(cfg: ModelConfig, q, k, v, window: int, causal: bool = True):
    """(B,S,H*hd).  `attn_impl="flash"` with causal attention goes to
    `ops.attention` (K3 on the card, its plain version on the CPU), or with a
    window to `windowed_sdpa`; "naive" is the plain `_sdpa` on materialised
    scores."""
    B, S = q.shape[:2]
    if cfg.attn_impl == "flash" and causal:
        if window > 0:
            return windowed_sdpa(q, k, v, cfg.q_per_kv, window,
                                 cfg.flash_block_q)
        return ops.attention(q, k, v).reshape(B, S, -1)
    Sk = k.shape[1]
    mask = (causal_mask(S, window, q.device) if causal
            else torch.ones((1, 1, S, Sk), dtype=torch.bool, device=q.device))
    return _sdpa(q, k, v, mask, cfg.q_per_kv)


def attention(p, cfg: ModelConfig, x, positions, window: int = 0):
    """Full-sequence attention (train)."""
    q, k, v = _qkv(p, cfg, x, positions)
    return full_seq_sdpa(cfg, q, k, v, window) @ p["wo"]


# --------------------------------------------------------- KV cache (+ int8)

@dataclasses.dataclass(frozen=True)
class CacheSpec:
    seq_len: int
    dtype: str  # "bfloat16" | "float32" | "int8"


def init_kv_cache(cfg: ModelConfig, batch: int, spec: CacheSpec, device=None):
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    S = spec.seq_len
    if spec.dtype == "int8":
        z8 = torch.zeros((batch, S, KV, hd), dtype=torch.int8, device=device)
        zs = torch.zeros((batch, S, KV, 1), dtype=torch.float32, device=device)
        return {"k": z8, "v": z8.clone(), "k_scale": zs, "v_scale": zs.clone()}
    z = torch.zeros((batch, S, KV, hd), dtype=torch_dtype(spec.dtype),
                    device=device)
    return {"k": z, "v": z.clone()}


def _quant(x):
    scale = torch.amax(torch.abs(x), dim=-1, keepdim=True) / 127.0 + 1e-8
    return torch.round(x / scale).to(torch.int8), scale.float()


def _dequant(x8, scale, dtype):
    return (x8.float() * scale).to(dtype)


def update_kv_cache(cache, k_new, v_new, pos: int):
    """k_new/v_new: (B,1,KV,hd); pos: write index.  Writes in place (the
    reference donates the cache to its jitted decode step) and returns the
    cache."""
    if "k_scale" in cache:
        k8, ks = _quant(k_new)
        v8, vs = _quant(v_new)
        cache["k"][:, pos:pos + 1] = k8
        cache["v"][:, pos:pos + 1] = v8
        cache["k_scale"][:, pos:pos + 1] = ks
        cache["v_scale"][:, pos:pos + 1] = vs
        return cache
    cache["k"][:, pos:pos + 1] = k_new.to(cache["k"].dtype)
    cache["v"][:, pos:pos + 1] = v_new.to(cache["v"].dtype)
    return cache


def read_kv_cache(cache, dtype):
    if "k_scale" in cache:
        return (_dequant(cache["k"], cache["k_scale"], dtype),
                _dequant(cache["v"], cache["v_scale"], dtype))
    return cache["k"].to(dtype), cache["v"].to(dtype)


def decode_positions(cfg: ModelConfig, batch: int, pos: int, device):
    """The one-token positions of a decode step: (B, 1), or (3, B, 1) for
    M-RoPE (all three sections at `pos`)."""
    shape = (3, batch, 1) if cfg.mrope else (batch, 1)
    return torch.full(shape, pos, dtype=torch.long, device=device)


def attention_decode(p, cfg: ModelConfig, x, cache, pos: int, window: int = 0):
    """One-token decode: x (B,1,D); attends to cache[0..pos] inclusive (the
    last `window` of them with a window).  A one-query masked `_sdpa` over
    the cache in plain PyTorch, as the reference computes it outside any
    Pallas kernel."""
    positions = decode_positions(cfg, x.shape[0], pos, x.device)
    q, k_new, v_new = _qkv(p, cfg, x, positions)
    cache = update_kv_cache(cache, k_new, v_new, pos)
    k, v = read_kv_cache(cache, x.dtype)
    j = torch.arange(k.shape[1], device=x.device)[None, None, None, :]
    mask = j <= pos
    if window > 0:
        mask = mask & (j > pos - window)
    out = _sdpa(q, k, v, mask, cfg.q_per_kv) @ p["wo"]
    return out, cache


def attention_decode_windowed(p, cfg: ModelConfig, x, cache, pos: int):
    """Rolling-window decode for local attention: the cache holds the last W
    positions, position `pos` in slot pos % W, the absolute position of each
    slot in cache["pos_ids"] (-1 where none was written)."""
    W = cache["k"].shape[1]
    positions = decode_positions(cfg, x.shape[0], pos, x.device)
    q, k_new, v_new = _qkv(p, cfg, x, positions)
    slot = pos % W
    cache["pos_ids"][slot] = pos
    cache = update_kv_cache(cache, k_new, v_new, slot)
    k, v = read_kv_cache(cache, x.dtype)
    pos_ids = cache["pos_ids"]
    valid = (pos_ids >= 0) & (pos_ids <= pos) & (pos_ids > pos - W)
    out = _sdpa(q, k, v, valid[None, None, None, :], cfg.q_per_kv) @ p["wo"]
    return out, cache


def _fill_cache(cfg: ModelConfig, k, v, spec: CacheSpec):
    """Quantize/cast full-sequence K,V (B,S,KV,hd) into a decode cache."""
    if spec.dtype == "int8":
        k8, ks = _quant(k)
        v8, vs = _quant(v)
        return {"k": k8, "v": v8, "k_scale": ks, "v_scale": vs}
    dt = torch_dtype(spec.dtype)
    # clone: the decode step writes the cache in place
    return {"k": k.to(dt).clone(), "v": v.to(dt).clone()}


def attention_prefill(p, cfg: ModelConfig, x, positions, window: int,
                      spec: CacheSpec):
    """Full-sequence attention that also emits the populated decode cache;
    with a window, the rolling cache: the last W = min(window, S) positions
    in their slots (position % W) and their `pos_ids`."""
    q, k, v = _qkv(p, cfg, x, positions)
    out = full_seq_sdpa(cfg, q, k, v, window) @ p["wo"]
    if window <= 0:
        return out, _fill_cache(cfg, k, v, spec)
    S = x.shape[1]
    W = min(window, S)
    abs_pos = torch.arange(S - W, S, device=x.device)
    slots = abs_pos % W
    cache = {}
    for name, t in _fill_cache(cfg, k[:, S - W:], v[:, S - W:], spec).items():
        rolled = torch.zeros_like(t)
        rolled[:, slots] = t
        cache[name] = rolled
    cache["pos_ids"] = torch.zeros(W, dtype=torch.int32, device=x.device)
    cache["pos_ids"][slots] = abs_pos.to(torch.int32)
    return out, cache


# ----------------------------------------------------------------------- MLP

def init_mlp(generator, cfg: ModelConfig, d_ff: int | None = None):
    D = cfg.d_model
    Fd = d_ff or cfg.d_ff
    return {
        "ln": torch.zeros((D,)),
        "wi_mlp_up": dense_init(generator, (D, 2 * Fd)),
        "wo_mlp": dense_init(generator, (Fd, D), scale=Fd ** -0.5),
    }


def mlp(p, x):
    h = rmsnorm(x, p["ln"])
    gate, up = torch.chunk(h @ p["wi_mlp_up"], 2, dim=-1)
    return (F.silu(gate) * up) @ p["wo_mlp"]


# ----------------------------------------------------------------- embeddings

def init_embed(generator, cfg: ModelConfig):
    return {"embedding": dense_init(generator, (cfg.padded_vocab(), cfg.d_model),
                                    scale=0.02)}


def embed(p, tokens):
    """Token embedding lookup (one card: no vocab sharding)."""
    return p["embedding"][tokens]


def unembed_logits(p, x):
    """Logits (B,S,V) against the tied embedding."""
    return x @ p["embedding"].T


def softmax_xent(p_embed, x, labels, vocab_size: int):
    """Mean cross-entropy of `labels` (B,S) under the logits of x against the
    tied embedding (the reference's single-device branch): the logits in the
    compute dtype, then f32, padded-vocab columns at -1e30, logsumexp minus
    the label's logit."""
    logits = unembed_logits(p_embed, x)
    V = logits.shape[-1]
    lg = logits.float()
    if V > vocab_size:
        lg = torch.where(torch.arange(V, device=lg.device) < vocab_size, lg,
                         -1e30)
    lse = torch.logsumexp(lg, dim=-1)
    ll = torch.gather(lg, -1, labels[..., None])[..., 0]
    return torch.mean(lse - ll)
