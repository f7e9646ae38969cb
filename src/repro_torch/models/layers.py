"""Transformer primitives of the LM: norms, RoPE and M-RoPE, GQA attention
(train, prefill and cached decode; causal or local-window, with the rolling
window cache), the KV cache (bf16, f32 or int8), the SwiGLU MLP, the tied
embedding and the cross-entropy -- `repro.models.layers` on one card, as
plain functions on tensors and parameter dicts.

Under an active mesh (`parallel.sharding.use_mesh`) with DTensor parameters
and inputs, every function here runs sharded: `sharding.act` sits at the
reference's sites (`x.redistribute` to the rules' layout; the identity
without a mesh), and the reference's `shard_map` regions are
`sharding.shard_map` regions: the vocab-sharded `embed` and `softmax_xent`;
the attention, head-parallel (q over batch and heads, k and v over batch;
each rank's K3 sees its own heads and exactly the KV heads they read); the
one-token decode attention over a sequence-sharded KV cache; and the MLP,
tensor-parallel over the ff axis.  Without a mesh nothing of this runs.  The projections (`h @ wq`, the MLP, the unembedding)
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
from repro_torch.parallel import sharding

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


def _whole_if_uneven(t, dim: int, n: int):
    """A DTensor gathered on each mesh axis that splits `dim` into shards
    of unequal whole heads (n heads that the axis does not divide): a view
    can neither split nor merge such shards.  Anything else as it is."""
    if not sharding.is_sharded(t):
        return t
    from torch.distributed.tensor import Replicate, Shard

    pl = [Replicate() if isinstance(p, Shard) and p.dim == dim
          and n % t.device_mesh.size(i) else p
          for i, p in enumerate(t.placements)]
    return t if pl == list(t.placements) else t.redistribute(t.device_mesh,
                                                               pl)


def _split_heads(t, n: int, hd: int):
    """(B, S, n*hd) -> (B, S, n, hd); `act` then lays the heads out."""
    return _whole_if_uneven(t, t.dim() - 1, n).reshape(*t.shape[:-1], n, hd)


def _merge_heads(t):
    """(B, S, H, hd) -> (B, S, H*hd)."""
    return _whole_if_uneven(t, 2, t.shape[2]).reshape(*t.shape[:2], -1)


def _qkv(p, cfg: ModelConfig, x, positions):
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    h = rmsnorm(x, p["ln"])
    q = _split_heads(h @ p["wq"], H, hd)
    k = _split_heads(h @ p["wk"], KV, hd)
    v = _split_heads(h @ p["wv"], KV, hd)
    if cfg.qk_norm:
        q = head_rmsnorm(q, p["q_norm"])
        k = head_rmsnorm(k, p["k_norm"])
    if cfg.mrope:
        q = apply_mrope(q, positions)
        k = apply_mrope(k, positions)
    elif cfg.rope:
        q = apply_rope(q, positions)
        k = apply_rope(k, positions)
    q = sharding.act(q, "batch", "seq", "heads", None)
    k = sharding.act(k, "batch", "seq", None, None)
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
            fn = (lambda ql, kl, vl, g: windowed_sdpa(
                ql, kl, vl, g, window, cfg.flash_block_q).reshape(*ql.shape))
        else:
            fn = lambda ql, kl, vl, g: ops.attention(ql, kl, vl)  # noqa: E731
        if sharding.is_sharded(q, k, v):
            return _merge_heads(_head_parallel(fn, q, k, v, cfg.q_per_kv))
        return fn(q, k, v, cfg.q_per_kv).reshape(B, S, -1)
    Sk = k.shape[1]
    mask = (causal_mask(S, window, q.device) if causal
            else torch.ones((1, 1, S, Sk), dtype=torch.bool, device=q.device))
    return sdpa(q, k, v, mask, cfg.q_per_kv)


def _head_parallel(fn, q, k, v, g: int):
    """fn(q, k, v, g) -> (B, Sq, H, hd) on DTensors under the active mesh:
    one call a rank on its local q -- batch over the data axes, heads over
    the rules' heads axis -- and the KV heads those heads read (k and v
    over batch).  A rank's heads start at h0 = rank x ceil(H / tp)
    (DTensor's chunks; the last ranks may hold fewer, or none, as smollm's
    15 heads over 16 do).  When h0 and the local head count are multiples
    of g, the rank reads KV heads h0/g.. as they are; otherwise each local q
    head gets its own copy of its KV head (g = 1 locally), so a kernel's
    `h // g` always finds the right one."""
    mesh = sharding.current_mesh()
    B, Sq, H, hd = q.shape
    dp = sharding.batch_axes_for(B)
    heads = sharding.logical_spec(mesh, sharding.current_rules(),
                                  ("heads",))[0]
    if isinstance(heads, tuple):
        if len(heads) > 1:
            raise ValueError(f"attention: heads over several mesh axes "
                             f"{heads} are not supported")
        heads = heads[0]
    tp = sharding.axis_sizes(mesh)[heads] if heads else 1
    chunk = -(-H // tp)

    def local(ql, kl, vl):
        n = ql.shape[2]
        if n == 0:  # keep k and v in the graph: every rank runs the backward
            return ql.clone() + 0 * (kl.sum() + vl.sum())
        h0 = min(sharding.axis_index(heads) * chunk, H) if heads else 0
        if h0 % g == 0 and n % g == 0:
            kl, vl = (kl[:, :, h0 // g:(h0 + n) // g],
                      vl[:, :, h0 // g:(h0 + n) // g])
        else:
            idx = torch.div(h0 + torch.arange(n, device=ql.device), g,
                            rounding_mode="floor")
            kl, vl = kl.index_select(2, idx), vl.index_select(2, idx)
        return fn(ql.contiguous(), kl.contiguous(), vl.contiguous(),
                  n // kl.shape[2])

    qspec, kvspec = (dp, None, heads, None), (dp, None, None, None)
    return sharding.shard_map(local, (q, k, v), (qspec, kvspec, kvspec),
                              (qspec,), ((B, Sq, H, hd),))


def sdpa(q, k, v, mask, q_per_kv: int):
    """`_sdpa`, head-parallel (`_head_parallel`) on DTensors under a
    mesh."""
    if not sharding.is_sharded(q, k, v):
        return _sdpa(q, k, v, mask, q_per_kv)
    B, Sq, H, hd = q.shape

    def local(ql, kl, vl, g):
        return _sdpa(ql, kl, vl, mask, g).reshape(*ql.shape)

    return _merge_heads(_head_parallel(local, q, k, v, q_per_kv))


def attention(p, cfg: ModelConfig, x, positions, window: int = 0):
    """Full-sequence attention (train)."""
    q, k, v = _qkv(p, cfg, x, positions)
    out = full_seq_sdpa(cfg, q, k, v, window) @ p["wo"]
    return sharding.act(out, "batch", "seq", "dmodel")


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
    positions = sharding.constant(
        decode_positions(cfg, x.shape[0], pos, x.device), x,
        *((None,) if cfg.mrope else ()), "batch", None)
    q, k_new, v_new = _qkv(p, cfg, x, positions)
    if sharding.is_sharded(q, cache["k"]):
        out = _sharded_decode_attention(cfg, q, k_new, v_new, cache, pos,
                                        window)
        return sharding.act(out @ p["wo"], "batch", None, "dmodel"), cache
    cache = update_kv_cache(cache, k_new, v_new, pos)
    k, v = read_kv_cache(cache, x.dtype)
    j = torch.arange(k.shape[1], device=x.device)[None, None, None, :]
    mask = j <= pos
    if window > 0:
        mask = mask & (j > pos - window)
    out = _sdpa(q, k, v, mask, cfg.q_per_kv) @ p["wo"]
    return out, cache


def _sharded_decode_attention(cfg: ModelConfig, q, k_new, v_new, cache,
                              pos: int, window: int):
    """One-token attention over a KV cache whose length may be sharded
    (`launch.steps.cache_sharding`: batch over the data axes, S over the
    kv_len axis): each rank writes the new K/V into its own slice of the
    cache when the write index falls in it, scores its local keys, and the
    partial softmaxes combine over the length axis (a max, then sums) --
    the flash-decoding split of the reference's `_sdpa` over the cache.  A
    rolling window cache (with "pos_ids") writes slot pos % W and masks by
    the slots' positions, as `attention_decode_windowed` does.  Returns
    (B, 1, H*hd) replicated over the length axis."""
    mesh = sharding.current_mesh()
    rolling = "pos_ids" in cache
    names = sorted(k for k in cache if k != "pos_ids")
    ck = cache["k"]
    B, S = ck.shape[:2]
    dp = sharding.batch_axes_for(B)
    seq = sharding.shard_axis(ck, 1)
    chunk = -(-S // sharding.axis_sizes(mesh)[seq]) if seq else S
    write = pos % S if rolling else pos
    dtype = q.dtype

    def local(ql, kn, vn, *leaves):
        c = dict(zip(names, leaves))
        s0 = min(sharding.axis_index(seq) * chunk, S) if seq else 0
        n = c["k"].shape[1]
        if rolling:
            pos_ids = leaves[-1]
            pos_ids[write] = pos
            kpos = pos_ids[s0:s0 + n]
            mask = (kpos >= 0) & (kpos <= pos) & (kpos > pos - S)
        else:
            kpos = s0 + torch.arange(n, device=ql.device)
            mask = kpos <= pos
            if window > 0:
                mask = mask & (kpos > pos - window)
        if s0 <= write < s0 + n:
            update_kv_cache(c, kn, vn, write - s0)
        k, v = read_kv_cache(c, dtype)
        Bl, _, H, hd = ql.shape
        KV = k.shape[2]
        qq = ql.reshape(Bl, 1, KV, H // KV, hd)
        s = torch.einsum("bqkgh,bskh->bkgqs", qq, k).float() * hd ** -0.5
        s = torch.where(mask, s, -1e30)
        m = s.amax(dim=-1)
        if seq:
            m = sharding.all_reduce_max(m, seq)
        w = torch.exp(s - m[..., None])
        z = w.sum(dim=-1)
        o = torch.einsum("bkgqs,bskh->bqkgh", w.to(v.dtype), v).float()
        if seq:
            z = sharding.all_reduce_sum(z, seq)
            o = sharding.all_reduce_sum(o, seq)
        o = o / z.permute(0, 3, 1, 2)[..., None]
        return o.reshape(Bl, 1, H * hd).to(dtype)

    qspec = (dp, None, None, None)
    leaves = [cache[k] for k in names] + ([cache["pos_ids"]] if rolling else [])
    return sharding.shard_map(local, (q, k_new, v_new, *leaves),
                              (qspec, qspec, qspec,
                               *(sharding.spec_of(t) for t in leaves)),
                              ((dp, None, None),),
                              ((B, 1, q.shape[2] * q.shape[3]),))


def attention_decode_windowed(p, cfg: ModelConfig, x, cache, pos: int):
    """Rolling-window decode for local attention: the cache holds the last W
    positions, position `pos` in slot pos % W, the absolute position of each
    slot in cache["pos_ids"] (-1 where none was written)."""
    W = cache["k"].shape[1]
    positions = sharding.constant(
        decode_positions(cfg, x.shape[0], pos, x.device), x,
        *((None,) if cfg.mrope else ()), "batch", None)
    q, k_new, v_new = _qkv(p, cfg, x, positions)
    if sharding.is_sharded(q, cache["k"]):
        out = _sharded_decode_attention(cfg, q, k_new, v_new, cache, pos, 0)
        return sharding.act(out @ p["wo"], "batch", None, "dmodel"), cache
    slot = pos % W
    cache["pos_ids"][slot] = pos
    cache = update_kv_cache(cache, k_new, v_new, slot)
    k, v = read_kv_cache(cache, x.dtype)
    pos_ids = cache["pos_ids"]
    valid = (pos_ids >= 0) & (pos_ids <= pos) & (pos_ids > pos - W)
    out = _sdpa(q, k, v, valid[None, None, None, :], cfg.q_per_kv) @ p["wo"]
    return sharding.act(out, "batch", None, "dmodel"), cache


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
    out = sharding.act(out, "batch", "seq", "dmodel")
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
    pos_ids = torch.zeros(W, dtype=torch.int32, device=x.device)
    pos_ids[slots] = abs_pos.to(torch.int32)
    cache["pos_ids"] = sharding.constant(pos_ids, x, None)
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


def sharded_glu(h, wi, wo, act):
    """A gated MLP act(h @ wi[:, :F]) * (h @ wi[:, F:]) @ wo of DTensors,
    tensor-parallel over the rules' ff axis (Megatron's split): rank r
    takes columns r*F/tp.. of the gate and of the up half of `wi` (gathered
    whole: one D x 2F weight) and the same rows of `wo`, and the (B, S, D)
    partial products are summed over the axis.  None where there is no
    split to make: no ff axis, an axis of one rank (the plain path is then
    the same product), or one that does not divide F."""
    mesh = sharding.current_mesh()
    ff = sharding.logical_spec(mesh, sharding.current_rules(), ("ff",))[0]
    Fd = wo.shape[0]
    tp = sharding.axis_sizes(mesh).get(ff, 1) if isinstance(ff, str) else 1
    if tp == 1 or Fd % tp:
        return None
    f = Fd // tp
    B, S, D = h.shape
    dp = sharding.batch_axes_for(B)

    def local(hl, wi, wo):
        r = sharding.axis_index(ff)
        gate = hl @ wi[:, r * f:(r + 1) * f]
        up = hl @ wi[:, Fd + r * f:Fd + (r + 1) * f]
        return sharding.all_reduce_sum((act(gate) * up) @ wo, ff)

    return sharding.shard_map(local, (h, wi, wo),
                              ((dp, None, None), (None, None), (ff, None)),
                              ((dp, None, None),), ((B, S, D),))


def mlp(p, x):
    h = rmsnorm(x, p["ln"])
    if sharding.is_sharded(h, p["wi_mlp_up"]):
        out = sharded_glu(h, p["wi_mlp_up"], p["wo_mlp"], F.silu)
        if out is not None:
            return sharding.act(out, "batch", "seq", "dmodel")
    gate, up = torch.chunk(h @ p["wi_mlp_up"], 2, dim=-1)
    gate = sharding.act(gate, "batch", "seq", "ff")
    out = (F.silu(gate) * up) @ p["wo_mlp"]
    return sharding.act(out, "batch", "seq", "dmodel")


# ----------------------------------------------------------------- embeddings

def init_embed(generator, cfg: ModelConfig):
    return {"embedding": dense_init(generator, (cfg.padded_vocab(), cfg.d_model),
                                    scale=0.02)}


def _vocab_shards(table) -> int:
    """The model-axis size the vocab (table rows) is split over in the
    mesh branches of `embed` and `softmax_xent`, or 0 where they do not run
    (no mesh, no DTensor, no "model" axis, or V not a multiple of it)."""
    if not sharding.is_sharded(table):
        return 0
    tp = sharding.axis_sizes(sharding.current_mesh()).get("model", 0)
    return tp if tp and table.shape[0] % tp == 0 else 0


def embed(p, tokens):
    """Token embedding lookup.  Under a mesh the table is vocab-sharded
    over "model": each shard gathers the rows it holds (zeros for tokens
    it does not) and a sum over "model" combines them, the reference's
    shard_map (the default strategy would materialize a full-vocab
    one-hot)."""
    table = p["embedding"]
    tp = _vocab_shards(table)
    if not tp:
        return sharding.act(table[tokens], "batch", "seq", "dmodel")
    B, S = tokens.shape
    V, D = table.shape
    dp = sharding.batch_axes_for(B)
    Vloc = V // tp

    def local(tab, toks):
        idx = toks - sharding.axis_index("model") * Vloc
        inb = (idx >= 0) & (idx < Vloc)
        rows = tab[idx.clamp(0, Vloc - 1)]
        rows = torch.where(inb[..., None], rows, torch.zeros_like(rows))
        return sharding.all_reduce_sum(rows, "model")

    out = sharding.shard_map(local, (table, tokens),
                             (("model", None), (dp, None)),
                             ((dp, None, None),), ((B, S, D),))
    return sharding.act(out, "batch", "seq", "dmodel")


def unembed_logits(p, x):
    """Logits (B,S,V) against the tied embedding, vocab-sharded.  Under a
    mesh the table is first laid out vocab-sharded, as the embedding's
    shard_map takes it: the product then gives each shard its own vocab
    columns, where a table split along D would give every rank partial
    sums of all of them."""
    table = sharding.act(p["embedding"], "vocab", None)
    return sharding.act(x @ table.T, "batch", "seq", "vocab")


def softmax_xent(p_embed, x, labels, vocab_size: int):
    """Mean cross-entropy of `labels` (B,S) under the logits of x against the
    tied embedding (the reference's single-device branch): the logits in the
    compute dtype, then f32, padded-vocab columns at -1e30, logsumexp minus
    the label's logit."""
    logits = unembed_logits(p_embed, x)
    V = logits.shape[-1]
    if _vocab_shards(p_embed["embedding"]) and sharding.is_sharded(logits):
        return _sharded_xent(logits, labels, vocab_size).mean()
    lg = logits.float()
    if V > vocab_size:
        lg = torch.where(torch.arange(V, device=lg.device) < vocab_size, lg,
                         -1e30)
    lse = torch.logsumexp(lg, dim=-1)
    ll = torch.gather(lg, -1, labels[..., None])[..., 0]
    return torch.mean(lse - ll)


class _ShardedLogSumExp(torch.autograd.Function):
    """logsumexp over the last dim of logits split along it over a mesh
    axis, inside `sharding.shard_map`: the shard's max, the max over the
    axis (no gradient: the shift cancels), the shard's sum of exps summed
    over the axis, log plus the max -- `torch.logsumexp`'s own steps, so one
    rank gives its bits.  The backward is logsumexp's: each shard's logits
    get grad * exp(logit - lse), lse the global one."""

    @staticmethod
    def forward(ctx, lg, axis: str):
        m = sharding.all_reduce_max(lg.amax(dim=-1), axis)
        z = sharding.all_reduce_sum(
            torch.sum(torch.exp(lg - m[..., None]), dim=-1), axis)
        lse = torch.log(z).add_(m)
        ctx.save_for_backward(lg, lse)
        return lse

    @staticmethod
    def backward(ctx, grad):
        lg, lse = ctx.saved_tensors
        return grad[..., None] * (lg - lse[..., None]).exp(), None


def _sharded_xent(logits, labels, vocab_size: int):
    """Per-token cross-entropy (B,S) of vocab-sharded logits: the
    reference's shard_map -- each shard's max, a max over "model" that
    carries no gradient (the reference's `pmax_const`, whose tangent is
    zero: the shift cancels), then the shard's sum of exps and the label's
    logit where the shard holds it, each summed over "model"
    (`_ShardedLogSumExp`)."""
    B, S, V = logits.shape
    dp = sharding.batch_axes_for(B)
    Vloc = V // sharding.axis_sizes(sharding.current_mesh())["model"]

    def local(lg, lab):
        offset = sharding.axis_index("model") * Vloc
        lg = lg.float()
        if V > vocab_size:
            cols = offset + torch.arange(Vloc, device=lg.device)
            lg = torch.where(cols < vocab_size, lg, -1e30)
        valid = min(max(vocab_size - offset, 0), Vloc)
        idx = lab - offset
        inb = (idx >= 0) & (idx < valid)
        ll = torch.gather(lg, -1, idx.clamp(0, Vloc - 1)[..., None])[..., 0]
        label_logit = sharding.all_reduce_sum(
            torch.where(inb, ll, torch.zeros_like(ll)), "model")
        return _ShardedLogSumExp.apply(lg, "model") - label_logit

    return sharding.shard_map(local, (logits, labels),
                              ((dp, None, "model"), (dp, None)),
                              ((dp, None),), ((B, S),))
