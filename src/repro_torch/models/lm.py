"""Decoder-only LM over heterogeneous block patterns (the port of
`repro.models.lm.LM`), as an `nn.Module`.

Block kinds: attn | local_attn | moe | mlstm | slstm | rglru.  The pattern
cycles over the layers (llama4's ("attn", "moe"), recurrentgemma's period of
19, xlstm's 7:1).  The reference stacks parameters over super-blocks of one
period and scans; the port keeps one module per layer, so layer
s * period + i is the reference's super-block s, pattern position i.  Each
`Block` carries its kind's parts under the reference's names (`attn`, `mlp`,
`moe`, `rglru`, `mlstm`, `slstm`), so `convert.lm_params_from_reference`
maps either tree to the other by name.

The reference holds f32 parameters and casts them to the compute dtype on
every call (`_cast`).  For serving the port holds the cast copy once (the
same round-to-nearest-even), on the model's device, with no gradient.  A
model built with `train=True` holds master parameters in `param_dtype` that
require grad, and `loss` casts them to the compute dtype on every call, as
`_cast` does; under `remat == "block"` each block runs under
`torch.utils.checkpoint` (non-reentrant), so its activations are recomputed
in the backward pass -- K3's forward runs twice an attention block a step,
K3-bwd once.  `init` draws the reference's distributions from a
`torch.Generator` (a CPU one gives the same weights on every device; one on
the card draws a large model there); `load_params` takes a state dict of
f32 tensors such as `convert.lm_params_from_reference` makes.

Inputs: {"tokens": (B,S)}, or with `input_mode="embeddings"` {"embeddings":
(B,S,D)} through `in_proj`; M-RoPE positions come from batch["positions"]
(3,B,S) or default to arange(S) in all three sections.  The decode cache is
one entry a layer: a KV cache dict for attn and moe blocks, the rolling
window cache (with `pos_ids`) for local_attn, the recurrent state dict for
the others.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as RG
from repro_torch.models import xlstm as XL
from repro_torch.parallel import sharding

# ------------------------------------------------------------ per-kind dispatch

def _attention_shapes(cfg: ModelConfig) -> dict[str, tuple]:
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    out = {"ln": (D,), "wq": (D, H * hd), "wk": (D, KV * hd),
           "wv": (D, KV * hd), "wo": (H * hd, D)}
    if cfg.qk_norm:
        out.update(q_norm=(hd,), k_norm=(hd,))
    return out


def _mlp_shapes(cfg: ModelConfig) -> dict[str, tuple]:
    D, Fd = cfg.d_model, cfg.d_ff
    return {"ln": (D,), "wi_mlp_up": (D, 2 * Fd), "wo_mlp": (Fd, D)}


def block_parts(kind: str, cfg: ModelConfig) -> dict[str, dict]:
    """{part: {name: shape}} of one block of `kind` (the reference's
    `init_block` tree); ValueError for a kind that does not exist."""
    mlp = {"mlp": _mlp_shapes(cfg)} if cfg.d_ff > 0 else {}
    if kind in ("attn", "local_attn"):
        return {"attn": _attention_shapes(cfg), **mlp}
    if kind == "moe":
        return {"attn": _attention_shapes(cfg), "moe": MOE.shapes(cfg)}
    if kind == "mlstm":
        return {"mlstm": XL.mlstm_shapes(cfg)}
    if kind == "slstm":
        return {"slstm": XL.slstm_shapes(cfg)}
    if kind == "rglru":
        return {"rglru": RG.shapes(cfg), **mlp}
    raise ValueError(kind)


_INIT = {"attn": L.init_attention, "mlp": L.init_mlp, "moe": MOE.init_moe,
         "mlstm": XL.init_mlstm_block, "slstm": XL.init_slstm_block,
         "rglru": RG.init_rglru_block}


def _ffn(p, x):
    """The block's MLP where it has one."""
    return x + L.mlp(p["mlp"], x) if "mlp" in p else x


def apply_block(kind: str, p, cfg: ModelConfig, x, positions):
    """One block's forward (train); p: {part: {name: tensor}}.  Under a
    mesh the block's parameters are gathered over the FSDP axis here, one
    block at a time (again in the recompute of a checkpointed block)."""
    p = sharding.gather_fsdp(p)
    if kind in ("attn", "local_attn"):
        window = cfg.local_window if kind == "local_attn" else 0
        return _ffn(p, x + L.attention(p["attn"], cfg, x, positions, window))
    if kind == "moe":
        x = x + L.attention(p["attn"], cfg, x, positions, 0)
        return x + MOE.moe_block(p["moe"], cfg, x)
    if kind == "mlstm":
        return x + XL.mlstm_block(p["mlstm"], cfg, x)
    if kind == "slstm":
        return x + XL.slstm_block(p["slstm"], cfg, x)
    if kind == "rglru":
        return _ffn(p, x + RG.rglru_block(p["rglru"], cfg, x))
    raise ValueError(kind)


def apply_block_prefill(kind: str, p, cfg: ModelConfig, x, positions,
                        spec: L.CacheSpec):
    """`apply_block` that also returns the populated decode cache/state."""
    p = sharding.gather_fsdp(p)
    if kind in ("attn", "local_attn", "moe"):
        window = cfg.local_window if kind == "local_attn" else 0
        delta, cache = L.attention_prefill(p["attn"], cfg, x, positions,
                                           window, spec)
        x = x + delta
        if kind == "moe":
            return x + MOE.moe_block(p["moe"], cfg, x), cache
        return _ffn(p, x), cache
    if kind == "mlstm":
        delta, st = XL.mlstm_block_prefill(p["mlstm"], cfg, x)
        return x + delta, st
    if kind == "slstm":
        delta, st = XL.slstm_block(p["slstm"], cfg, x, return_state=True)
        return x + delta, st
    if kind == "rglru":
        delta, st = RG.rglru_block(p["rglru"], cfg, x, return_state=True)
        return _ffn(p, x + delta), st
    raise ValueError(kind)


def apply_block_decode(kind: str, p, cfg: ModelConfig, x, cache, pos: int):
    """One decode step of one block: (x, the new cache entry).  KV caches
    are written in place; recurrent states are new dicts."""
    p = sharding.gather_fsdp(p)
    if kind in ("attn", "local_attn", "moe"):
        if kind == "local_attn":
            delta, cache = L.attention_decode_windowed(p["attn"], cfg, x,
                                                       cache, pos)
        else:
            delta, cache = L.attention_decode(p["attn"], cfg, x, cache, pos)
        x = x + delta
        if kind == "moe":
            return x + MOE.moe_block(p["moe"], cfg, x), cache
        return _ffn(p, x), cache
    if kind == "mlstm":
        delta, st = XL.mlstm_block_decode(p["mlstm"], cfg, x, cache)
        return x + delta, st
    if kind == "slstm":
        delta, st = XL.slstm_block_decode(p["slstm"], cfg, x, cache)
        return x + delta, st
    if kind == "rglru":
        delta, st = RG.rglru_block_decode(p["rglru"], cfg, x, cache)
        return _ffn(p, x + delta), st
    raise ValueError(kind)


def init_block_cache(kind: str, cfg: ModelConfig, batch: int,
                     spec: L.CacheSpec, device=None) -> dict:
    if kind in ("attn", "moe"):
        return L.init_kv_cache(cfg, batch, spec, device)
    if kind == "local_attn":
        # rolling window: W slots and their absolute positions
        W = min(cfg.local_window or spec.seq_len, spec.seq_len)
        c = L.init_kv_cache(cfg, batch, L.CacheSpec(W, spec.dtype), device)
        c["pos_ids"] = torch.full((W,), -1, dtype=torch.int32, device=device)
        return c
    if kind == "mlstm":
        return XL.init_mlstm_state(cfg, batch, device)
    if kind == "slstm":
        return XL.init_slstm_state(cfg, batch, device)
    if kind == "rglru":
        return RG.init_rglru_state(cfg, batch, device)
    raise ValueError(kind)


# ----------------------------------------------------------------------- model

def _params(shapes: dict, dtype, device, grad: bool) -> nn.ParameterDict:
    return nn.ParameterDict({
        k: nn.Parameter(torch.zeros(s, dtype=dtype, device=device),
                        requires_grad=grad) for k, s in shapes.items()})


class Block(nn.Module):
    """One layer of `kind`: its parts as `ParameterDict`s named as the
    reference names them (`blk.attn`, `blk.mlp`, `blk.moe`, ...); a part the
    kind lacks is None."""

    PARTS = ("attn", "mlp", "moe", "mlstm", "slstm", "rglru")

    def __init__(self, kind: str, cfg: ModelConfig, dtype, device, grad: bool):
        super().__init__()
        self.kind = kind
        parts = block_parts(kind, cfg)
        for part in self.PARTS:
            setattr(self, part, _params(parts[part], dtype, device, grad)
                    if part in parts else None)

    def parts(self) -> dict[str, nn.ParameterDict]:
        return {part: getattr(self, part) for part in self.PARTS
                if getattr(self, part) is not None}


class LM(nn.Module):
    """The port's decoder-only LM on `device` (the card by default).  With
    `train=True` its parameters are masters in `param_dtype` that require
    grad (for `loss`); otherwise the compute-dtype copies serving uses."""

    def __init__(self, cfg: ModelConfig, device="cuda", train: bool = False):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = L.torch_dtype(cfg.compute_dtype)
        pdt = L.torch_dtype(cfg.param_dtype) if train else self.dtype
        D = cfg.d_model
        self.embed = _params({"embedding": (cfg.padded_vocab(), D)},
                             pdt, self.device, train)
        self.final_ln = nn.Parameter(
            torch.zeros((D,), dtype=pdt, device=self.device),
            requires_grad=train)
        if cfg.input_mode == "embeddings":
            self.in_proj = nn.Parameter(
                torch.zeros((D, D), dtype=pdt, device=self.device),
                requires_grad=train)
        pattern = cfg.block_pattern
        self.blocks = nn.ModuleList(
            Block(pattern[i % len(pattern)], cfg, pdt, self.device, train)
            for i in range(cfg.num_layers))

    # -- params -----------------------------------------------------------

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "LM":
        """Random weights from `generator`: the distributions of the
        reference's `LM.init`."""
        cfg = self.cfg
        self.embed["embedding"].copy_(L.init_embed(generator, cfg)
                                      ["embedding"])
        self.final_ln.zero_()
        if cfg.input_mode == "embeddings":
            self.in_proj.copy_(L.dense_init(generator, (cfg.d_model,
                                                        cfg.d_model)))
        for blk in self.blocks:
            for part, params in blk.parts().items():
                kw = ({"dtype": params["expert_wi"].dtype} if part == "moe"
                      else {})
                for k, t in _INIT[part](generator, cfg, **kw).items():
                    params[k].copy_(t)
        return self

    def load_params(self, state: dict[str, torch.Tensor]) -> "LM":
        """Load a state dict of f32 tensors (cast to the parameters'
        dtype)."""
        self.load_state_dict(state, strict=True)
        return self

    # -- shared forward ----------------------------------------------------

    def _cast(self, params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """Every floating parameter in the compute dtype (the reference's
        `_cast`; differentiable, and the same tensor where it already is)."""
        return {k: p.to(self.dtype) if p.is_floating_point() else p
                for k, p in params.items()}

    def _block_params(self, p: dict, i: int) -> dict:
        return {part: {n: p[f"blocks.{i}.{part}.{n}"] for n in params}
                for part, params in self.blocks[i].parts().items()}

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        t = torch.as_tensor(a, device=self.device)
        return t.to(dtype) if dtype is not None else t

    def _embed_inputs(self, p: dict, batch) -> torch.Tensor:
        """(B,S,D) in the compute dtype: token embeddings or
        embeddings @ in_proj; p holds "embed.embedding" (and "in_proj")."""
        if self.cfg.input_mode == "embeddings":
            return self._tensor(batch["embeddings"], self.dtype) @ p["in_proj"]
        tokens = self._tensor(batch["tokens"]).long()
        return L.embed({"embedding": p["embed.embedding"]},
                       tokens).to(self.dtype)

    def _inputs_own(self) -> dict[str, torch.Tensor]:
        """The serving parameters `_embed_inputs` reads."""
        own = {"embed.embedding": self.embed["embedding"]}
        if self.cfg.input_mode == "embeddings":
            own["in_proj"] = self.in_proj
        return own

    def _positions(self, batch, x) -> torch.Tensor:
        """(B,S) positions of x (B,S,D), or (3,B,S) for M-RoPE; laid out
        like the batch when x is a DTensor under a mesh."""
        B, S = x.shape[:2]
        if self.cfg.mrope:
            if batch.get("positions") is not None:
                return self._tensor(batch["positions"]).long()
            pos = torch.arange(S, device=self.device)
            return sharding.constant(pos[None, None].expand(3, B, S), x,
                                     None, "batch", "seq")
        pos = torch.arange(S, device=self.device)[None].expand(B, S)
        return sharding.constant(pos, x, "batch", "seq")

    def _period_end(self, i: int, x):
        """The reference's constraint at the end of each super-block (one
        period of the pattern)."""
        if (i + 1) % len(self.cfg.block_pattern):
            return x
        return sharding.act(x, "batch", "seq", "dmodel")

    # -- train ---------------------------------------------------------------

    def loss(self, batch, params: dict[str, torch.Tensor] | None = None):
        """Mean next-token cross-entropy of `batch` ({"tokens"} or
        {"embeddings"}, optional M-RoPE "positions", and "labels" (B,S))
        under `params`, a state dict of this model's names (its own
        parameters by default): the reference's `LM.loss`.  Differentiable
        in `params`."""
        cfg = self.cfg
        if params is None:
            params = dict(self.named_parameters())
        p = self._cast(params)
        x = self._embed_inputs(p, batch)
        positions = self._positions(batch, x)
        labels = self._tensor(batch["labels"]).long()
        for i, blk in enumerate(self.blocks):
            bp = self._block_params(p, i)
            if cfg.remat == "block":
                x = checkpoint(apply_block, blk.kind, bp, cfg, x, positions,
                               use_reentrant=False,
                               context_fn=sharding.checkpoint_context)
            else:
                x = apply_block(blk.kind, bp, cfg, x, positions)
            x = self._period_end(i, x)
        x = L.rmsnorm(x, p["final_ln"])
        return L.softmax_xent({"embedding": p["embed.embedding"]}, x, labels,
                              cfg.vocab_size)

    # -- serve ---------------------------------------------------------------

    def cache_spec(self, seq_len: int) -> L.CacheSpec:
        return L.CacheSpec(seq_len, self.cfg.kv_cache_dtype)

    def init_cache(self, batch: int, seq_len: int) -> list[dict]:
        spec = self.cache_spec(seq_len)
        return [init_block_cache(blk.kind, self.cfg, batch, spec, self.device)
                for blk in self.blocks]

    def _serve_params(self, params):
        """(inputs, each layer's parts, final_ln, embed) of the serving
        parameters: the model's own, or a state dict `params` of its names
        cast to the compute dtype (DTensors under a mesh, for the
        dry-run)."""
        if params is None:
            return (self._inputs_own(), [blk.parts() for blk in self.blocks],
                    self.final_ln, self.embed)
        p = self._cast(params)
        return (p, [self._block_params(p, i) for i in range(len(self.blocks))],
                p["final_ln"], {"embedding": p["embed.embedding"]})

    @torch.no_grad()
    def prefill(self, batch, params=None) -> tuple[torch.Tensor, list[dict]]:
        """Full-sequence forward that also produces the decode cache.
        Returns logits (B,1,V) at the last position and one cache entry per
        layer.  `params`: a state dict to serve instead of the model's
        own."""
        own, parts, final_ln, emb = self._serve_params(params)
        x = self._embed_inputs(own, batch)
        positions = self._positions(batch, x)
        spec = self.cache_spec(x.shape[1])
        cache = []
        for i, blk in enumerate(self.blocks):
            x, c = apply_block_prefill(blk.kind, parts[i], self.cfg, x,
                                       positions, spec)
            x = self._period_end(i, x)
            cache.append(c)
        x = L.rmsnorm(x, final_ln)
        return L.unembed_logits(emb, x[:, -1:]), cache

    @torch.no_grad()
    def decode_step(self, cache: list[dict], batch, pos: int,
                    params=None) -> tuple[torch.Tensor, list[dict]]:
        """batch: {"tokens": (B,1)} or {"embeddings": (B,1,D)}; pos: the
        position written.  Returns (logits (B,1,V), the cache: KV caches
        updated in place, recurrent states replaced in the list).
        `params`: as in `prefill`."""
        own, parts, final_ln, emb = self._serve_params(params)
        x = self._embed_inputs(own, batch)
        pos = int(pos)
        for i, blk in enumerate(self.blocks):
            x, cache[i] = apply_block_decode(blk.kind, parts[i], self.cfg,
                                             x, cache[i], pos)
        x = L.rmsnorm(x, final_ln)
        return L.unembed_logits(emb, x), cache
