"""Encoder-decoder backbone (SeamlessM4T): the port of
`repro.models.encdec.EncDecLM`, as an `nn.Module`.

The speech frontend is a stub: the encoder consumes precomputed frame
embeddings (B, S_src, D) through `in_proj` plus a learned `pos_embed`, with
bidirectional attention (plain `_sdpa` on an all-true mask).  Decoder
layers: causal self-attention (`full_seq_sdpa`: kernel K3 on the card),
cross-attention on K/V computed from the encoder output (plain `_sdpa`),
and the SwiGLU MLP.

Parameters carry the reference's names: `embed.embedding`, `in_proj`,
`pos_embed`, `final_ln`, `enc_final_ln`, `encoder.<l>.{attn,mlp}.*` and
`decoder.<l>.{self_attn,cross_attn,mlp}.*` (`convert.
encdec_params_from_reference`).  As in `LM`, serving holds the compute-dtype
copy and `train=True` holds masters that `loss` casts on every call, under
block remat.  The decode cache is (one {"self": KV cache} a decoder layer,
the encoder output).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.lm import _attention_shapes, _mlp_shapes, _params
from repro_torch.parallel import sharding

POS_EMBED_ROWS = 32768


class EncoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device, grad: bool):
        super().__init__()
        self.attn = _params(_attention_shapes(cfg), dtype, device, grad)
        self.mlp = _params(_mlp_shapes(cfg), dtype, device, grad)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device, grad: bool):
        super().__init__()
        self.self_attn = _params(_attention_shapes(cfg), dtype, device, grad)
        self.cross_attn = _params(_attention_shapes(cfg), dtype, device, grad)
        self.mlp = _params(_mlp_shapes(cfg), dtype, device, grad)


def _encoder_layer(cfg: ModelConfig, p: dict, h, positions):
    """Bidirectional attention (no causal mask) and the MLP."""
    B, S, _ = h.shape
    q, k, v = L._qkv(p["attn"], cfg, h, positions)
    mask = torch.ones((1, 1, S, S), dtype=torch.bool, device=h.device)
    att = L.sdpa(q, k, v, mask, cfg.q_per_kv) @ p["attn"]["wo"]
    h = h + sharding.act(att, "batch", "seq", "dmodel")
    return h + L.mlp(p["mlp"], h)


def _enc_kv(cfg: ModelConfig, p: dict, enc_out):
    B, S, _ = enc_out.shape
    k = L._split_heads(enc_out @ p["wk"], cfg.num_kv_heads, cfg.head_dim)
    v = L._split_heads(enc_out @ p["wv"], cfg.num_kv_heads, cfg.head_dim)
    return k, v


def _cross(cfg: ModelConfig, p: dict, h, enc_out):
    """Cross-attention of h on the encoder output's K/V."""
    B, S, _ = h.shape
    q = L._split_heads(L.rmsnorm(h, p["ln"]) @ p["wq"], cfg.num_heads,
                       cfg.head_dim)
    k, v = _enc_kv(cfg, p, enc_out)
    mask = torch.ones((1, 1, S, k.shape[1]), dtype=torch.bool,
                      device=h.device)
    out = L.sdpa(q, k, v, mask, cfg.q_per_kv) @ p["wo"]
    return sharding.act(out, "batch", "seq", "dmodel")


def _decoder_layer(cfg: ModelConfig, p: dict, h, positions, enc_out):
    q, k, v = L._qkv(p["self_attn"], cfg, h, positions)
    att = L.full_seq_sdpa(cfg, q, k, v, 0) @ p["self_attn"]["wo"]
    h = h + sharding.act(att, "batch", "seq", "dmodel")
    h = h + _cross(cfg, p["cross_attn"], h, enc_out)
    return h + L.mlp(p["mlp"], h)


def _parts(layer: nn.Module) -> dict:
    return dict(layer.named_children())


class EncDecLM(nn.Module):
    """The port's encoder-decoder on `device` (the card by default)."""

    def __init__(self, cfg: ModelConfig, device="cuda", train: bool = False):
        super().__init__()
        if cfg.encoder_layers <= 0:
            raise ValueError(f"{cfg.name}: an encoder-decoder needs "
                             "encoder_layers > 0")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = L.torch_dtype(cfg.compute_dtype)
        pdt = L.torch_dtype(cfg.param_dtype) if train else self.dtype
        D = cfg.d_model

        def param(shape):
            return nn.Parameter(torch.zeros(shape, dtype=pdt,
                                            device=self.device),
                                requires_grad=train)

        self.embed = _params({"embedding": (cfg.padded_vocab(), D)}, pdt,
                             self.device, train)
        self.in_proj = param((D, D))
        self.pos_embed = param((POS_EMBED_ROWS, D))
        self.final_ln = param((D,))
        self.enc_final_ln = param((D,))
        self.encoder = nn.ModuleList(
            EncoderLayer(cfg, pdt, self.device, train)
            for _ in range(cfg.encoder_layers))
        self.decoder = nn.ModuleList(
            DecoderLayer(cfg, pdt, self.device, train)
            for _ in range(cfg.num_layers))

    # -- params -----------------------------------------------------------

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "EncDecLM":
        """Random weights from `generator`: the reference's
        distributions."""
        cfg = self.cfg
        D = cfg.d_model
        self.embed["embedding"].copy_(L.init_embed(generator, cfg)
                                      ["embedding"])
        self.in_proj.copy_(L.dense_init(generator, (D, D)))
        self.pos_embed.copy_(L.dense_init(generator, (POS_EMBED_ROWS, D),
                                          scale=0.02))
        self.final_ln.zero_()
        self.enc_final_ln.zero_()
        for layer in [*self.encoder, *self.decoder]:
            for name, params in layer.named_children():
                init = L.init_mlp if name == "mlp" else L.init_attention
                for k, t in init(generator, cfg).items():
                    params[k].copy_(t)
        return self

    def load_params(self, state: dict[str, torch.Tensor]) -> "EncDecLM":
        self.load_state_dict(state, strict=True)
        return self

    def _cast(self, params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        return {k: p.to(self.dtype) if p.is_floating_point() else p
                for k, p in params.items()}

    def _positions(self, B: int, S: int) -> torch.Tensor:
        return torch.arange(S, device=self.device)[None].expand(B, S)

    def _layer_params(self, p: dict, stack: str, i: int) -> dict:
        layer = getattr(self, stack)[i]
        return {part: {n: p[f"{stack}.{i}.{part}.{n}"] for n in params}
                for part, params in layer.named_children()}

    # -- encoder and decoder --------------------------------------------------

    def _encode(self, p: dict, src, layers) -> torch.Tensor:
        """layers: each encoder layer's {part: params}."""
        cfg = self.cfg
        src = torch.as_tensor(src, device=self.device).to(self.dtype)
        x = src @ p["in_proj"]
        S = x.shape[1]
        x = x + p["pos_embed"][:S][None].to(self.dtype)
        positions = self._positions(x.shape[0], S)
        for lp in layers:
            if cfg.remat == "block" and torch.is_grad_enabled():
                x = checkpoint(_encoder_layer, cfg, lp, x, positions,
                               use_reentrant=False,
                               context_fn=sharding.checkpoint_context)
            else:
                x = _encoder_layer(cfg, lp, x, positions)
        return L.rmsnorm(x, p["enc_final_ln"])

    def _decoder_inputs(self, p: dict, tokens):
        tokens = torch.as_tensor(tokens, device=self.device).long()
        x = L.embed({"embedding": p["embed.embedding"]},
                    tokens).to(self.dtype)
        S = x.shape[1]
        return x + p["pos_embed"][:S][None].to(self.dtype)

    def _serving(self) -> dict[str, torch.Tensor]:
        return {"embed.embedding": self.embed["embedding"],
                "in_proj": self.in_proj, "pos_embed": self.pos_embed,
                "enc_final_ln": self.enc_final_ln}

    @torch.no_grad()
    def encode(self, src_embeddings) -> torch.Tensor:
        return self._encode(self._serving(), src_embeddings,
                            [_parts(lay) for lay in self.encoder])

    # -- public API -----------------------------------------------------------

    def loss(self, batch, params: dict[str, torch.Tensor] | None = None):
        """Mean next-token cross-entropy of the decoder on {"src_embeddings",
        "tokens", "labels"} under `params` (this model's state-dict names;
        its own parameters by default).  Differentiable in `params`."""
        cfg = self.cfg
        if params is None:
            params = dict(self.named_parameters())
        p = self._cast(params)
        enc_out = self._encode(
            p, batch["src_embeddings"],
            [self._layer_params(p, "encoder", i)
             for i in range(cfg.encoder_layers)])
        x = self._decoder_inputs(p, batch["tokens"])
        positions = self._positions(*x.shape[:2])
        for i in range(cfg.num_layers):
            lp = self._layer_params(p, "decoder", i)
            if cfg.remat == "block":
                x = checkpoint(_decoder_layer, cfg, lp, x, positions, enc_out,
                               use_reentrant=False,
                               context_fn=sharding.checkpoint_context)
            else:
                x = _decoder_layer(cfg, lp, x, positions, enc_out)
        x = L.rmsnorm(x, p["final_ln"])
        labels = torch.as_tensor(batch["labels"], device=self.device).long()
        return L.softmax_xent({"embedding": p["embed.embedding"]}, x, labels,
                              cfg.vocab_size)

    def cache_spec(self, seq_len: int) -> L.CacheSpec:
        return L.CacheSpec(seq_len, self.cfg.kv_cache_dtype)

    def init_cache(self, batch: int, seq_len: int) -> list[dict]:
        spec = self.cache_spec(seq_len)
        return [{"self": L.init_kv_cache(self.cfg, batch, spec, self.device)}
                for _ in self.decoder]

    def _serve_params(self, params):
        """(the top-level parameters, encoder layers' parts, decoder
        layers' parts) of the model's own parameters or of a state dict
        `params` of its names (cast to the compute dtype)."""
        if params is None:
            top = dict(self._serving(), final_ln=self.final_ln)
            return (top, [_parts(lay) for lay in self.encoder],
                    [_parts(lay) for lay in self.decoder])
        p = self._cast(params)
        return (p, [self._layer_params(p, "encoder", i)
                    for i in range(len(self.encoder))],
                [self._layer_params(p, "decoder", i)
                 for i in range(len(self.decoder))])

    @torch.no_grad()
    def prefill(self, batch, params=None):
        """Encode {"src_embeddings"} and prefill the decoder's self-attention
        cache on {"tokens"} (B,S).  Returns (logits (B,1,V) at the last
        position, (cache, encoder output)).  `params`: a state dict to serve
        instead of the model's own."""
        cfg = self.cfg
        top, enc_layers, dec_layers = self._serve_params(params)
        enc_out = self._encode(top, batch["src_embeddings"], enc_layers)
        x = self._decoder_inputs(top, batch["tokens"])
        B, S = x.shape[:2]
        positions = self._positions(B, S)
        spec = self.cache_spec(S)
        cache = []
        for lp in dec_layers:
            delta, c = L.attention_prefill(lp["self_attn"], cfg, x, positions,
                                           0, spec)
            x = x + delta
            x = x + _cross(cfg, lp["cross_attn"], x, enc_out)
            x = x + L.mlp(lp["mlp"], x)
            cache.append({"self": c})
        x = L.rmsnorm(x, top["final_ln"])
        emb = {"embedding": top["embed.embedding"]}
        return L.unembed_logits(emb, x[:, -1:]), (cache, enc_out)

    @torch.no_grad()
    def decode_step(self, cache_and_enc, batch, pos: int, params=None):
        """batch: {"tokens": (B,1)}; pos: the position written (the
        positional embedding's row is clamped to its last).  Returns (logits
        (B,1,V), (cache, encoder output)); the KV caches are written in
        place.  `params`: as in `prefill`."""
        cfg = self.cfg
        cache, enc_out = cache_and_enc
        top, _, dec_layers = self._serve_params(params)
        pos = int(pos)
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        emb = {"embedding": top["embed.embedding"]}
        x = L.embed(emb, tokens).to(self.dtype)
        pidx = min(pos, top["pos_embed"].shape[0] - 1)
        x = x + top["pos_embed"][pidx:pidx + 1][None].to(self.dtype)
        for lp, c in zip(dec_layers, cache):
            delta, c["self"] = L.attention_decode(lp["self_attn"], cfg, x,
                                                  c["self"], pos)
            x = x + delta
            x = x + _cross(cfg, lp["cross_attn"], x, enc_out)
            x = x + L.mlp(lp["mlp"], x)
        x = L.rmsnorm(x, top["final_ln"])
        return L.unembed_logits(emb, x), (cache, enc_out)
