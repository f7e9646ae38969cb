"""Decoder-only LM of attention blocks (the dense subset of
`repro.models.lm.LM`), as an `nn.Module`.

The reference stacks parameters over super-blocks and scans; the port keeps
one module per layer.  The reference holds f32 parameters and casts them to
the compute dtype on every call (`_cast`).  For serving the port holds the
cast copy once (the same round-to-nearest-even), on the model's device, with
no gradient.  A model built with `train=True` holds f32 master parameters
that require grad, and `loss` casts them to the compute dtype on every call,
as `_cast` does; under `remat == "block"` each block runs under
`torch.utils.checkpoint` (non-reentrant), so its activations are recomputed
in the backward pass -- K3's forward runs twice a block a step, K3-bwd once.
`init` draws the reference's distributions from a `torch.Generator` on the
CPU, so one seed gives the same weights on the card and on the host;
`load_params` takes a state dict of f32 tensors such as
`convert.lm_params_from_reference` makes.

Only blocks of kind `attn` with token inputs and plain RoPE are ported; the
others raise `NotImplementedError` (see ROADMAP.md).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for what the port does not run yet."""
    todo = [k for k in cfg.block_pattern if k != "attn"]
    if todo:
        raise NotImplementedError(
            f"{cfg.name}: block kinds {sorted(set(todo))} are not ported yet; "
            "only 'attn' blocks run (ROADMAP.md)")
    if cfg.family == "encdec" or cfg.encoder_layers:
        raise NotImplementedError(f"{cfg.name}: the encoder-decoder family is "
                                  "not ported yet (ROADMAP.md)")
    if cfg.input_mode != "tokens":
        raise NotImplementedError(f"{cfg.name}: input_mode="
                                  f"{cfg.input_mode!r} is not ported yet "
                                  "(ROADMAP.md)")
    if cfg.mrope:
        raise NotImplementedError(f"{cfg.name}: M-RoPE is not ported yet "
                                  "(ROADMAP.md)")


def _params(shapes: dict, dtype, device, grad: bool) -> nn.ParameterDict:
    return nn.ParameterDict({
        k: nn.Parameter(torch.zeros(s, dtype=dtype, device=device),
                        requires_grad=grad) for k, s in shapes.items()})


class Block(nn.Module):
    """One `attn` block: attention and (if d_ff > 0) the SwiGLU MLP."""

    def __init__(self, cfg: ModelConfig, dtype, device, grad: bool):
        super().__init__()
        D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        attn = {"ln": (D,), "wq": (D, H * hd), "wk": (D, KV * hd),
                "wv": (D, KV * hd), "wo": (H * hd, D)}
        if cfg.qk_norm:
            attn.update(q_norm=(hd,), k_norm=(hd,))
        self.attn = _params(attn, dtype, device, grad)
        self.mlp = (_params({"ln": (D,), "wi_mlp_up": (D, 2 * cfg.d_ff),
                             "wo_mlp": (cfg.d_ff, D)}, dtype, device, grad)
                    if cfg.d_ff > 0 else None)


def _block(cfg: ModelConfig, attn: dict, mlp: dict | None, x, positions):
    """One block's forward on its cast parameters (`apply_block`)."""
    x = x + L.attention(attn, cfg, x, positions)
    if mlp is not None:
        x = x + L.mlp(mlp, x)
    return x


class LM(nn.Module):
    """The port's decoder-only LM on `device` (the card by default).  With
    `train=True` its parameters are f32 masters that require grad (for
    `loss`); otherwise the compute-dtype copies serving uses."""

    def __init__(self, cfg: ModelConfig, device="cuda", train: bool = False):
        super().__init__()
        check_supported(cfg)
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
        self.blocks = nn.ModuleList(Block(cfg, pdt, self.device, train)
                                    for _ in range(cfg.num_layers))

    # -- params -----------------------------------------------------------

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "LM":
        """Random weights from `generator` (a CPU generator): the
        distributions of the reference's `LM.init`."""
        self.embed["embedding"].copy_(L.init_embed(generator, self.cfg)
                                      ["embedding"])
        self.final_ln.zero_()
        for blk in self.blocks:
            for k, t in L.init_attention(generator, self.cfg).items():
                blk.attn[k].copy_(t)
            if blk.mlp is not None:
                for k, t in L.init_mlp(generator, self.cfg).items():
                    blk.mlp[k].copy_(t)
        return self

    def load_params(self, state: dict[str, torch.Tensor]) -> "LM":
        """Load a state dict of f32 tensors (cast to the parameters'
        dtype)."""
        self.load_state_dict(state, strict=True)
        return self

    # -- train ---------------------------------------------------------------

    def _cast(self, params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """Every floating parameter in the compute dtype (the reference's
        `_cast`; differentiable, and the same tensor where it already is)."""
        return {k: p.to(self.dtype) if p.is_floating_point() else p
                for k, p in params.items()}

    def loss(self, batch, params: dict[str, torch.Tensor] | None = None):
        """Mean next-token cross-entropy of batch {"tokens", "labels"} (B,S)
        under `params`, a state dict of this model's names (its own
        parameters by default): the reference's `LM.loss`.  Differentiable
        in `params`."""
        cfg = self.cfg
        if params is None:
            params = dict(self.named_parameters())
        p = self._cast(params)
        tokens = self._tokens(batch)
        labels = torch.as_tensor(batch["labels"], device=self.device).long()
        B, S = tokens.shape
        embed = {"embedding": p["embed.embedding"]}
        x = L.embed(embed, tokens).to(self.dtype)
        positions = torch.arange(S, device=self.device)[None].expand(B, S)
        for i, blk in enumerate(self.blocks):
            attn = {n: p[f"blocks.{i}.attn.{n}"] for n in blk.attn}
            mlp = (None if blk.mlp is None else
                   {n: p[f"blocks.{i}.mlp.{n}"] for n in blk.mlp})
            if cfg.remat == "block":
                x = checkpoint(_block, cfg, attn, mlp, x, positions,
                               use_reentrant=False)
            else:
                x = _block(cfg, attn, mlp, x, positions)
        x = L.rmsnorm(x, p["final_ln"])
        return L.softmax_xent(embed, x, labels, cfg.vocab_size)

    # -- serve ---------------------------------------------------------------

    def _tokens(self, batch) -> torch.Tensor:
        return torch.as_tensor(batch["tokens"], device=self.device).long()

    def cache_spec(self, seq_len: int) -> L.CacheSpec:
        return L.CacheSpec(seq_len, self.cfg.kv_cache_dtype)

    def init_cache(self, batch: int, seq_len: int) -> list[dict]:
        spec = self.cache_spec(seq_len)
        return [L.init_kv_cache(self.cfg, batch, spec, self.device)
                for _ in self.blocks]

    @torch.no_grad()
    def prefill(self, batch) -> tuple[torch.Tensor, list[dict]]:
        """Full-sequence forward that also produces the decode cache.
        batch: {"tokens": (B,S)}.  Returns logits (B,1,V) at the last
        position and one cache dict per layer."""
        cfg = self.cfg
        tokens = self._tokens(batch)
        B, S = tokens.shape
        x = L.embed(self.embed, tokens).to(self.dtype)
        positions = torch.arange(S, device=self.device)[None].expand(B, S)
        spec = self.cache_spec(S)
        cache = []
        for blk in self.blocks:
            delta, c = L.attention_prefill(blk.attn, cfg, x, positions, 0, spec)
            x = x + delta
            if blk.mlp is not None:
                x = x + L.mlp(blk.mlp, x)
            cache.append(c)
        x = L.rmsnorm(x, self.final_ln)
        return L.unembed_logits(self.embed, x[:, -1:]), cache

    @torch.no_grad()
    def decode_step(self, cache: list[dict], batch,
                    pos: int) -> tuple[torch.Tensor, list[dict]]:
        """batch: {"tokens": (B,1)}; pos: the position written.  Updates the
        cache in place and returns (logits (B,1,V), cache)."""
        cfg = self.cfg
        x = L.embed(self.embed, self._tokens(batch)).to(self.dtype)
        pos = int(pos)
        for blk, c in zip(self.blocks, cache):
            delta, _ = L.attention_decode(blk.attn, cfg, x, c, pos)
            x = x + delta
            if blk.mlp is not None:
                x = x + L.mlp(blk.mlp, x)
        x = L.rmsnorm(x, self.final_ln)
        return L.unembed_logits(self.embed, x), cache
