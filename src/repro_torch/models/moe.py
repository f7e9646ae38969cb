"""Mixture-of-Experts block (the port of `repro.models.moe`, its local path).

Top-k routing with capacity-bounded per-expert token gathering, so the work
stays proportional to the active parameters.  Two paths, chosen as the
reference chooses them:

  * masked-dense (T <= 512 tokens: every decode step and a small prefill):
    every expert on every token, combined by the routing weights;
  * gathered (T > 512): each expert takes its top-C tokens by routing weight,
    C = min(round(2 T k / E), T), runs its FFN on the (C, D) gather, and the
    outputs are combined back per token.

The reference's shard-map path (experts over the "model" mesh axis) waits
for `parallel/sharding.py`; on one card there is no mesh, so the reference
itself takes the local path.  The expert products stay `torch.matmul` /
`torch.bmm`: the reference computes them with `@` under `vmap`, outside any
Pallas kernel.

Ties.  `jax.lax.top_k` puts the lower index first among equal values, and
with top-1 routing (llama4) every routing weight is the same 1/(1+1e-9), so
which tokens an overflowing expert keeps is decided by tie order alone.  The
port takes a stable descending sort wherever the reference takes `top_k`.

Determinism.  The reference combines by scatter-add (`out.at[idx].add`) and
its gather's backward is a scatter-add too; on the card these would be
atomics whose f32 sums change from call to call.  The port scatters nothing
with repeated indices: each token reads back the (at most k) expert slots
that kept it, through an inverse map, and sums them in a fixed order; the
token gather's backward (`_TakeRows`) does the same in reverse.  Filler slots
(an expert with fewer than C routed tokens fills its top-C with tokens of
weight 0) are never read back, so their gradient is exactly the zero the
reference's scatter adds.

`STATS` counts the calls of each path and, once `STATS.reset()` has been
called, the experts that overflowed (received more than C tokens) in
gathered calls; the overflow count stays on the device until read.  Until
then the gathered path computes no overflow count.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init, rmsnorm

_CAPACITY_FACTOR = 2.0
_DENSE_PATH_MAX_TOKENS = 512


class MoEStats:
    """Calls of each path and experts that overflowed, since `reset`; the
    overflow is counted only after a first `reset`."""

    def __init__(self):
        self.masked = 0
        self.gathered = 0
        self.counting = False
        self._overflowed = 0

    def reset(self) -> None:
        self.__init__()
        self.counting = True

    def add_overflow(self, counts: torch.Tensor, C: int) -> None:
        """counts: tokens routed to each expert in one gathered call."""
        self._overflowed = self._overflowed + (counts > C).sum()

    def read(self) -> dict:
        return {"masked": self.masked, "gathered": self.gathered,
                "overflowed_experts": int(self._overflowed)}


STATS = MoEStats()


def shapes(cfg: ModelConfig) -> dict[str, tuple]:
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {"ln": (D,), "router": (D, E), "expert_wi": (E, D, 2 * Fd),
            "expert_wo": (E, Fd, D)}


def init_moe(generator, cfg: ModelConfig,
             dtype=torch.float32) -> dict[str, torch.Tensor]:
    """The reference's distributions.  The expert weights are drawn one
    expert at a time straight into `dtype`, so that a model whose experts
    hold tens of GB (llama4's are 43 GB in f32 a layer) is drawn without an
    f32 copy of them."""
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.num_experts

    def experts(shape, scale=None):
        out = torch.empty((E, *shape), dtype=dtype, device=generator.device)
        for e in range(E):
            out[e] = dense_init(generator, shape, scale)
        return out

    return {"ln": torch.zeros((D,)),
            "router": dense_init(generator, (D, E)),
            "expert_wi": experts((D, 2 * Fd)),
            "expert_wo": experts((Fd, D), scale=Fd ** -0.5)}


def _expert_ffn(wi, wo, x):
    """SwiGLU of each expert: wi (E,D,2F), wo (E,F,D), x (T,D) or (E,C,D)
    -> (E, T or C, D)."""
    gate, up = torch.chunk(torch.matmul(x, wi), 2, dim=-1)
    return torch.matmul(F.silu(gate) * up, wo)


def capacity(T: int, k: int, E: int) -> int:
    """Tokens an expert takes on the gathered path: Python's round (half to
    even), as in the reference."""
    return min(int(max(1, round(_CAPACITY_FACTOR * T * k / E))), T)


def _sorted_top(x, n: int):
    """(values, indices) of the n largest along the last axis, descending,
    the lower index first among ties (`jax.lax.top_k`'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :n], idx[..., :n]


def moe_block(p, cfg: ModelConfig, x):
    """x: (B, S, D) -> (B, S, D)."""
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.top_k
    T = B * S
    h = rmsnorm(x, p["ln"]).reshape(T, D)
    probs = torch.softmax((h @ p["router"]).float(), dim=-1)       # (T, E)
    topw, topi = _sorted_top(probs, k)                              # (T, k)
    topw = topw / (torch.sum(topw, dim=-1, keepdim=True) + 1e-9)
    # combine weight per (token, expert): the k experts are distinct
    w_te = torch.zeros((T, E), dtype=torch.float32,
                       device=x.device).scatter(1, topi, topw)
    if T <= _DENSE_PATH_MAX_TOKENS:
        STATS.masked += 1
        out = _masked_dense(p, h, w_te)
    else:
        STATS.gathered += 1
        out = _gathered(p, h, w_te, topi, E, k)
    return out.reshape(B, S, D).to(x.dtype)


def _masked_dense(p, h, w_te):
    ys = _expert_ffn(p["expert_wi"], p["expert_wo"], h)            # (E, T, D)
    return torch.einsum("te,etd->td", w_te, ys.float())


class _TakeRows(torch.autograd.Function):
    """h[idx] (idx (N,), repeats allowed) whose backward reads back instead
    of scattering: row t of the gradient sums, in a fixed order, the rows
    `back` (T, k) names (E*C, a zero row, where a slot kept nothing)."""

    @staticmethod
    def forward(ctx, h, idx, back):
        ctx.save_for_backward(back)
        return h[idx]

    @staticmethod
    def backward(ctx, grad):
        (back,) = ctx.saved_tensors
        padded = torch.cat([grad, grad.new_zeros((1, grad.shape[1]))])
        return padded[back].sum(dim=1), None, None


def _gathered(p, h, w_te, topi, E: int, k: int):
    T, D = h.shape
    C = capacity(T, k, E)
    if STATS.counting:
        STATS.add_overflow((w_te > 0).sum(dim=0), C)
    # top-C tokens per expert by routing weight; zeros fill a short list
    gather_w, gather_idx = _sorted_top(w_te.T, C)                   # (E, C)
    # inverse map: the slot of token t in expert e's list, -1 if not kept
    slot = torch.full((E, T), -1, dtype=torch.long, device=h.device)
    slot.scatter_(1, gather_idx, torch.arange(C, device=h.device)
                  .expand(E, C).contiguous())
    # each token's k (expert, slot) pairs in expert order, as the
    # reference's scatter-add sums them
    experts, _ = torch.sort(topi, dim=-1)                           # (T, k)
    kept = slot[experts, torch.arange(T, device=h.device)[:, None]]  # (T, k)
    back = torch.where(kept >= 0, experts * C + kept, E * C)
    toks = _TakeRows.apply(h, gather_idx.reshape(-1), back).reshape(E, C, D)
    ys = _expert_ffn(p["expert_wi"], p["expert_wo"], toks)          # (E, C, D)
    ys = ys.float() * gather_w[..., None]
    ys = torch.cat([ys.reshape(E * C, D), ys.new_zeros((1, D))])
    return ys[back].sum(dim=1)
