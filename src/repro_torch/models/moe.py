"""Mixture-of-Experts block (the port of `repro.models.moe`, its local path).

Top-k routing with capacity-bounded per-expert token gathering, so the work
stays proportional to the active parameters.  Two paths, chosen as the
reference chooses them:

  * masked-dense (T <= 512 tokens: every decode step and a small prefill):
    every expert on every token, combined by the routing weights;
  * gathered (T > 512): each expert takes its top-C tokens by routing weight,
    C = min(round(2 T k / E), T), runs its FFN on the (C, D) gather, and the
    outputs are combined back per token.

Under an active mesh the reference runs a shard-map path (experts over the
"model" mesh axis); the port's is `_moe_block_shardmap`, which runs the
gathered path's selection on each rank's experts.  The expert products stay `torch.matmul` /
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
from repro_torch.parallel import sharding

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


def _route(ln, router, x, k: int):
    """(h (T, D), w_te (T, E) f32, topi (T, k)): the normed tokens, each
    token's combine weight per expert (its renormalised top-k routing
    weights; the k experts are distinct) and its k experts."""
    D = x.shape[-1]
    h = rmsnorm(x, ln).reshape(-1, D)
    probs = torch.softmax((h @ router).float(), dim=-1)            # (T, E)
    topw, topi = _sorted_top(probs, k)                              # (T, k)
    topw = topw / (torch.sum(topw, dim=-1, keepdim=True) + 1e-9)
    w_te = torch.zeros(probs.shape, dtype=torch.float32,
                       device=x.device).scatter(1, topi, topw)
    return h, w_te, topi


def moe_block(p, cfg: ModelConfig, x):
    """x: (B, S, D) -> (B, S, D).  Under an active mesh with a "model" axis
    that divides E, and DTensor operands, the expert-parallel shard-map
    branch (`_moe_block_shardmap`), as the reference chooses it."""
    if sharding.is_sharded(x, p["expert_wi"]):
        tp = sharding.axis_sizes(sharding.current_mesh()).get("model")
        if tp and cfg.num_experts % tp == 0:
            return _moe_block_shardmap(p, cfg, x, tp)
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.top_k
    h, w_te, topi = _route(p["ln"], p["router"], x, k)
    if B * S <= _DENSE_PATH_MAX_TOKENS:
        STATS.masked += 1
        out = _masked_dense(p, h, w_te)
    else:
        STATS.gathered += 1
        out = _gathered(p["expert_wi"], p["expert_wo"], h, w_te, topi,
                        capacity(B * S, k, E))
    out = out.reshape(B, S, D).to(x.dtype)
    return sharding.act(out, "batch", "seq", "dmodel")


def _moe_block_shardmap(p, cfg: ModelConfig, x, tp: int):
    """Expert parallelism, the reference's shard_map: tokens stay in their
    data shard; each "model" rank holds E/tp experts and the full router,
    routes its T_loc tokens, takes the top-C of them for each local expert
    (C = round(2 T_loc k / E) from the local token count, the gathered
    path's selection and read-back, no scatter-add) and the (T_loc, D)
    partial outputs are summed over "model" in bf16, as the reference sums
    them.  Counted as a gathered call in `STATS`."""
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.top_k
    E_loc = E // tp
    dp = sharding.batch_axes_for(B)

    def local(ln, router, wi, wo, xs):
        T = xs.shape[0] * S
        h, w_te, topi = _route(ln, router, xs, k)
        e0 = sharding.axis_index("model") * E_loc
        out = _gathered(wi, wo, h, w_te[:, e0:e0 + E_loc], topi,
                        capacity(T, k, E), e0)
        out = sharding.all_reduce_sum(out.to(torch.bfloat16), "model")
        return out.reshape(xs.shape)

    STATS.gathered += 1
    out = sharding.shard_map(
        local, (p["ln"], p["router"], p["expert_wi"], p["expert_wo"], x),
        ((None,), (None, None), ("model", None, None), ("model", None, None),
         (dp, None, None)),
        ((dp, None, None),), (x.shape,))
    return sharding.act(out.to(x.dtype), "batch", "seq", "dmodel")


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


def _gathered(wi, wo, h, w_te, topi, C: int, e0: int = 0):
    """The gathered path over the experts e0.. that `wi`, `wo` and the
    columns of `w_te` (T, E_loc) hold (all of them, or one rank's under
    expert parallelism): (T, D) f32."""
    T, D = h.shape
    E = w_te.shape[1]
    if STATS.counting:
        STATS.add_overflow((w_te > 0).sum(dim=0), C)
    # top-C tokens per expert by routing weight; zeros fill a short list
    gather_w, gather_idx = _sorted_top(w_te.T, C)                   # (E, C)
    # inverse map: the slot of token t in expert e's list, -1 if not kept
    slot = torch.full((E, T), -1, dtype=torch.long, device=h.device)
    slot.scatter_(1, gather_idx, torch.arange(C, device=h.device)
                  .expand(E, C).contiguous())
    # each token's k (expert, slot) pairs in expert order, as the
    # reference's scatter-add sums them; experts held elsewhere keep nothing
    experts, _ = torch.sort(topi, dim=-1)                           # (T, k)
    el = experts - e0
    held = (el >= 0) & (el < E)
    el = el.clamp(0, E - 1)
    kept = torch.where(held, slot[el, torch.arange(T, device=h.device)[:, None]],
                       -1)                                          # (T, k)
    back = torch.where(kept >= 0, el * C + kept, E * C)
    toks = _TakeRows.apply(h, gather_idx.reshape(-1), back).reshape(E, C, D)
    ys = _expert_ffn(wi, wo, toks)                                  # (E, C, D)
    ys = ys.float() * gather_w[..., None]
    ys = torch.cat([ys.reshape(E * C, D), ys.new_zeros((1, D))])
    return ys[back].sum(dim=1)
