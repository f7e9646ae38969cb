"""xLSTM blocks (Beck et al., arXiv:2405.04517), mLSTM and sLSTM: the port of
`repro.models.xlstm`.

mLSTM (matrix memory, exponential gating) runs in the chunkwise-parallel
form: attention-like products inside chunks of `mlstm_chunk` steps and a
recurrent (C, n, m) state across chunks; decode takes the O(1) recurrent
step.  The chunk must divide the sequence, as in the reference.  The
stabilisers (-inf under `where`, m from -1e30, `maximum(m, -1e30)`,
`logsigmoid`) follow the reference's order of operations, so that no
-inf - -inf is ever formed.

sLSTM has true recurrence (the hidden state feeds the gates), so its S
time steps run one after another: one call of the registered op
`repro_torch::slstm_scan` (`models.slstm_scan`), whose real implementation
is the loop of `_slstm_step` on the device (about 20 launches a step and
layer) and whose backward, `repro_torch::slstm_scan_bwd`, recomputes the
steps and runs their adjoints in reverse time.  The dry-run and the
autotuner trace it as one op a layer.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (_split_heads, dense_init, head_rmsnorm,
                                      rmsnorm, sharded_glu)
from repro_torch.models.rglru import causal_conv
from repro_torch.models.slstm_scan import slstm_scan
from repro_torch.parallel import sharding

# ------------------------------------------------------------- mLSTM core math

def _flat(out):
    """(out, (C, n, m)) -> (out, C, n, m)."""
    return (out[0], *out[1])


def _batch_parallel(fn, args: tuple, out_shapes: tuple, shared=()):
    """fn on DTensors under the active mesh, split over the batch (dim 0 of
    every argument but those `shared` indexes -- weights, replicated -- and
    of every output) and computed alike on every rank of the other axes:
    the recurrences (the mLSTM's chunks, the sLSTM's steps) have no DTensor
    sharding rule.  The reference's `act` calls around them mark the same
    boundary."""
    dp = sharding.batch_axes_for(args[0].shape[0])
    batch = set(dp if isinstance(dp, tuple) else (dp,))
    same = tuple(a for a in sharding.axis_sizes(sharding.current_mesh())
                 if a not in batch)

    def spec(ndim, batched=True):
        return ((dp,) if batched else (None,)) + (None,) * (ndim - 1)

    return sharding.shard_map(
        fn, args, tuple(spec(a.dim(), i not in shared)
                        for i, a in enumerate(args)),
        tuple(spec(len(s)) for s in out_shapes), out_shapes, same_on=same)


def mlstm_chunkwise(q, k, v, ig, fg, chunk: int, state=None):
    """q,k,v: (B,S,H,dh); ig,fg: (B,S,H) raw gate pre-activations.
    Returns (out (B,S,H,dh) f32, final state (C, n, m))."""
    B, S, H, dh = q.shape
    assert S % chunk == 0, (S, chunk)
    nc = S // chunk
    dev = q.device

    def to_chunks(x):
        return x.reshape(B, nc, chunk, *x.shape[2:])

    qc, kc, vc = to_chunks(q * dh ** -0.5), to_chunks(k), to_chunks(v)
    igc, fgc = to_chunks(ig), to_chunks(fg)
    if state is None:
        state = (torch.zeros((B, H, dh, dh), device=dev),
                 torch.zeros((B, H, dh), device=dev),
                 torch.full((B, H), -1e30, device=dev))
    C, n, m = state
    tri = (torch.arange(chunk, device=dev)[:, None]
           >= torch.arange(chunk, device=dev)[None, :])[None, :, :, None]
    outs = []
    for c in range(nc):
        qq, kk, vv = qc[:, c].float(), kc[:, c].float(), vc[:, c].float()
        logf = F.logsigmoid(fgc[:, c].float())                  # (B,L,H)
        ii = igc[:, c].float()
        Fc = torch.cumsum(logf, dim=1)                          # (B,L,H)
        Ftot = Fc[:, -1]                                        # (B,H)
        g_intra = Fc[:, :, None, :] - Fc[:, None, :, :] + ii[:, None, :, :]
        g_intra = torch.where(tri, g_intra, -torch.inf)         # (B,t,s,H)
        m_intra = torch.amax(g_intra, dim=2)                    # (B,t,H)
        m_inter = Fc + m[:, None, :]
        m_t = torch.maximum(m_intra, m_inter)
        m_t = torch.clamp(m_t, min=-1e30)
        D = torch.exp(g_intra - m_t[:, :, None, :])
        D = torch.where(tri, D, 0.0)
        scores = torch.einsum("bthd,bshd->btsh", qq, kk) * D
        intra = torch.einsum("btsh,bshd->bthd", scores, vv)
        inter_w = torch.exp(m_inter - m_t)
        inter = torch.einsum("bthd,bhde->bthe", qq, C) * inter_w[..., None]
        num = intra + inter
        l_intra = torch.sum(scores, dim=2)
        l_inter = torch.einsum("bthd,bhd->bth", qq, n) * inter_w
        denom = torch.maximum(torch.abs(l_intra + l_inter),
                              torch.exp(-m_t)) + 1e-6
        outs.append(num / denom[..., None])
        # the state to the end of the chunk
        g_state = Ftot[:, None, :] - Fc + ii                    # (B,s,H)
        m_new = torch.maximum(Ftot + m, torch.amax(g_state, dim=1))
        w_old = torch.exp(Ftot + m - m_new)
        w_s = torch.exp(g_state - m_new[:, None, :])
        # (k w_s) first: a three-operand einsum may form (b,s,h,d,e)
        C = C * w_old[:, :, None, None] + torch.einsum(
            "bshd,bshe->bhde", kk * w_s[..., None], vv)
        n = n * w_old[..., None] + torch.einsum("bshd,bsh->bhd", kk, w_s)
        m = m_new
    return torch.cat(outs, dim=1), (C, n, m)


def mlstm_recurrent_step(q, k, v, ig, fg, state):
    """One-token recurrent update. q,k,v: (B,H,dh); ig,fg: (B,H)."""
    C, n, m = state
    q = q.float() * (q.shape[-1] ** -0.5)
    k, v = k.float(), v.float()
    logf = F.logsigmoid(fg.float())
    ii = ig.float()
    m_new = torch.maximum(logf + m, ii)
    fw = torch.exp(logf + m - m_new)
    iw = torch.exp(ii - m_new)
    C = C * fw[..., None, None] + torch.einsum("bhd,bhe->bhde",
                                                k * iw[..., None], v)
    n = n * fw[..., None] + k * iw[..., None]
    num = torch.einsum("bhd,bhde->bhe", q, C)
    denom = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", q, n)),
                          torch.exp(-m_new)) + 1e-6
    return num / denom[..., None], (C, n, m_new)


# ------------------------------------------------------------------ mLSTM block


def mlstm_shapes(cfg: ModelConfig) -> dict[str, tuple]:
    D, H = cfg.d_model, cfg.num_heads
    Din = 2 * D
    dh = Din // H
    return {"ln": (D,), "w_up": (D, Din), "w_gate_up": (D, Din),
            "conv_w": (4, Din), "wq": (H, dh, dh), "wk": (H, dh, dh),
            "wv": (H, dh, dh), "w_ig": (Din, H), "w_fg": (Din, H),
            "b_fg": (H,), "gn": (H, dh), "w_down": (Din, D)}


def init_mlstm_block(generator, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    D, H = cfg.d_model, cfg.num_heads
    Din = 2 * D
    dh = Din // H
    return {
        "ln": torch.zeros((D,)),
        "w_up": dense_init(generator, (D, Din)),
        "w_gate_up": dense_init(generator, (D, Din)),
        "conv_w": dense_init(generator, (4, Din), scale=0.5),
        # block-diagonal per-head q/k/v projections
        "wq": dense_init(generator, (H, dh, dh), scale=dh ** -0.5),
        "wk": dense_init(generator, (H, dh, dh), scale=dh ** -0.5),
        "wv": dense_init(generator, (H, dh, dh), scale=dh ** -0.5),
        "w_ig": dense_init(generator, (Din, H), scale=0.01),
        "w_fg": dense_init(generator, (Din, H), scale=0.01),
        "b_fg": torch.full((H,), 3.0),  # forget-gate bias: remember
        "gn": torch.zeros((H, dh)),
        "w_down": dense_init(generator, (Din, D), scale=Din ** -0.5),
    }


def _mlstm_qkvg(p, cfg, u_conv, u):
    Din = u.shape[-1]
    H = cfg.num_heads
    ch = _split_heads(u_conv, H, Din // H)
    uh = _split_heads(u, H, Din // H)
    q = torch.einsum("bshd,hde->bshe", ch, p["wq"])
    k = torch.einsum("bshd,hde->bshe", ch, p["wk"])
    v = torch.einsum("bshd,hde->bshe", uh, p["wv"])
    ig = u_conv @ p["w_ig"]
    fg = u_conv @ p["w_fg"] + p["b_fg"]
    return q, k, v, ig, fg


def _mlstm_out(p, x, out, g):
    B, S = x.shape[:2]
    # under a mesh the norm's scale may split dh, which a view cannot
    # merge: the heads come whole over the model axis, then go to (batch,
    # ff) as the up-projection is
    out = sharding.act(head_rmsnorm(out, p["gn"]), "batch", "seq", None, None)
    out = sharding.act(out.reshape(B, S, -1), "batch", "seq", "ff")
    out = out * F.silu(g)
    return out.to(x.dtype) @ p["w_down"]


def mlstm_block_prefill(p, cfg: ModelConfig, x):
    """Full-sequence mLSTM (train and prefill) with its decode state.  The
    conv state is the raw u's last 3 steps, as in the reference."""
    h = rmsnorm(x, p["ln"])
    u = h @ p["w_up"]
    g = h @ p["w_gate_up"]
    u = sharding.act(u, "batch", "seq", "ff")
    uc, _ = causal_conv(u, p["conv_w"])
    uc = F.silu(uc)
    q, k, v, ig, fg = _mlstm_qkvg(p, cfg, uc, u)
    if sharding.is_sharded(q):
        B, S, H, dh = q.shape
        out, C, n, m = _batch_parallel(
            lambda *a: _flat(mlstm_chunkwise(*a, cfg.mlstm_chunk)),
            (q, k, v, ig, fg), ((B, S, H, dh), (B, H, dh, dh), (B, H, dh),
                                (B, H)))
    else:
        out, (C, n, m) = mlstm_chunkwise(q, k, v, ig, fg, cfg.mlstm_chunk)
    state = {"conv": u[:, -3:].float(), "C": C, "n": n, "m": m}
    out = sharding.act(_mlstm_out(p, x, out, g), "batch", "seq", "dmodel")
    return out, state


def mlstm_block(p, cfg: ModelConfig, x):
    return mlstm_block_prefill(p, cfg, x)[0]


def init_mlstm_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    Din = 2 * cfg.d_model
    H = cfg.num_heads
    dh = Din // H
    return {"conv": torch.zeros((batch, 3, Din), device=device),
            "C": torch.zeros((batch, H, dh, dh), device=device),
            "n": torch.zeros((batch, H, dh), device=device),
            "m": torch.full((batch, H), -1e30, device=device)}


def mlstm_block_decode(p, cfg: ModelConfig, x, state):
    """x: (B,1,D)."""
    h = rmsnorm(x, p["ln"])
    u = h @ p["w_up"]
    g = h @ p["w_gate_up"]
    uc, conv_state = causal_conv(u, p["conv_w"], state["conv"].to(u.dtype))
    uc = F.silu(uc)
    q, k, v, ig, fg = _mlstm_qkvg(p, cfg, uc, u)
    args = (q[:, 0], k[:, 0], v[:, 0], ig[:, 0], fg[:, 0], state["C"],
            state["n"], state["m"])
    if sharding.is_sharded(q):
        out, C, n, m = _batch_parallel(
            lambda *a: _flat(mlstm_recurrent_step(*a[:5], a[5:])), args,
            (tuple(q[:, 0].shape),) + tuple(tuple(t.shape) for t in args[5:]))
    else:
        out, (C, n, m) = mlstm_recurrent_step(*args[:5], args[5:])
    new_state = {"conv": conv_state.float(), "C": C, "n": n, "m": m}
    return _mlstm_out(p, x, out[:, None], g), new_state


# ------------------------------------------------------------------ sLSTM block


def _slstm_ffn(cfg: ModelConfig) -> int:
    Fd = (4 * cfg.d_model) // 3
    return ((Fd + 63) // 64) * 64


def slstm_shapes(cfg: ModelConfig) -> dict[str, tuple]:
    D, H = cfg.d_model, cfg.num_heads
    dh, Fd = D // H, _slstm_ffn(cfg)
    out = {"ln": (D,)}
    for gate in "ifzo":
        out.update({f"w_{gate}": (D, D), f"r_{gate}": (H, dh, dh),
                    f"b_{gate}": (D,)})
    out.update(gn=(H, dh), ffn_up=(D, 2 * Fd), ffn_down=(Fd, D),
               w_out=(D, D))
    return out


def init_slstm_block(generator, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    D, H = cfg.d_model, cfg.num_heads
    dh, Fd = D // H, _slstm_ffn(cfg)
    p = {"ln": torch.zeros((D,))}
    for gate in "ifzo":
        p[f"w_{gate}"] = dense_init(generator, (D, D))
    for gate in "ifzo":
        p[f"r_{gate}"] = dense_init(generator, (H, dh, dh), scale=dh ** -0.5)
        p[f"b_{gate}"] = torch.full((D,), 1.0 if gate == "f" else 0.0)
    p["gn"] = torch.zeros((H, dh))
    p["ffn_up"] = dense_init(generator, (D, 2 * Fd))
    p["ffn_down"] = dense_init(generator, (Fd, D), scale=Fd ** -0.5)
    p["w_out"] = dense_init(generator, (D, D), scale=D ** -0.5)
    return p


def init_slstm_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    H = cfg.num_heads
    dh = cfg.d_model // H
    return {"h": torch.zeros((batch, H, dh), device=device),
            "c": torch.zeros((batch, H, dh), device=device),
            "n": torch.zeros((batch, H, dh), device=device),
            "m": torch.full((batch, H, dh), -1e30, device=device)}


def _gelu(a):
    return F.gelu(a, approximate="tanh")


def slstm_block(p, cfg: ModelConfig, x, state=None, return_state=False):
    """x: (B,S,D) -> delta; the time steps one after another (one call of
    the op `slstm_scan`: S steps of `_slstm_step`), then the
    post-up-projection GeGLU FFN (4/3)."""
    B, S, D = x.shape
    H = cfg.num_heads
    hln = rmsnorm(x, p["ln"])
    gates = {g: (hln @ p[f"w_{g}"] + p[f"b_{g}"]).float() for g in "ifzo"}
    r = {g: p[f"r_{g}"].float() for g in "ifzo"}
    carry = state if state is not None else init_slstm_state(cfg, B, x.device)
    if sharding.is_sharded(x):
        names = tuple(carry)
        carry = [carry[k] if sharding.is_sharded(carry[k])
                 else sharding.constant(carry[k], x, "batch", None, None)
                 for k in names]
        rr = [r[g] if sharding.is_sharded(r[g]) else sharding.constant(r[g], x)
              for g in "ifzo"]

        def run(*a):
            hs, c = slstm_scan(dict(zip("ifzo", a[4:8])),
                               dict(zip(names, a[8:])),
                               dict(zip("ifzo", a[:4])), H)
            return (hs, *(c[k] for k in names))

        dh = D // H
        outs = _batch_parallel(
            run, (*(gates[g] for g in "ifzo"), *rr, *carry),
            ((B, S, H, dh),) + ((B, H, dh),) * len(names), shared=range(4, 8))
        hs, carry = outs[0], dict(zip(names, outs[1:]))
    else:
        hs, carry = slstm_scan(r, carry, gates, H)
    # whole heads before the view, as in the mLSTM's `_mlstm_out`
    out = sharding.act(head_rmsnorm(hs, p["gn"]), "batch", "seq", None, None)
    out = out.reshape(B, S, D).to(x.dtype)
    out = out @ p["w_out"]
    y = rmsnorm(out + x, p["ln"])
    # under a mesh the GeGLU is a tensor-parallel region: DTensor's split of
    # the ff-sharded up-projection left a layout its matmul rule could not
    # take at prefill_32k's size
    ffn = (sharded_glu(y, p["ffn_up"], p["ffn_down"], _gelu)
           if sharding.is_sharded(y, p["ffn_up"]) else None)
    if ffn is None:
        a, b = torch.chunk(y @ p["ffn_up"], 2, dim=-1)
        ffn = _gelu(a) * b @ p["ffn_down"]
    res = sharding.act(out + ffn, "batch", "seq", "dmodel")
    if return_state:
        return res, carry
    return res


def slstm_block_decode(p, cfg: ModelConfig, x, state):
    return slstm_block(p, cfg, x, state=state, return_state=True)
