"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427): the
port of `repro.models.rglru`.

    r_t = sigmoid(W_a u_t)            recurrence gate
    i_t = sigmoid(W_x u_t)            input gate
    a_t = exp(-c * softplus(Lambda) * r_t)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

The block: linear in, depthwise causal conv(4), RG-LRU, GeGLU-style output
gating (tanh GELU, `jax.nn.gelu`'s default), linear out.  Decode keeps (the
conv window, h) as O(1) state.

The reference scans the linear recurrence with `jax.lax.associative_scan`.
The port takes a log-depth doubling scan on whole tensors (`linear_scan`):
ceil(log2 S) passes of (a, b) o (a', b') = (a a', a' b + b') in f32.  A loop
over S would be S launches a layer, and the log-space cumsum overflows
(log a reaches -8 softplus(6) ~ -48 a step).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init, rmsnorm
from repro_torch.parallel import sharding

_C = 8.0


def causal_conv(x, w, state=None):
    """Depthwise causal conv. x: (B,S,Dn), w: (width, Dn).  With `state`
    (B, width-1, Dn): one step (S == 1); returns (out, the new window).
    Shared with the mLSTM block (`repro.models.xlstm._causal_conv`)."""
    width = w.shape[0]
    if state is not None:
        window = torch.cat([state, x], dim=1)                # (B,width,Dn)
        out = torch.einsum("bwd,wd->bd", window, w)[:, None]
        return out, window[:, 1:]
    if sharding.is_sharded(x, w):
        return _local_causal_conv(x, w), None
    return _conv(x, w), None


def _conv(x, w):
    width = w.shape[0]
    pad = F.pad(x, (0, 0, width - 1, 0))
    S = x.shape[1]
    return sum(pad[:, i:i + S] * w[i] for i in range(width))


def _local_causal_conv(x, w):
    """The full-sequence conv of DTensors as a shard-map region: the conv
    runs along the sequence, one channel at a time, so a rank's chunk of
    (batch, channels) with the whole sequence needs nothing of another's.
    DTensor's own rule for the pad redistributes (and failed in one torch
    release)."""
    b, _, c = sharding.spec_of(x)
    return sharding.shard_map(_conv, (x, w), ((b, None, c), (None, c)),
                              ((b, None, c),), (tuple(x.shape),))


def shapes(cfg: ModelConfig) -> dict[str, tuple]:
    D = cfg.d_model
    return {"ln": (D,), "w_x": (D, D), "w_gate": (D, D),
            "conv_w": (cfg.rglru_conv_width, D), "w_a": (D, D),
            "w_i": (D, D), "lam": (D,), "w_o": (D, D)}


def init_rglru_block(generator, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    D = cfg.d_model
    return {
        "ln": torch.zeros((D,)),
        "w_x": dense_init(generator, (D, D)),
        "w_gate": dense_init(generator, (D, D)),
        "conv_w": dense_init(generator, (cfg.rglru_conv_width, D), scale=0.5),
        "w_a": dense_init(generator, (D, D), scale=0.01),
        "w_i": dense_init(generator, (D, D), scale=0.01),
        # Lambda so that a^c lies in (0.9, 0.999) at r = 1
        "lam": torch.linspace(2.0, 6.0, D),
        "w_o": dense_init(generator, (D, D), scale=D ** -0.5),
    }


def _gates(p, u):
    r = torch.sigmoid((u @ p["w_a"]).float())
    i = torch.sigmoid((u @ p["w_i"]).float())
    log_a = -_C * F.softplus(p["lam"].float()) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * i * u.float()
    return a, b


def linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0 along axis 1, by doubling:
    after the pass of stride d each position holds the composition of the
    last 2d steps.  Out of place, so autograd can run through it."""
    S = a.shape[1]
    d = 1
    while d < S:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        if 2 * d < S:
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def rglru_block(p, cfg: ModelConfig, x, state=None, return_state=False):
    """x: (B,S,D) -> delta (B,S,D); with `state` and S == 1, one decode step.
    The prefill's conv state is the raw u before the conv, as in the
    reference."""
    h = rmsnorm(x, p["ln"])
    u = h @ p["w_x"]
    g = F.gelu(h @ p["w_gate"], approximate="tanh")
    u_raw = u
    if state is not None and x.shape[1] == 1:
        u, new_conv = causal_conv(u, p["conv_w"], state["conv"].to(u.dtype))
        a, b = _gates(p, u)
        hh = a[:, 0] * state["h"] + b[:, 0]
        out_h = hh[:, None]
        new_state = {"conv": new_conv.float(), "h": hh}
    else:
        u, _ = causal_conv(u, p["conv_w"])
        a, b = _gates(p, u)
        if state is not None:  # fold the initial state into the first step
            b = torch.cat([b[:, :1] + a[:, :1] * state["h"][:, None],
                           b[:, 1:]], dim=1)
        out_h = linear_scan(a, b)
        w1 = cfg.rglru_conv_width - 1
        new_state = {"conv": u_raw[:, -w1:].float(), "h": out_h[:, -1]}
    out = (out_h * g.float()).to(x.dtype) @ p["w_o"]
    out = sharding.act(out, "batch", "seq", "dmodel")
    if return_state:
        return out, new_state
    return out


def init_rglru_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    return {"conv": torch.zeros((batch, cfg.rglru_conv_width - 1, cfg.d_model),
                                device=device),
            "h": torch.zeros((batch, cfg.d_model), device=device)}


def rglru_block_decode(p, cfg: ModelConfig, x, state):
    return rglru_block(p, cfg, x, state=state, return_state=True)
