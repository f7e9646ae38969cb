"""The sLSTM's time steps as one registered op pair (`repro_torch::slstm_scan`
and its backward, `repro_torch::slstm_scan_bwd`).

The sLSTM has true recurrence: the hidden state feeds the gates through the
per-head recurrent weights, so its S steps run one after another.  The
reference scans them with one `jax.lax.scan` (`repro.models.xlstm.
slstm_block`); the port runs `_slstm_step` S times.  Registered as ops, the
S steps are one call to FakeTensor and DTensor code: the dry-run and the
autotuner trace one op a layer (never S steps), its fake implementations
allocate only what the real ones return, and `FlopCounterMode` / the
dry-run's `CostMode` count the recurrent products through the formulas
registered below.  This is also where a CUDA scan kernel would go.

The forward's real implementation is the loop itself (`_slstm_scan_plain`),
so its results are bit-equal to it on any device.  Autograd is off inside a
custom op, so the backward is written out: `_slstm_scan_bwd_plain`
recomputes the S steps from the saved inputs (the gate pre-activations, the
recurrent weights and the first carry: nothing of the forward's is saved
beyond its inputs) and then runs the adjoint of `_slstm_step` in reverse
time -- one batched product a step for the hidden state's gradient, and the
recurrent weights' gradients as one product over all steps at the end,
summed in f64.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

GATES = "ifzo"
CARRY = ("h", "c", "n", "m")
# Calls of the ops' real implementations (never of the fake ones), as the
# kernels count their launches: chip_smoke.py reads them around a path.
CALLS = {"forward": 0, "backward": 0}


# ----------------------------------------------------------- the plain loop

def _slstm_gates(r, h, gates_x, H: int):
    """The four gate pre-activations of one step, (B,H,dh) each: the input
    part `gates_x[g]` (B,D) plus the recurrent product h @ r[g]."""
    B = h.shape[0]
    return tuple(gates_x[g].reshape(B, H, -1)
                 + torch.einsum("bhd,hde->bhe", h, r[g]) for g in GATES)


def _slstm_update(carry, it, ft, zt, ot):
    """The exponentially gated cell update from the pre-activations."""
    logf = F.logsigmoid(ft)
    m_new = torch.maximum(logf + carry["m"], it)
    iw = torch.exp(it - m_new)
    fw = torch.exp(logf + carry["m"] - m_new)
    c = fw * carry["c"] + iw * torch.tanh(zt)
    n = fw * carry["n"] + iw
    h = torch.sigmoid(ot) * c / torch.clamp(n, min=1e-6)
    return {"h": h, "c": c, "n": n, "m": m_new}


def _slstm_step(r, carry, gates_x, H: int):
    """carry: dict(h,c,n,m) each (B,H,dh) f32; gates_x: the (B,D) f32
    pre-activations of gate i, f, z, o; r: the recurrent weights in f32 (the
    reference's einsum promotes them)."""
    return _slstm_update(carry, *_slstm_gates(r, carry["h"], gates_x, H))


def _slstm_scan_plain(r, carry, gates, H: int):
    """The S steps of `_slstm_step`: (hs (B,S,H,dh), the last carry)."""
    hs = []
    for t in range(next(iter(gates.values())).shape[1]):
        carry = _slstm_step(r, carry, {g: a[:, t] for g, a in gates.items()},
                            H)
        hs.append(carry["h"])
    return torch.stack(hs, dim=1), carry


def _slstm_scan_bwd_plain(r, carry0, gates, dhs, dcarry, H: int,
                          h0_grad: bool = True):
    """The gradients of `_slstm_scan_plain`'s inputs (gates, r, carry0, as
    dicts) from those of its outputs (dhs (B,S,H,dh) and the last carry's
    `dcarry`): the steps recomputed from carry0, then their adjoints in
    reverse time.  Without `h0_grad` the first carry's h gets zeros and
    its product is skipped, as autograd skips it for a state that needs
    no gradient.  Each local derivative is the one autograd takes through
    the loop: torch.maximum's (ties split in half), clamp's (through where
    n >= 1e-6), the quotient's (-g (u / n) / n)."""
    B, S, D = gates["i"].shape
    states, pres = [carry0], []
    carry = carry0
    for t in range(S):
        pre = _slstm_gates(r, carry["h"], {g: a[:, t] for g, a in
                                           gates.items()}, H)
        carry = _slstm_update(carry, *pre)
        pres.append(pre)
        states.append(carry)
    # (H, dh, 4, dh): one product a step gives h's gradient through all four
    R = torch.stack([r[g] for g in GATES], dim=2)
    g_h, g_c, g_n, g_m = (dcarry[k] for k in CARRY)
    drecs = [None] * S
    for t in reversed(range(S)):
        prev = states[t]
        it, ft, zt, ot = pres[t]
        logf = F.logsigmoid(ft)
        a = logf + prev["m"]
        m_new = torch.maximum(a, it)
        iw = torch.exp(it - m_new)
        fw = torch.exp(a - m_new)
        tz = torch.tanh(zt)
        c = fw * prev["c"] + iw * tz
        n = fw * prev["n"] + iw
        so = torch.sigmoid(ot)
        ncl = torch.clamp(n, min=1e-6)
        u = so * c
        g_ht = dhs[:, t] + g_h
        g_u = g_ht / ncl
        g_n = g_n + torch.where(n >= 1e-6, -g_ht * (u / ncl / ncl), 0.0)
        g_c = g_c + g_u * so
        d_ot = g_u * c * (so * (1 - so))
        d_zt = g_c * iw * (1 - tz * tz)
        g_iw = g_c * tz + g_n
        g_fw = g_c * prev["c"] + g_n * prev["n"]
        e_i, e_f = g_iw * iw, g_fw * fw
        g_mn = g_m - e_i - e_f
        tie = a == it
        d_a = e_f + torch.where(tie, g_mn / 2, torch.where(a > it, g_mn, 0.0))
        d_it = e_i + torch.where(tie, g_mn / 2,
                                 torch.where(it > a, g_mn, 0.0))
        d_ft = d_a * torch.sigmoid(-ft)
        drec = torch.stack([d_it, d_ft, d_zt, d_ot], dim=2)   # (B,H,4,dh)
        drecs[t] = drec
        g_h = (torch.einsum("bhge,hdge->bhd", drec, R) if t or h0_grad
               else torch.zeros_like(g_h))
        g_c, g_n, g_m = g_c * fw, g_n * fw, d_a
    drec = torch.stack(drecs, dim=1)                          # (B,S,H,4,dh)
    h_prev = torch.stack([s["h"] for s in states[:-1]], dim=1)
    d_gates = {g: drec[:, :, :, k].reshape(B, S, D)
               for k, g in enumerate(GATES)}
    # the weights' gradients sum B*S products: in f64, so that the sum's
    # rounding (an f32 GEMM's over K = 8,192 at xlstm's training shape) is
    # not what the result carries
    h64, drec64 = h_prev.double(), drec.double()
    d_r = {g: torch.einsum("bshd,bshe->hde", h64, drec64[:, :, :, k]).to(
        h_prev.dtype) for k, g in enumerate(GATES)}
    return d_gates, d_r, {"h": g_h, "c": g_c, "n": g_n, "m": g_m}


# ------------------------------------------------------------ registered ops

def _check(gates, r, carry, H: int) -> None:
    B, S, D = gates[0].shape
    if S < 1 or D % H:
        raise ValueError(f"slstm_scan: needs S >= 1 and H | D, got gates "
                         f"{tuple(gates[0].shape)} and H {H}")
    for t in (*gates, *r, *carry):
        if t.dtype != torch.float32:
            raise ValueError(f"slstm_scan: operands are f32, got {t.dtype}")


@torch.library.custom_op("repro_torch::slstm_scan", mutates_args=())
def _scan_op(gi: torch.Tensor, gf: torch.Tensor, gz: torch.Tensor,
             go: torch.Tensor, ri: torch.Tensor, rf: torch.Tensor,
             rz: torch.Tensor, ro: torch.Tensor, h: torch.Tensor,
             c: torch.Tensor, n: torch.Tensor, m: torch.Tensor,
             H: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor, torch.Tensor]:
    """(hs, h, c, n, m): the S steps of `_slstm_step` (`_slstm_scan_plain`)
    on gate pre-activations (B,S,D), recurrent weights (H,dh,dh) and the
    carry (B,H,dh), all f32."""
    _check((gi, gf, gz, go), (ri, rf, rz, ro), (h, c, n, m), H)
    CALLS["forward"] += 1
    hs, carry = _slstm_scan_plain(dict(zip(GATES, (ri, rf, rz, ro))),
                                  dict(zip(CARRY, (h, c, n, m))),
                                  dict(zip(GATES, (gi, gf, gz, go))), H)
    return tuple(t.contiguous() for t in (hs, *(carry[k] for k in CARRY)))


@_scan_op.register_fake
def _(gi, gf, gz, go, ri, rf, rz, ro, h, c, n, m, H):
    B, S, D = gi.shape
    return (gi.new_empty((B, S, H, D // H)), *(t.new_empty(t.shape)
                                               for t in (h, c, n, m)))


@torch.library.custom_op("repro_torch::slstm_scan_bwd", mutates_args=())
def _scan_bwd_op(gi: torch.Tensor, gf: torch.Tensor, gz: torch.Tensor,
                 go: torch.Tensor, ri: torch.Tensor, rf: torch.Tensor,
                 rz: torch.Tensor, ro: torch.Tensor, h: torch.Tensor,
                 c: torch.Tensor, n: torch.Tensor, m: torch.Tensor,
                 dhs: torch.Tensor, dh: torch.Tensor, dc: torch.Tensor,
                 dn: torch.Tensor, dm: torch.Tensor, H: int,
                 h0_grad: bool
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients of `slstm_scan`'s 12 tensor inputs (gates i f z o,
    weights i f z o, carry h c n m) from those of its 5 outputs
    (`_slstm_scan_bwd_plain`; h's zero without `h0_grad`)."""
    CALLS["backward"] += 1
    d_gates, d_r, d_carry = _slstm_scan_bwd_plain(
        dict(zip(GATES, (ri, rf, rz, ro))), dict(zip(CARRY, (h, c, n, m))),
        dict(zip(GATES, (gi, gf, gz, go))), dhs,
        dict(zip(CARRY, (dh, dc, dn, dm))), H, h0_grad)
    return tuple(t.contiguous() for t in (
        *(d_gates[g] for g in GATES), *(d_r[g] for g in GATES),
        *(d_carry[k] for k in CARRY)))


@_scan_bwd_op.register_fake
def _(gi, gf, gz, go, ri, rf, rz, ro, h, c, n, m, dhs, dh, dc, dn, dm, H,
      h0_grad):
    return tuple(t.new_empty(t.shape)
                 for t in (gi, gf, gz, go, ri, rf, rz, ro, h, c, n, m))


def _setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs[:12])
    ctx.H = inputs[12]


def _backward(ctx, dhs, dh, dc, dn, dm):
    saved = ctx.saved_tensors
    B, S, D = saved[0].shape
    shapes = ((B, S, ctx.H, D // ctx.H),) + (saved[8].shape,) * 4
    grads = (g.contiguous() if g is not None else saved[0].new_zeros(s)
             for g, s in zip((dhs, dh, dc, dn, dm), shapes))
    return (*_scan_bwd_op(*saved, *grads, ctx.H, ctx.needs_input_grad[8]),
            None)


_scan_op.register_autograd(_backward, setup_context=_setup_context)


def scan_flops(B: int, S: int, H: int, dh: int) -> int:
    """The forward's recurrent products: four (B,H,dh) x (H,dh,dh) a step,
    2 FLOPs a multiply-add (the elementwise gating is not counted, as
    PyTorch's formulas count no elementwise op)."""
    return S * 4 * 2 * B * H * dh * dh


def _register_flop_formulas() -> None:
    from torch.utils.flop_counter import register_flop_formula

    @register_flop_formula(torch.ops.repro_torch.slstm_scan)
    def _(gi_shape, *args, out_shape=None, **kwargs):
        B, S, D = gi_shape
        H = args[3][0]                  # r_i's shape (H, dh, dh)
        return scan_flops(B, S, H, D // H)

    @register_flop_formula(torch.ops.repro_torch.slstm_scan_bwd)
    def _(gi_shape, *args, out_shape=None, **kwargs):
        # the recomputed forward, then h's gradient a step and the weights'
        # gradients over all steps: three forwards' products, less the
        # first step's h product when the first h needs no gradient
        B, S, D = gi_shape
        H, h0_grad = args[3][0], args[-1]
        flops = 3 * scan_flops(B, S, H, D // H)
        return flops if h0_grad else flops - scan_flops(B, 1, H, D // H)


_register_flop_formulas()


def slstm_scan(r, carry, gates, H: int):
    """`_slstm_scan_plain`'s contract -- dicts in, (hs (B,S,H,dh), the last
    carry dict) out -- through the registered op (differentiable through
    `repro_torch::slstm_scan_bwd`)."""
    hs, *last = _scan_op(*(gates[g] for g in GATES), *(r[g] for g in GATES),
                         *(carry[k] for k in CARRY), H)
    return hs, dict(zip(CARRY, last))
