"""AdamW with dtype policies, global-norm clipping and optional int8 gradient
compression (the port of `repro.optim.adamw`).

Parameters, gradients and the moments are dicts of tensors keyed by the
model's state-dict names ("embed.embedding", "blocks.0.attn.wq", ...); the
optimizer state is {"mu": {...}, "nu": {...}, "step": int32 scalar}.  Every
function is pure, as in the reference: `apply_updates` returns new tensors
and leaves its inputs alone.  The arithmetic is the reference's, leaf by
leaf and in its order, in f32 (moments stored in `state_dtype`).

One difference of order: the reference sums the leaves' squares in JAX's
sorted-key order, the port in the dict's order (state-dict order), so
`global_norm` may differ in its last bits (~1e-7 relative).
"""

from __future__ import annotations

import dataclasses
import math

import torch

_STATE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"      # "bfloat16" => pure-bf16 moments (400B fit)
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def _state_dtype(cfg: AdamWConfig) -> torch.dtype:
    if cfg.state_dtype not in _STATE_DTYPES:
        raise ValueError(f"state_dtype must be one of {tuple(_STATE_DTYPES)}, "
                         f"got {cfg.state_dtype!r}")
    return _STATE_DTYPES[cfg.state_dtype]


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay, in f32 (`step` an integer tensor)."""
    step = step.to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_state(cfg: AdamWConfig, params: dict[str, torch.Tensor]) -> dict:
    """Zero moments of each parameter's shape in `state_dtype`, on its
    device (laid out as the parameter is, for a DTensor), and step 0."""
    dt = _state_dtype(cfg)
    device = next(iter(params.values())).device if params else None
    return {
        "mu": {k: torch.zeros_like(p, dtype=dt) for k, p in params.items()},
        "nu": {k: torch.zeros_like(p, dtype=dt) for k, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree: dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in tree.values()))


def clip_by_global_norm(grads: dict[str, torch.Tensor], max_norm: float):
    """(grads scaled by min(1, max_norm / (norm + 1e-9)) in their dtypes,
    norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return {k: (g.to(torch.float32) * scale).to(g.dtype)
            for k, g in grads.items()}, norm


def compress_int8(grads: dict[str, torch.Tensor]) -> dict:
    """Per-leaf absmax int8 quantization: {name: (int8 values, f32 scale)},
    scale = max|g| / 127 + 1e-12, values rounded half to even."""
    def q(g):
        g32 = g.to(torch.float32)
        scale = torch.amax(torch.abs(g32)) / 127.0 + 1e-12
        return torch.round(g32 / scale).to(torch.int8), scale

    return {k: q(g) for k, g in grads.items()}


def decompress_int8(qgrads: dict) -> dict[str, torch.Tensor]:
    return {k: v.to(torch.float32) * s for k, (v, s) in qgrads.items()}


def apply_updates(cfg: AdamWConfig, params: dict[str, torch.Tensor],
                  opt_state: dict, grads: dict[str, torch.Tensor]):
    """One AdamW step; returns (new_params, new_state, metrics) with
    metrics {"grad_norm", "lr"} as f32 scalar tensors."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    step = opt_state["step"] + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    sdt = _state_dtype(cfg)
    step32 = step.to(torch.float32)
    bc1 = 1 - b1 ** step32
    bc2 = 1 - b2 ** step32

    def upd(p, g, mu, nu):
        g32 = g.to(torch.float32)
        p32 = p.to(torch.float32)
        mu32 = mu.to(torch.float32) * b1 + (1 - b1) * g32
        nu32 = nu.to(torch.float32) * b2 + (1 - b2) * g32 * g32
        mu_hat = mu32 / bc1
        nu_hat = nu32 / bc2
        delta = mu_hat / (torch.sqrt(nu_hat) + cfg.eps) + cfg.weight_decay * p32
        newp = p32 - lr * delta
        return newp.to(p.dtype), mu32.to(sdt), nu32.to(sdt)

    new_p, new_mu, new_nu = {}, {}, {}
    for k, p in params.items():
        new_p[k], new_mu[k], new_nu[k] = upd(p, grads[k], opt_state["mu"][k],
                                             opt_state["nu"][k])
    return (new_p, {"mu": new_mu, "nu": new_nu, "step": step},
            {"grad_norm": gnorm, "lr": lr})
