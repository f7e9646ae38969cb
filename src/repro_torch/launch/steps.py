"""The trainer's step function and initial state (the port of
`repro.launch.steps`' `make_train_step` and `init_train_state`).

The reference's sharding specs (`batch_sharding`, `cache_sharding`,
`state_shardings`) and its prefill and decode step functions wait for the
port of `parallel/sharding.py`; the server calls `LM.prefill` and
`LM.decode_step` directly (ROADMAP.md).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import build_model
from repro_torch.optim import adamw


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    device="cuda"):
    """(model, train_step).  `train_step(state, batch)` takes the state
    {"params": {name: f32 tensor}, "opt": AdamW state} and a batch of
    {"tokens", "labels"} tensors on the model's device, and returns (new
    state, metrics {"loss", "grad_norm", "lr"} as scalar tensors): the loss
    and its gradient in every parameter (`jax.value_and_grad(model.loss)`),
    then `adamw.apply_updates`.  The state is not changed in place."""
    model = build_model(cfg, device, train=True)

    def train_step(state, batch):
        params = {k: p.detach().requires_grad_()
                  for k, p in state["params"].items()}
        loss = model.loss(batch, params)
        grads = torch.autograd.grad(loss, list(params.values()))
        new_params, new_opt, metrics = adamw.apply_updates(
            opt_cfg, state["params"], state["opt"], dict(zip(params, grads)))
        metrics = dict(metrics, loss=loss.detach())
        return {"params": new_params, "opt": new_opt}, metrics

    return model, train_step


def init_train_state(model, cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                     generator: torch.Generator) -> dict:
    """Random weights from `generator` (a CPU generator, the reference's
    distributions) and zero AdamW state.  The state's parameters are the
    model's own tensors (detached); steps return new ones."""
    model.init(generator)
    params = {k: p.detach() for k, p in model.named_parameters()}
    return {"params": params, "opt": adamw.init_state(opt_cfg, params)}
