"""Step functions (train / prefill / decode) and their sharding specs (the
port of `repro.launch.steps`), shared by the dry-run, the trainer and the
server.

A spec is `parallel.sharding`'s: a tuple of mesh-axis entries per tensor
dim, the reference's `PartitionSpec` entries; `sharding.placements` turns it
into DTensor placements and `distribute` lays a dict of tensors out by
their specs.  The specs name the port's own inputs, cache and state:
parameters by state-dict name (each layer its own tensor: the reference's
leaf spec with the layer-stack dim dropped), the decode cache one dict a
layer.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.model import build_model, cache_specs, input_specs
from repro_torch.optim import adamw
from repro_torch.parallel import sharding


def _dp_if_divides(mesh, rules, size: int):
    """The batch axes, dropped when the batch dim doesn't divide them."""
    dp = sharding._filter_spec(mesh, (rules.batch,))[0]
    if dp is None:
        return None
    axes = dp if isinstance(dp, tuple) else (dp,)
    sizes = sharding.axis_sizes(mesh)
    total = 1
    for a in axes:
        total *= sizes[a]
    return dp if size % total == 0 else None


def batch_sharding(cfg: ModelConfig, shape: ShapeConfig, mesh, rules) -> dict:
    """{input name: spec} of the data batch: batch dim over (pod, data)."""
    specs = {}
    for name, t in input_specs(cfg, shape).items():
        bdim = 1 if name == "positions" else 0  # positions: (3, B, S)
        ndim = t.dim()
        spec = [None] * ndim
        if ndim > bdim:
            spec[bdim] = _dp_if_divides(mesh, rules, t.shape[bdim])
        specs[name] = sharding._filter_spec(mesh, tuple(spec))
    return specs


def _cache_leaf_spec(t, mesh, rules) -> tuple:
    """A cache leaf of one layer (the reference's leaf without its
    super-block dim): dim 0 = batch; a KV cache (B, S, KV, hd) shards its
    length over the kv_len axis ("model" by default) when divisible."""
    dims = [None] * t.dim()
    if t.dim() >= 2:
        dims[0] = _dp_if_divides(mesh, rules, t.shape[0])
        kv_axis = rules.kv_len if rules.kv_len is not None else "model"
        sizes = sharding.axis_sizes(mesh)
        if t.dim() >= 4 and t.shape[1] % sizes.get(kv_axis, 1) == 0:
            dims[1] = kv_axis
    return sharding._filter_spec(mesh, tuple(dims))


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def cache_sharding(cfg: ModelConfig, shape: ShapeConfig, mesh, rules):
    """Specs of the decode cache (`models.model.cache_specs`' structure):
    batch over the data axes; long KV length axes go to the model axis
    (sequence-sharded cache) when divisible.  For the encoder-decoder,
    (the caches' specs, the encoder output's)."""
    cs = cache_specs(cfg, shape)

    def leaf(t):
        return _cache_leaf_spec(t, mesh, rules)

    if cfg.family == "encdec":
        cache, enc = cs
        enc_dp = _dp_if_divides(mesh, rules, enc.shape[0])
        return (_tree_map(leaf, cache),
                sharding._filter_spec(mesh, (enc_dp, None, None)))
    return _tree_map(leaf, cs)


def state_shardings(model, mesh, rules, opt: bool = True) -> dict:
    """Specs of the parameters ({name: spec}) and, with `opt`, of the
    train state {"params", "opt": {"mu", "nu", "step"}}."""
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    pspecs = sharding.tree_param_specs(shapes, mesh, rules,
                                       len(model.cfg.block_pattern))
    if not opt:
        return pspecs
    return {"params": pspecs,
            "opt": {"mu": pspecs, "nu": pspecs, "step": ()}}


def distribute(tree, specs, mesh):
    """`tree` (nested dicts, lists and tuples of tensors) as DTensors laid
    out by the matching tree of specs; each rank keeps its own chunk of the
    tensor it holds (no communication)."""
    from torch.distributed.tensor import distribute_tensor

    if isinstance(tree, dict):
        return {k: distribute(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(distribute(v, s, mesh) for v, s in zip(tree, specs))
    return distribute_tensor(tree, mesh, sharding.placements(specs, mesh),
                             src_data_rank=None)


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    device="cuda"):
    """(model, train_step).  `train_step(state, batch)` takes the state
    {"params": {name: f32 tensor}, "opt": AdamW state} and a batch of
    {"tokens", "labels"} tensors on the model's device, and returns (new
    state, metrics {"loss", "grad_norm", "lr"} as scalar tensors): the loss
    and its gradient in every parameter (`jax.value_and_grad(model.loss)`),
    then `adamw.apply_updates`.  The state is not changed in place.  With
    DTensor parameters (under `sharding.use_mesh`) each gradient is laid out
    as its parameter is before the update (the reference's out_shardings)
    and the metrics are replicated."""
    model = build_model(cfg, device, train=True)

    def train_step(state, batch):
        params = {k: p.detach().requires_grad_()
                  for k, p in state["params"].items()}
        loss = model.loss(batch, params)
        grads = torch.autograd.grad(loss, list(params.values()))
        grads = {k: _like(g, params[k]) for k, g in zip(params, grads)}
        new_params, new_opt, metrics = adamw.apply_updates(
            opt_cfg, state["params"], state["opt"], grads)
        metrics = dict(metrics, loss=loss.detach())
        metrics = {k: _replicated(v) for k, v in metrics.items()}
        return {"params": new_params, "opt": new_opt}, metrics

    return model, train_step


def _like(g, p):
    """A gradient in its parameter's layout (a DTensor's placements)."""
    if sharding.is_dtensor(p) and g.placements != p.placements:
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _replicated(t):
    """A scalar metric replicated on every rank (a DTensor's Partial
    reductions done)."""
    if sharding.is_dtensor(t):
        from torch.distributed.tensor import Replicate

        return t.redistribute(t.device_mesh,
                              [Replicate()] * t.device_mesh.ndim)
    return t


def make_prefill_step(cfg: ModelConfig, device="cuda"):
    """(model, prefill_step(params, batch) -> (logits, cache)): the
    serving model's `prefill` on a parameter state dict."""
    model = build_model(cfg, device)

    def prefill_step(params, batch):
        return model.prefill(batch, params)

    return model, prefill_step


def make_decode_step(cfg: ModelConfig, device="cuda"):
    """(model, serve_step(params, cache, batch, pos) -> (logits, cache)):
    one decode step on a parameter state dict."""
    model = build_model(cfg, device)

    def serve_step(params, cache, batch, pos):
        return model.decode_step(cache, batch, pos, params)

    return model, serve_step


def init_train_state(model, cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                     generator: torch.Generator) -> dict:
    """Random weights from `generator` (a CPU generator, the reference's
    distributions) and zero AdamW state.  The state's parameters are the
    model's own tensors (detached); steps return new ones."""
    model.init(generator)
    params = {k: p.detach() for k, p in model.named_parameters()}
    return {"params": params, "opt": adamw.init_state(opt_cfg, params)}
