"""Carry state across from the JAX reference, as plain NumPy and tuples.

Nothing here imports the reference: callers hand over the arrays of a fitted
reference GP's `_state` (converted with `np.asarray`), the
`dataclasses.astuple` images of its hardware configs and mappings, the
reference LM's or encoder-decoder's parameter tree -- or a tree of its
shape, such as its gradients or AdamW moments -- its decode cache (KV
caches and recurrent states), as nested dicts of arrays, and the plain image
of a `SearchSession.snapshot()` (`session_snapshot_from_reference`; the
port's own goes out through `session_snapshot_to_reference`).  With a
GP rebuilt on identical hyperparameters, the two posteriors can be compared
directly -- the pinned-noise linear fit's hyperparameters are only weakly
determined, so fits from scratch agree on posteriors, not on parameters.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.gp import GP, GPStack
from repro_torch.device import resolve_device
from repro_torch.timeloop.arch import HardwareConfig, hw_from_tuple
from repro_torch.timeloop.mapping import Mapping
from repro_torch.timeloop.workloads import ConvLayer


def _state(params, X, y, mask, device, lead: bool):
    """Tensors of a port GP state; `lead` adds the run axis of one that a
    single port GP carries."""
    dev = resolve_device(device)

    def t(a):
        a = np.asarray(a, np.float64)
        return torch.as_tensor(a[None] if lead else a).to(dev)

    return ({k: t(v) for k, v in params.items()}, t(X), t(y), t(mask))


def gp_from_reference(params: dict[str, np.ndarray], X, y, mask, *,
                      kind: str, noisy: bool, device="cuda") -> GP:
    """A fitted port `GP` from a reference `GP._state` = (params, X, y, mask):
    params leaves are scalars or (d,) arrays, X (b, d), y and mask (b,)."""
    gp = GP(kind=kind, noisy=noisy, device=str(device))
    gp._state = _state(params, X, y, mask, device, lead=True)
    return gp


def gp_stack_from_reference(params: dict[str, np.ndarray], X, y, mask, *,
                            kind: str, noisy: bool, device="cuda") -> GPStack:
    """A fitted port `GPStack` from a reference `GPStack._state`: every leaf
    leads with the run axis L (X (L, b, d), y and mask (L, b))."""
    stack = GPStack(kind=kind, noisy=noisy, device=str(device))
    stack._state = _state(params, X, y, mask, device, lead=False)
    return stack


def hardware_from_tuple(t) -> HardwareConfig:
    """`HardwareConfig` from its `dataclasses.astuple` image."""
    return hw_from_tuple(t)


def mapping_from_tuple(t) -> Mapping:
    """`Mapping` from its `dataclasses.astuple` image."""
    factors, order_lb, order_gb, order_dram = t
    return Mapping(factors=tuple(tuple(int(x) for x in row) for row in factors),
                   order_lb=tuple(order_lb), order_gb=tuple(order_gb),
                   order_dram=tuple(order_dram))


def layer_from_tuple(t) -> ConvLayer:
    """`ConvLayer` from its `dataclasses.astuple` image."""
    return ConvLayer(*t)


def map_session_snapshot(snap: dict, hw, mapping, layer) -> dict:
    """A copy of a `SearchSession.snapshot()` (either package's, or its
    plain image) with each hardware config passed through `hw`, each
    mapping through `mapping` and each layer through `layer`: the outer
    loop's points (its result's best point and points, elites, observed
    points, frozen window pool), the incumbent's hardware and mappings, the
    speculated probes and the (hw, layer) -> (mapping, EDP) cache.  Every
    other entry -- the RNG state, the GP data and fit boundary, counters,
    floats, a portfolio session's `front` and incumbent extras -- is plain
    data and kept as it is.  None stays None."""
    def opt(fn, x):
        return None if x is None else fn(x)

    loop = dict(snap["loop"])
    res = dict(loop["result"])
    res["best_point"] = opt(hw, res["best_point"])
    res["points"] = [hw(x) for x in res["points"]]
    loop.update(result=res, elites=[hw(x) for x in loop["elites"]],
                observed=[hw(x) for x in loop["observed"]],
                window_pool=opt(lambda p: [hw(x) for x in p],
                                loop["window_pool"]))
    best = dict(snap["best"])
    best["hw"] = opt(hw, best["hw"])
    best["maps"] = opt(lambda d: {n: mapping(m) for n, m in d.items()},
                       best["maps"])
    return dict(snap, loop=loop, best=best,
                speculated=[hw(x) for x in snap["speculated"]],
                cache=[((hw(h), layer(ly)), (opt(mapping, m), edp))
                       for (h, ly), (m, edp) in snap["cache"]])


def session_snapshot_to_reference(snap: dict) -> dict:
    """The plain image of a port `SearchSession.snapshot()` (or a
    `PortfolioSession`'s): every hardware config, mapping and layer as its
    `dataclasses.astuple` image, the rest as it is (numpy arrays, floats,
    the numpy `bit_generator.state` dict).  The reference rebuilds its own
    objects from it and restores a session of the same config and layers
    into it."""
    return map_session_snapshot(snap, dataclasses.astuple,
                                dataclasses.astuple, dataclasses.astuple)


def session_snapshot_from_reference(image: dict) -> dict:
    """A port `SearchSession.snapshot()` from the plain image of a
    reference one (`session_snapshot_to_reference`'s form): hardware
    configs, mappings and layers rebuilt from their tuples, for
    `SearchSession.restore` / `PortfolioSession.restore` of the same
    config and layers."""
    return map_session_snapshot(image, hardware_from_tuple,
                                mapping_from_tuple, layer_from_tuple)


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _stacked(state: dict, prefix: str, parts: dict, layer_of) -> None:
    """Unstack {part: {name: (L, ...)}} into `prefix.<layer_of(s)>.part.name`
    entries of `state`."""
    for part, leaves in parts.items():
        for name, a in leaves.items():
            for s, layer in enumerate(np.asarray(a)):
                state[f"{prefix}.{layer_of(s)}.{part}.{name}"] = _f32(layer)


_STACKS = ("blocks", "encoder", "decoder")


def is_stacked(name: str) -> bool:
    """Whether a port parameter is one layer of a reference layer stack:
    `blocks.<l>.*` of the LM, `encoder.<l>.*` and `decoder.<l>.*` of the
    encoder-decoder (`lm_params_from_reference`,
    `encdec_params_from_reference`)."""
    parts = name.split(".")
    return len(parts) > 2 and parts[0] in _STACKS and parts[1].isdigit()


def reference_path(name: str, period: int = 1) -> str:
    """The reference's '/'-joined tree path of a port parameter: layer l of
    `blocks` is super-block l // period at `pos<l % period>`; the
    encoder-decoder's stacks have no position level."""
    parts = name.split(".")
    if not is_stacked(name):
        return "/".join(parts)
    stack, layer, rest = parts[0], int(parts[1]), parts[2:]
    if stack == "blocks":
        return "/".join([stack, f"pos{layer % period}", *rest])
    return "/".join([stack, *rest])


def lm_params_from_reference(tree) -> dict[str, torch.Tensor]:
    """The port LM's state dict from the reference `LM.init` tree, given as
    nested dicts of NumPy arrays: {"embed": {"embedding"}, "final_ln",
    ["in_proj",] "blocks": {"pos<i>": {part: {...}}}}, where every leaf of
    `blocks` leads with the super-block axis and the parts are those of the
    block's kind (attn, mlp, moe, rglru, mlstm, slstm).  Layer s * period + i
    of the port is super-block s, pattern position i.  Values stay f32 on
    the CPU; `LM.load_params` casts and moves them."""
    state = {"embed.embedding": _f32(tree["embed"]["embedding"]),
             "final_ln": _f32(tree["final_ln"])}
    if "in_proj" in tree:
        state["in_proj"] = _f32(tree["in_proj"])
    blocks = tree["blocks"]
    period = len(blocks)
    for i in range(period):
        _stacked(state, "blocks", blocks[f"pos{i}"],
                 lambda s, i=i: s * period + i)
    return state


def encdec_params_from_reference(tree) -> dict[str, torch.Tensor]:
    """The port `EncDecLM`'s state dict from the reference `EncDecLM.init`
    tree: {"embed": {"embedding"}, "in_proj", "pos_embed", "final_ln",
    "enc_final_ln", "encoder": {"attn", "mlp"}, "decoder": {"self_attn",
    "cross_attn", "mlp"}}, the layer stacks leading with the layer axis."""
    state = {"embed.embedding": _f32(tree["embed"]["embedding"])}
    for name in ("in_proj", "pos_embed", "final_ln", "enc_final_ln"):
        state[name] = _f32(tree[name])
    for stack in ("encoder", "decoder"):
        _stacked(state, stack, tree[stack], lambda s: s)
    return state


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def lm_cache_from_reference(tree, num_layers: int) -> list[dict]:
    """The port LM's decode cache (one dict a layer) from the reference's
    {"pos<i>": {leaf: (n_super, ...)}}: KV caches (k, v, and k_scale,
    v_scale for int8; pos_ids for a rolling window) and recurrent states
    (rglru conv/h; mLSTM conv/C/n/m; sLSTM h/c/n/m), in their own dtypes
    (bf16 as torch.bfloat16) on the CPU."""
    period = len(tree)
    cache = [None] * num_layers
    for i in range(period):
        leaves = tree[f"pos{i}"]
        for s in range(num_layers // period):
            cache[s * period + i] = {k: _tensor(np.asarray(a)[s])
                                     for k, a in leaves.items()}
    return cache


def lm_cache_to_reference(cache: list[dict], period: int) -> dict:
    """The reference's cache tree (NumPy arrays; bf16 as f32) from the port
    LM's list of per-layer dicts: the inverse of
    `lm_cache_from_reference`."""
    n_super = len(cache) // period
    return {f"pos{i}": {k: np.stack([_array(cache[s * period + i][k])
                                     for s in range(n_super)])
                        for k in cache[i]}
            for i in range(period)}


def adamw_state_from_reference(opt) -> dict:
    """The port's AdamW state from the reference's `adamw.init_state` /
    `apply_updates` state {"mu": tree, "nu": tree, "step"}, given as nested
    dicts of NumPy arrays: the moments keyed by the port's state-dict names
    (`lm_params_from_reference`, in their own dtype where it is f32 or
    bfloat16), the step an int32 scalar.  On the CPU."""
    def moments(tree):
        out = lm_params_from_reference(tree)
        first = np.asarray(tree["final_ln"])
        if first.dtype.name == "bfloat16":
            out = {k: v.to(torch.bfloat16) for k, v in out.items()}
        return out

    return {"mu": moments(opt["mu"]), "nu": moments(opt["nu"]),
            "step": torch.tensor(int(np.asarray(opt["step"])),
                                 dtype=torch.int32)}
