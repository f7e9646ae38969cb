"""Multi-pod dry-run (the port of `repro.launch.dryrun`): trace every
(architecture x input shape) cell on the production meshes without a
device, prove memory fits, and extract the roofline terms.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all            # 40 cells, 16x16
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod

The reference lowers and compiles each step with XLA on 512 host devices
and reads XLA's cost and memory analyses.  The port runs each step once, on
this process alone, as rank 0 of a fake world of 256 (512) ranks whose
collectives move nothing (`launch.mesh.fake_world`): parameters, state,
batch and cache are DTensors of FakeTensors (shapes and dtypes, no storage)
laid out by `launch.steps`' specs, on the card's device type ("cuda"; the
CPU when the caller asks, `--device cpu`, as the tests do).  Nothing runs
on a device.  During the step

  * `CostMode` sees every op a rank runs on its local tensors (DTensor
    desugars each op first) and sums its FLOPs (PyTorch's formulas, and
    K3's registered ones: attention is counted as the kernel computes it,
    never as the plain version's score matrix), the bytes its operands and
    results occupy (no fusion: an upper bound) and, for each collective
    (all-gather, all-reduce, reduce-scatter, all-to-all), the bytes of its
    result on this rank;
  * PyTorch's `MemTracker` takes the peak of the bytes allocated during
    the step; the arguments (the local bytes of parameters, optimizer
    state, batch and cache) are counted from their DTensors.

An eager trace counts every layer, so the counts come from the full-depth
trace; the reference extrapolates from depths 1 and 2 because XLA counts a
scan body once.  The sLSTM's S time steps are one registered op
(`repro_torch::slstm_scan`, its backward `repro_torch::slstm_scan_bwd`),
traced once a layer and counted by their FLOP formulas: all four recurrent
products of every step, where the reference's rolled scan counts its body
once.  `extrapolated_costs` is kept for the cells whose full trace is slow:
the mLSTM's chunkwise form is a Python loop over chunks (xlstm-1.3b's
train_4k and prefill_32k, 16 and 128 chunks a layer) -- there the counts
and the memory are affine in depth and taken from the depth-1 and depth-2
traces (`EXTRAPOLATED_KINDS`).

The roofline uses one H100 SXM5's datasheet numbers (`launch.mesh`); the
memory bar is its 80 GiB (`fits_hbm`).  Records go to
`artifacts/dryrun_torch/` (gitignored).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import time
import warnings

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeConfig,
                                      cell_is_applicable, get_config)
from repro_torch.device import resolve_device
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import (COLL_BW, HBM_BW, HBM_BYTES,
                                     PEAK_FLOPS_BF16, fake_world,
                                     make_production_mesh, production_axes)
from repro_torch.models.model import build_model, cache_specs, input_specs
from repro_torch.optim import adamw
from repro_torch.parallel import sharding

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "artifacts", "dryrun_torch")

# Block kinds whose full-depth trace is slow at long sequences: the mLSTM
# loops over its chunks in Python (the sLSTM's steps are one op).  Cells of
# a model with one, other than decode, take `extrapolated_costs`.
EXTRAPOLATED_KINDS = ("mlstm",)

_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def _bytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


class CostMode(TorchDispatchMode):
    """Counts what this rank computes on its local tensors: FLOPs (the
    registered formulas), bytes of operands and results, and collectives
    as (kind, result bytes).  An op on DTensors is returned to DTensor
    (NotImplemented), which runs it as local ops and collectives that come
    back here."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.collectives: list[tuple[str, int]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        flat, _ = tree_flatten((args, kwargs))
        if any(isinstance(a, DTensor) for a in flat):
            return NotImplemented
        out = func(*args, **kwargs)
        packet = getattr(func, "_overloadpacket", None)
        name = getattr(packet, "__name__", "")
        if name in _COLLECTIVES and "c10d_functional" in str(packet):
            outs, _ = tree_flatten(out)
            self.collectives.append((_COLLECTIVES[name],
                                     sum(_bytes(o) for o in outs)))
            return out
        if packet in self.registry:
            self.flops += int(self.registry[packet](*args, **kwargs,
                                                    out_val=out))
        outs, _ = tree_flatten(out)
        self.bytes += sum(_bytes(a) for a in flat) + sum(_bytes(o)
                                                         for o in outs)
        return out


def collective_bytes(records) -> dict:
    """Per-device result bytes of every collective of a trace
    ([(kind, bytes)], as `CostMode.collectives` holds them), keyed by
    kind, with their "total" and the number of "ops"."""
    out: dict[str, int] = {}
    for kind, b in records:
        out[kind] = out.get(kind, 0) + b
    out["total"] = sum(out.values())
    out["ops"] = len(records)
    return out


def count_params(cfg: ModelConfig) -> tuple[float, float]:
    """(total, active) parameter counts from the parameters' shapes."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        model = build_model(cfg, "cpu")
        shapes = [(k, p.shape) for k, p in model.named_parameters()]
    total = active = 0.0
    for name, shape in shapes:
        n = 1.0
        for d in shape:
            n *= d
        total += n
        if "expert" in name.lower() and cfg.num_experts:
            active += n * (cfg.top_k / cfg.num_experts)
        else:
            active += n
    return total, active


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Useful-work FLOPs for the cell (global): 6*N_active*tokens for training,
    2*N_active*tokens for inference."""
    _, active = count_params(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * active * tokens
    return 2.0 * active * shape.global_batch  # decode: one token per sequence


def _local_bytes(tree) -> int:
    flat, _ = tree_flatten(tree)
    return sum(_bytes(t.to_local() if sharding.is_dtensor(t) else t)
               for t in flat if isinstance(t, torch.Tensor))


def _fake_like(tree, device):
    """Fake tensors of the meta stand-ins' shapes and dtypes on `device`."""
    return S._tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype,
                                             device=device), tree)


@contextlib.contextmanager
def _quiet():
    """DTensor warns on every two-axis redistribution and on the fake
    group's all-to-all; the trace is not the place for them."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        prev = logging.root.manager.disable
        logging.disable(logging.WARNING)
        try:
            yield
        finally:
            logging.disable(prev)


@contextlib.contextmanager
def _unobserved_propagation():
    """DTensor derives an op's output shape by running the op once on fake
    tensors of the *global* shapes (its sharding propagator).  That run is
    no rank's work, and its global-shape results would swamp the counts
    and the memory peak: run it with the trace's modes set aside."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.utils._python_dispatch import _disable_current_modes

    name = next((n for n in ("_propagate_tensor_meta_non_cached",
                             "_propagate_tensor_meta")
                 if hasattr(ShardingPropagator, n)), None)
    if name is None:
        raise RuntimeError("dryrun: this torch's DTensor has no known "
                           "shape-propagation hook; its global-shape runs "
                           "would be counted as a rank's work")
    orig = getattr(ShardingPropagator, name)

    def unobserved(self, *args, **kwargs):
        with _disable_current_modes():
            return orig(self, *args, **kwargs)

    setattr(ShardingPropagator, name, unobserved)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, orig)


def lower_cell(cfg: ModelConfig, shape: ShapeConfig, mesh,
               rules: sharding.AxisRules | None = None, extra_opt=None
               ) -> dict:
    """Build the right step for one cell and trace it once on fake DTensors
    under the active fake world.  Returns what `analyze` reads: "flops",
    "bytes" and "coll" (`collective_bytes`) a device, "args_bytes",
    "temp_bytes" (the peak allocated during the step) and "output_bytes" a
    device, and "trace_s"."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker

    rules = rules or sharding.AxisRules()
    opt_cfg = extra_opt or adamw.AdamWConfig(state_dtype=cfg.optimizer_dtype)
    dev = mesh.device_type
    t0 = time.perf_counter()
    with _quiet(), FakeTensorMode(), sharding.use_mesh(mesh, rules):
        batch = S.distribute(_fake_like(input_specs(cfg, shape), dev),
                             S.batch_sharding(cfg, shape, mesh, rules), mesh)
        if shape.kind == "train":
            model, step = S.make_train_step(cfg, opt_cfg, dev)
            pshd = S.state_shardings(model, mesh, rules)["params"]
            params = S.distribute({k: p.detach() for k, p in
                                   model.named_parameters()}, pshd, mesh)
            state = {"params": params,
                     "opt": adamw.init_state(opt_cfg, params)}
            args = (state, batch)
        elif shape.kind == "prefill":
            model, step = S.make_prefill_step(cfg, dev)
            pshd = S.state_shardings(model, mesh, rules, opt=False)
            params = S.distribute({k: p.detach() for k, p in
                                   model.named_parameters()}, pshd, mesh)
            args = (params, batch)
        else:
            model, step = S.make_decode_step(cfg, dev)
            pshd = S.state_shardings(model, mesh, rules, opt=False)
            params = S.distribute({k: p.detach() for k, p in
                                   model.named_parameters()}, pshd, mesh)
            cache = S.distribute(_fake_like(cache_specs(cfg, shape), dev),
                                 S.cache_sharding(cfg, shape, mesh, rules),
                                 mesh)
            args = (params, cache, batch, shape.seq_len - 1)
        args_bytes = _local_bytes(args[:-1] if shape.kind == "decode"
                                  else args)
        mt = MemTracker()
        with _unobserved_propagation(), mt, CostMode() as cost:
            out = step(*args)
        peak = mt.get_tracker_snapshot("peak")
        temp = max(v["Total"] for d, v in peak.items()
                   if torch.device(d).type != "meta")
        out_bytes = _local_bytes(out)
    return dict(flops=float(cost.flops), bytes=float(cost.bytes),
                   coll=collective_bytes(cost.collectives),
                   args_bytes=args_bytes, temp_bytes=temp,
                   output_bytes=out_bytes,
                   trace_s=time.perf_counter() - t0)


def _depth_variant(cfg: ModelConfig, n_periods: int) -> ModelConfig:
    import dataclasses
    period = len(cfg.block_pattern)
    kw = {"num_layers": period * n_periods}
    if cfg.encoder_layers:
        kw["encoder_layers"] = n_periods
        kw["num_layers"] = n_periods
    return dataclasses.replace(cfg, **kw)


def _n_periods(cfg: ModelConfig) -> int:
    return (cfg.num_layers // len(cfg.block_pattern)
            if not cfg.encoder_layers else cfg.num_layers)


def extrapolated_costs(cfg: ModelConfig, shape: ShapeConfig, mesh,
                       rules=None) -> dict:
    """The full-depth counts from depth-1 and depth-2 traces, extrapolated
    linearly (exact for anything affine in depth: FLOPs, bytes,
    collectives, arguments; the peak of temporaries is taken affine too,
    an estimate)."""
    c1 = lower_cell(_depth_variant(cfg, 1), shape, mesh, rules)
    c2 = lower_cell(_depth_variant(cfg, 2), shape, mesh, rules)
    n = _n_periods(cfg)

    def ext(a, b):
        return a + (n - 1) * (b - a)

    coll = {k: ext(c1["coll"].get(k, 0), c2["coll"].get(k, 0))
            for k in set(c1["coll"]) | set(c2["coll"])}
    out = {k: ext(c1[k], c2[k]) for k in
           ("flops", "bytes", "args_bytes", "temp_bytes", "output_bytes")}
    out.update(coll=coll, trace_s=c1["trace_s"] + c2["trace_s"],
               depth1=c1, depth2=c2, n_periods=n)
    return out


def needs_extrapolation(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    return (shape.kind != "decode"
            and any(k in cfg.block_pattern for k in EXTRAPOLATED_KINDS))


def analyze(lowered: dict, cfg: ModelConfig, shape: ShapeConfig, mesh,
            rules=None) -> dict:
    from repro_torch.models.flops import cell_bytes, cell_flops

    sizes = sharding.axis_sizes(mesh)
    n_dev = 1
    for s in sizes.values():
        n_dev *= s
    flops_dev, bytes_dev = lowered["flops"], lowered["bytes"]
    coll_dev = float(lowered["coll"]["total"])

    af = cell_flops(cfg, shape)
    analytic_hw_dev = af["expected_hw"] / n_dev
    model_par = sizes.get("model", 1)
    ab = cell_bytes(cfg, shape, n_dev, model_par)

    compute_t = max(analytic_hw_dev, flops_dev) / PEAK_FLOPS_BF16
    memory_t = ab["bytes_per_dev"] / HBM_BW
    coll_t = coll_dev / COLL_BW
    terms = {"compute_s": compute_t, "memory_s": memory_t,
             "collective_s": coll_t}
    bound = max(terms, key=terms.get)
    step_t = max(terms.values())
    mfu = (af["useful"] / (PEAK_FLOPS_BF16 * n_dev)) / step_t if step_t > 0 else 0.0
    total = lowered["args_bytes"] + lowered["temp_bytes"]

    return {
        "arch": cfg.name,
        "shape": shape.name,
        "kind": shape.kind,
        "mesh": "x".join(str(s) for s in sizes.values()),
        "devices": n_dev,
        "compile_s": round(lowered["trace_s"], 1),
        "extrapolated": "n_periods" in lowered,
        "memory": {
            "args_bytes_per_dev": lowered["args_bytes"],
            "temp_bytes_per_dev": lowered["temp_bytes"],
            "output_bytes_per_dev": lowered["output_bytes"],
            "total_gib_per_dev": round(total / 2**30, 3),
            "hbm_gib": HBM_BYTES / 2**30,
            "fits_hbm": total < HBM_BYTES,
        },
        "hlo_flops_per_dev": flops_dev,
        "hlo_bytes_per_dev_upper": bytes_dev,   # no-fusion upper bound
        "analytic_bytes_per_dev": ab["bytes_per_dev"],
        "collective_bytes_per_dev": coll_dev,
        "collectives": lowered["coll"],
        "hlo_raw_per_dev": {"flops": flops_dev, "bytes": bytes_dev,
                            "coll": coll_dev},
        "analytic_flops": af,
        "roofline": dict(terms, bound=bound, step_time_s=step_t),
        "useful_flops_ratio": (af["useful"] / (flops_dev * n_dev)) if flops_dev else 0.0,
        "mfu_estimate": mfu,
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             rules: sharding.AxisRules | None = None, save: bool = True,
             extrapolate: bool | None = None, device: str = "cuda") -> dict:
    """One cell in a fake world of the production mesh's size (started
    here unless one of that size is running), its tensors fake ones on
    `device`'s type."""
    import torch.distributed as dist

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = cell_is_applicable(cfg, shape)
    if extrapolate is None:
        extrapolate = needs_extrapolation(cfg, shape)
    if not ok:
        rec = {"arch": arch, "shape": shape_name, "skipped": why}
    else:
        n = 1
        for s in production_axes(multi_pod).values():
            n *= s
        world = (contextlib.nullcontext() if dist.is_initialized()
                 and dist.get_world_size() == n else fake_world(n))
        with world:
            mesh = make_production_mesh(
                multi_pod=multi_pod,
                device_type=resolve_device(device).type)
            lowered = (extrapolated_costs(cfg, shape, mesh, rules)
                       if extrapolate else lower_cell(cfg, shape, mesh, rules))
            rec = analyze(lowered, cfg, shape, mesh, rules)
    if save:
        tag = "multipod" if multi_pod else "singlepod"
        d = os.path.abspath(os.path.join(ARTIFACT_DIR, tag))
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, f"{arch}__{shape_name}.json"), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--strict", action="store_true", help="stop on first failure")
    ap.add_argument("--json", action="store_true",
                    help="print each record as one JSON line as well")
    ap.add_argument("--device", default="cuda",
                    help="device type of the fake tensors (cuda or cpu)")
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        # cheap cells first so partial sweeps still cover most of the table
        arch_order = ["smollm-360m", "phi3-medium-14b", "stablelm-12b",
                      "qwen3-14b", "moonshot-v1-16b-a3b", "seamless-m4t-large-v2",
                      "recurrentgemma-9b", "llama4-maverick-400b-a17b",
                      "qwen2-vl-72b", "xlstm-1.3b"]
        shape_order = ["decode_32k", "long_500k", "train_4k", "prefill_32k"]
        for a in arch_order:
            for s in shape_order:
                cells.append((a, s))
    else:
        assert args.arch and args.shape, "--arch and --shape (or --all)"
        cells = [(args.arch, args.shape)]

    failed = 0
    for arch, shape_name in cells:
        t0 = time.time()
        try:
            rec = run_cell(arch, shape_name, multi_pod=args.multi_pod,
                           device=args.device)
        except Exception as e:  # a dry-run failure is a bug; surface loudly
            failed += 1
            msg = str(e).splitlines()[0][:200] if str(e) else ""
            print(f"FAIL  {arch} x {shape_name}: {type(e).__name__}: {msg}", flush=True)
            if args.strict:
                raise
            continue
        if "skipped" in rec:
            print(f"SKIP  {arch} x {shape_name}: {rec['skipped']}")
            continue
        r = rec["roofline"]
        print(f"OK    {arch} x {shape_name} [{rec['mesh']}] "
              f"trace {rec['compile_s']}s | "
              f"mem/dev {rec['memory']['total_gib_per_dev']} GiB fits={rec['memory']['fits_hbm']} | "
              f"compute {r['compute_s']:.3e}s mem {r['memory_s']:.3e}s coll {r['collective_s']:.3e}s "
              f"bound={r['bound']} | useful {rec['useful_flops_ratio']:.2f} "
              f"MFU~{rec['mfu_estimate']:.2%} ({time.time()-t0:.0f}s)", flush=True)
        if args.json:
            print(json.dumps(rec), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
