"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's main path -- the nested co-design search,
`CodesignEngine(config).run(MODEL_LAYERS["resnet"])` -- on the card, phase by
phase, one JSON line per phase:

  1. nvidia_smi   the card's name and power limit (`nvidia-smi`)
  2. build        every CUDA kernel built from `src/repro_torch/csrc` (one
                  nvcc per source, started together), with the build seconds
  3. kernel       each kernel against its plain PyTorch version on the card,
                  float64 and float32, at the main path's row counts and a
                  ragged one, operands from real ResNet/DQN/MLP/Transformer
                  candidate pools: max error; per-call times of the kernel's
                  wrapper and of the plain version (CUDA events around one
                  call, warmed, median of 30: what a caller pays, host
                  overhead included); their device times (torch.profiler,
                  mean over 30 calls: what the card spends); the bound
  4. main_path    the search at ResNet's full width (the paper's four layers
                  at their real dims, pool 150, 168 PEs; trial counts cut
                  from the paper's 250/30 and 50/5): wall time, best log10
                  EDP, the kernel launches of the run, the row counts the
                  kernel was launched with; then the same config on the CPU,
                  whose best log10 EDP must agree within 1e-6
  5. profile      one lockstep inner search under torch.profiler: device
                  kernel time by name and the device's idle share
  6. kernels      one line listing every ported kernel with its numbers

and ends with `{"ok": true, "device": {...}}` as its last line.  Any failure
raises with its traceback and a nonzero exit.  Exits nonzero, printing no
result, without a CUDA device or outside a checkout of the repository.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
MODELS = ("resnet", "dqn", "mlp", "transformer")
ROW_COUNTS = (256, 1024, 3072, 8192, 1000)
EDP_OPERANDS = ("fo", "relo", "tiles", "sp", "consts")
# NVIDIA H100 SXM data sheet (dense, at the 700 W limit): HBM3 bandwidth and
# the peak rates outside the tensor cores for the kernel's operand types.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float64: 34e12, torch.float32: 67e12}
BARS = {torch.float64: 1e-12, torch.float32: 1e-6}
EDP_SOURCE = "src/repro_torch/csrc/edp_reduce.cu"
EDP_REPLACES = "src/repro/kernels/edp_reduce.py:136"


def emit(**record) -> None:
    print(json.dumps(record), flush=True)


def cuda_ms(fn, reps: int = 30, warmup: int = 5) -> float:
    """Median milliseconds of one call of `fn`, timed by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int = 30) -> float:
    """Mean device milliseconds of one call of `fn`: the CUDA kernels it
    launches, summed by torch.profiler (host overhead excluded)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if total_us <= 0:
        raise AssertionError("the profiler reported no device time")
    return total_us / reps / 1e3


def edp_operands(n_rows: int, dtype: str):
    """The operands the cost model hands `edp_reduce` for candidate pools of
    the four workloads on Eyeriss (one 150-row pool per run, a 256-row bucket
    each), cut to `n_rows`."""
    from repro_torch.timeloop import MODEL_LAYERS, eyeriss_168
    from repro_torch.timeloop import batch as tlb
    from repro_torch.timeloop import batch_torch as ttlb

    hw = eyeriss_168()
    rng = np.random.default_rng(0)
    layers = [ly for m in MODELS for ly in MODEL_LAYERS[m]]
    runs = [layers[k % len(layers)] for k in range(-(-n_rows // 256))]
    pools = [tlb.sample_valid_pool(rng, hw, ly, 150) for ly in runs]
    ops = ttlb.reduce_operands(hw, pools, runs, dtype, device="cuda")
    return [ops[k][:n_rows].contiguous() for k in EDP_OPERANDS]


def edp_work(ops) -> tuple[int, int]:
    """(bytes, operations) the reduction needs on these operands: each input
    read once and each output written once; the multiplies of the trip and
    pass products this data needs plus the fixed per-row arithmetic (63
    flops: accumulation, energy, delay, EDP)."""
    fo, relo = ops[0], ops[1]
    n = fo.shape[0]
    item = fo.element_size()
    n_values = sum(int(x[0].numel()) for x in ops) + 3 + 6
    pos = torch.arange(6, device=fo.device)
    flops = 63 * n
    for li in range(2):
        f = fo[:, li]
        for ti in range(3):
            rel = relo[:, li, ti] > 0.5
            active = rel & (f > 1.0)
            inner = torch.where(active, pos, -1).amax(dim=1)
            inc = (rel | (pos < inner[:, None])).sum(dim=1)
            flops += int(torch.where(active.any(dim=1), inc - 1, 0).sum())
        rel = relo[:, li, 2] > 0.5
        anchor = torch.where(rel & (f > 1.0), pos, 6).amin(dim=1)
        inc = ((~rel) & (pos < anchor[:, None])).sum(dim=1)
        flops += int((inc - 1).clamp(min=0).sum()) + 2 * n
    return n * n_values * item, flops


def phase_nvidia_smi() -> dict:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(out, flush=True)
    emit(phase="nvidia_smi", card=out)
    return {"card": out}


def phase_build() -> None:
    from repro_torch.kernels import build

    seconds = build.build_all()
    emit(phase="build", seconds=seconds,
         libraries=[str(build.library_path(k).relative_to(ROOT))
                    for k in build.KERNELS])


def measure_edp(n: int, dtype_name: str) -> dict:
    """edp_reduce against its plain version on `n` rows: errors (raising
    past the bar), kernel and plain times, and the bound."""
    from repro_torch.kernels.edp_reduce import edp_reduce, reduce_edp_terms

    ops = edp_operands(n, dtype_name)
    dtype = ops[0].dtype
    ev, trips = edp_reduce(*ops)
    torch.cuda.synchronize()
    ev_p, trips_p = reduce_edp_terms(*ops)
    max_abs = max(float((ev - ev_p).abs().max()),
                  float((trips - trips_p).abs().max()))
    max_rel = float(((ev - ev_p).abs() / ev_p.abs()).max())
    if not max_rel <= BARS[dtype]:
        raise AssertionError(
            f"edp_reduce disagrees with its plain version at {n} rows "
            f"{dtype_name}: max relative error {max_rel}")
    if dtype == torch.float64 and not torch.equal(trips, trips_p):
        raise AssertionError("edp_reduce trips differ in float64")
    n_bytes, flops = edp_work(ops)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    rec = {"rows": n, "dtype": dtype_name, "max_abs_err": max_abs,
           "max_rel_err": max_rel,
           "ms": device_ms(lambda: edp_reduce(*ops)),
           "plain_ms": device_ms(lambda: reduce_edp_terms(*ops)),
           "call_ms": cuda_ms(lambda: edp_reduce(*ops)),
           "plain_call_ms": cuda_ms(lambda: reduce_edp_terms(*ops)),
           "bytes": n_bytes, "flops": flops, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    emit(phase="kernel", name="edp_reduce", **rec)
    return rec


def phase_kernel() -> dict:
    return {(dt, n): measure_edp(n, dt)
            for dt in ("float64", "float32") for n in ROW_COUNTS}


def smoke_config(device: str):
    from repro_torch.core import (CodesignConfig, EngineConfig,
                                  HWSearchConfig, SWSearchConfig)

    return CodesignConfig(
        sw=SWSearchConfig(n_trials=40, n_warmup=10, pool_size=150),
        hw=HWSearchConfig(n_trials=6, n_warmup=3, pool_size=150, num_pes=168),
        engine=EngineConfig(backend="torch", strategy="probe_fanout",
                            device=device),
        seed=0)


def design_hash(result) -> str:
    hw = dataclasses.astuple(result.best_hw)
    maps = sorted((n, dataclasses.astuple(m))
                  for n, m in result.best_mappings.items())
    return hashlib.sha256(repr((hw, maps)).encode()).hexdigest()


def run_search(device: str):
    from repro_torch.core import CodesignEngine
    from repro_torch.timeloop import MODEL_LAYERS

    t0 = time.perf_counter()
    result = CodesignEngine(smoke_config(device)).run(MODEL_LAYERS["resnet"])
    if device == "cuda":
        torch.cuda.synchronize()
    return result, time.perf_counter() - t0


def phase_main_path() -> dict:
    from repro_torch.kernels.edp_reduce import edp_reduce
    from repro_torch.timeloop import MODEL_LAYERS
    from repro_torch.timeloop import batch_torch as ttlb
    from repro_torch.timeloop.model import evaluate

    # Tally the row counts the main path hands the kernel (a pass-through
    # around the engine's reference to the wrapper; the wrapper's own count
    # is what proves the launches).
    rows: dict[int, int] = {}
    inner = ttlb.edp_reduce

    def tally(*ops):
        rows[ops[0].shape[0]] = rows.get(ops[0].shape[0], 0) + 1
        return inner(*ops)

    ttlb.edp_reduce = tally
    edp_reduce.launches = 0
    try:
        result, wall = run_search("cuda")
    finally:
        ttlb.edp_reduce = inner
    launches = edp_reduce.launches
    if launches <= 0:
        raise AssertionError("the main path never launched edp_reduce")
    log10 = float(np.log10(result.best_model_edp))
    layers = MODEL_LAYERS["resnet"]
    edps = [evaluate(result.best_hw, result.best_mappings[ly.name], ly).edp
            for ly in layers]
    if not (np.isfinite(log10) and len(result.best_mappings) == len(layers)
            and np.isclose(sum(edps), result.best_model_edp, rtol=1e-12)):
        raise AssertionError("main path result is not a valid design")
    emit(phase="main_path", device="cuda", wall_s=wall, best_log10_edp=log10,
         launches={"edp_reduce": launches},
         rows_per_launch={str(k): v for k, v in sorted(rows.items())},
         outer_trials=len(result.hw_result.history), stats=result.stats)

    result_cpu, wall_cpu = run_search("cpu")
    log10_cpu = float(np.log10(result_cpu.best_model_edp))
    same_design = design_hash(result) == design_hash(result_cpu)
    emit(phase="main_path", device="cpu", wall_s=wall_cpu,
         best_log10_edp=log10_cpu, same_design_as_card=same_design,
         same_outer_history=result.hw_result.history
         == result_cpu.hw_result.history)
    if abs(log10 - log10_cpu) > 1e-6:
        raise AssertionError(
            f"card and CPU disagree: best log10 EDP {log10} vs {log10_cpu}")
    return {"launches": launches, "rows": rows}


def phase_profile() -> None:
    """One lockstep inner search (the four ResNet layers on Eyeriss, 16
    trials) under torch.profiler: device time by kernel and idle share."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import SWSearchConfig, optimize_software_many
    from repro_torch.timeloop import MODEL_LAYERS, eyeriss_168

    cfg = SWSearchConfig(n_trials=16, n_warmup=10, pool_size=150)
    layers = MODEL_LAYERS["resnet"]
    optimize_software_many(eyeriss_168(), layers, cfg, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        optimize_software_many(eyeriss_168(), layers, cfg, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {}
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels[evt.key] = (evt.self_device_time_total, evt.count)
    busy_s = sum(t for t, _ in kernels.values()) / 1e6
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    emit(phase="profile", what="optimize_software_many resnet n_trials=16",
         wall_s=wall,
         device_kernel_s=busy_s if kernels else None,
         device_launches=sum(c for _, c in kernels.values()),
         idle_share=(1.0 - busy_s / wall) if kernels else None,
         top_kernels={k[:80]: {"us": t, "count": c} for k, (t, c) in top},
         note=None if kernels else "the profiler reported no device events")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this smoke run needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)

    card = phase_nvidia_smi()["card"]
    phase_build()
    kern = phase_kernel()
    main_path = phase_main_path()
    phase_profile()

    # The kernel line reports the row count carrying most of the main path's
    # rows, measured in float64 (the search's dtype).  library_ms is null:
    # no single PyTorch call computes this reduction.
    rows = main_path["rows"]
    n_main = max(rows, key=lambda n: n * rows[n])
    rec = kern.get(("float64", n_main)) or measure_edp(n_main, "float64")
    emit(kernels=[{
        "name": "edp_reduce", "route": "cuda", "source": EDP_SOURCE,
        "replaces": EDP_REPLACES, "launches": main_path["launches"],
        "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
        "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"], "library_ms": None,
        "call_ms": rec["call_ms"], "plain_call_ms": rec["plain_call_ms"],
        "rows": n_main, "dtype": "float64", "card": card}])
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
