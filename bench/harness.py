"""One run of one cell: set-up, the measured window, the check, the result.

The window drives the port's co-design search as its users do:
`CodesignEngine(config).session(layers)`, stepped by `SearchSession.step()`
until `--seconds` have passed; the step that crosses the mark ends the
window, after `torch.cuda.synchronize()`.  A search that ends its outer
budget inside the window is followed at once by the next, on the next seed
of a fixed set, in an order drawn from `--seed`; its engine is built
inside the window.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file found by name: `configs/<config>.json`,
`traffic/<traffic>.json`, `metrics/<metric>.py`.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import importlib.util
import json
import math
import os
import random
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

import tracing
from patch import Patches
from breakdown import breakdown, busy_s

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_age_s() -> float:
    """Seconds since this process started, on the boot clock the kernel
    stamps a process's start with."""
    ticks = os.sysconf("SC_CLK_TCK")
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19]) / ticks
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is JAX's,
    jaxlib's, flax's or the JAX package's, compared whole."""
    return sorted({name for name in sys.modules
                   if name.split(".", 1)[0] in FORBIDDEN})


def load_manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_cell(workload: str) -> tuple[dict, dict, dict]:
    """(workload entry, configuration, traffic mix) for a cell's name."""
    manifest = load_manifest()
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json; "
                         f"known: {sorted(cells)}")
    cell = cells[workload]
    config = json.loads(
        (BENCH / "configs" / f"{cell['config']}.json").read_text())
    traffic = json.loads(
        (BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    return cell, config, traffic


def metric_names(workload: str, trace: bool) -> list[tuple[str, str]]:
    """(name, unit) of the metrics a cell reports: its end-to-end metrics,
    or with a trace its per-layer ones."""
    manifest = load_manifest()
    group = manifest["per_layer" if trace else "end_to_end"]
    return [(m["name"], m["unit"]) for m in group
            if workload in m.get("workloads", [workload])]


def load_reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


# The window's searches: one fixed set, the same for every `--seed`, so that
# every run measures the same work; a search's cost follows from its seed.
SEARCHES = 4


def search_seeds(seed: int):
    """The measured searches' seeds, then the warm-up's (never one of them).
    The measured ones pass through the fixed set of `SEARCHES` again and
    again, each pass in an order drawn from `--seed`; the warm-up's is a
    draw from a hash of `--seed`.  Seeds are 32-bit draws from a hash."""
    def draw(key: str) -> int:
        h = hashlib.blake2s(key.encode(), digest_size=4)
        return int.from_bytes(h.digest(), "big")

    fixed = [draw(f"search:{i}") for i in range(SEARCHES)]
    rng = random.Random(draw(f"{seed}:order"))

    def passes():
        while True:
            yield from rng.sample(fixed, len(fixed))

    warm = draw(f"{seed}:warm-up")
    while warm in fixed:
        warm = (warm + 1) % (1 << 32)
    return passes(), warm


def layers_of(config: dict):
    from repro_torch.timeloop.workloads import ConvLayer

    return [ConvLayer(ly["name"], R=ly["R"], S=ly["S"], P=ly["P"], Q=ly["Q"],
                      C=ly["C"], K=ly["K"], stride=ly["stride"])
            for ly in config["layers"]]


def codesign_config(config: dict, traffic: dict, seed: int, device: str):
    """The search's `CodesignConfig`: the traffic mix's budgets and engine,
    the configuration's PE budget and precision."""
    from repro_torch.core.config import CodesignConfig

    if config["dtype"] != "float64":
        raise ValueError(f"the search's cost model and GPs run in float64; "
                         f"the configuration states {config['dtype']}")
    d = json.loads(json.dumps(traffic["search"]))
    d["hw"]["num_pes"] = config["budget"]["num_pes"]
    d["engine"]["device"] = device
    d["seed"] = seed
    return CodesignConfig.from_dict(d)


def warm_up_config(cfg):
    """The set-up's short search: the cell's pools, strategy and engine, two
    outer warm-up probes and two scored trials, each inner search two scored
    trials past its warm-up."""
    sw = dataclasses.replace(cfg.sw, n_trials=cfg.sw.n_warmup + 2)
    n_warm = min(cfg.hw.n_warmup, 2)
    hw = dataclasses.replace(cfg.hw, n_warmup=n_warm, n_trials=n_warm + 2)
    return dataclasses.replace(cfg, sw=sw, hw=hw)


def prune_margin(cfg) -> float | None:
    if cfg.hw.prune == "off":
        return None
    return 1.0 if cfg.hw.prune == "safe" else cfg.hw.prune_margin


# --- what the window's searches answered -------------------------------------

GP = "repro_torch.core.gp"
# GP queries the check works out again: each kind a sample of this size,
# drawn from the seed, plus the window's last.
GP_SAMPLE = 8


class Recorder:
    """Hooks around the inner searches, the prune gate and the GP surrogates
    that keep what the window's searches answered, for the check after the
    window.  With a tracer, the inner searches' hooks open its spans too."""

    def __init__(self, seed: int):
        self.inner: list = []
        self.gp: dict[str, list] = {}
        self.gp_seen: dict[str, int] = {}
        self._rng = random.Random(seed)

    def install(self, patches) -> None:
        from repro_torch.core import nested

        def keep(items_of):
            def hook(call, *args, **kwargs):
                results = call(*args, **kwargs)
                self.inner.append((items_of(args, kwargs), results))
                return results
            return hook

        for name, items_of in (
                ("optimize_software", lambda a, k: [(a[0], a[1])]),
                ("optimize_software_many",
                 lambda a, k: [(a[0], ly) for ly in a[1]]),
                ("optimize_software_fanout", lambda a, k: list(a[0]))):
            if not patches.hook(nested.__name__, None, name, keep(items_of)):
                raise RuntimeError(f"the search has no {name}: the check "
                                   "cannot see its answers")
        for owner in ("GP", "GPStack"):
            patches.hook(GP, owner, "fit", self._fit)
            patches.hook(GP, owner, "posterior_device",
                         functools.partial(self._query, owner))
        patches.hook(GP, "GP", "append_observation", self._append)
        patches.hook(GP, "GPStack", "score_device", self._score)

    def session(self, engine, layers) -> "Search":
        search = Search(engine.session(layers))
        self.inner = search.inner
        return search

    # The GP's data stays on the model it was fit to; a query keeps
    # references only, read after the window.
    @staticmethod
    def _fit(call, model, X, y):
        runs = ([X] if isinstance(X, np.ndarray) and X.ndim == 2 else X)
        ys = [y] if runs is not X else y
        model._bench_data = ([np.array(x, np.float64) for x in runs],
                             [np.array(v, np.float64) for v in ys])
        return call(model, X, y)

    @staticmethod
    def _append(call, model, x, y):
        out = call(model, x, y)
        Xs, ys = model._bench_data
        model._bench_data = ([np.vstack([Xs[0], np.asarray(x, np.float64)])],
                             [np.append(ys[0], float(y))])
        return out

    def _keep(self, kind: str, item: dict) -> None:
        """A sample of `GP_SAMPLE` queries of a kind, drawn from the seed
        (reservoir sampling), and the last query."""
        i = self.gp_seen.get(kind, 0)
        self.gp_seen[kind] = i + 1
        kept = self.gp.setdefault(kind, [None] * (GP_SAMPLE + 1))
        if i < GP_SAMPLE:
            kept[i] = item
        else:
            j = self._rng.randrange(i + 1)
            if j < GP_SAMPLE:
                kept[j] = item
        kept[GP_SAMPLE] = item

    def _query(self, owner: str, call, model, Xs):
        mu, var = call(model, Xs)
        self._keep(owner + ".posterior", {
            "model": model, "pool": Xs, "mu": mu, "var": var,
            "params": model._state[0]})
        return mu, var

    def _score(self, call, model, feats, best, acquisition="lcb", lam=1.0):
        import repro_torch.core.gp as gp

        seen = []
        posterior = gp._posterior

        def kept(*args, **kwargs):
            seen.append(posterior(*args, **kwargs))
            return seen[-1]

        gp._posterior = kept
        try:
            idx, rows = call(model, feats, best, acquisition, lam)
        finally:
            gp._posterior = posterior
        self._keep("GPStack.score", {
            "model": model, "pool": feats, "mu": seen[0][0],
            "var": seen[0][1], "best": np.asarray(best, np.float64),
            "acquisition": acquisition, "lam": float(lam), "idx": idx,
            "params": model._state[0]})
        return idx, rows

    def gp_records(self) -> list[dict]:
        """Plain data of the kept GP queries, in the order they came."""
        import torch

        out = []
        for kind, kept in sorted(self.gp.items()):
            items = list({id(x): x for x in kept if x is not None}.values())
            for item in items:
                model = item["model"]
                Xs, ys = model._bench_data
                pool = torch.as_tensor(item["pool"]).detach().cpu().numpy()
                if pool.ndim == 2:
                    pool = pool[None]
                rec = {"kind": kind, "kernel": model.kind,
                       "noisy": bool(model.noisy), "X": Xs, "y": ys,
                       "pool": pool.astype(np.float64),
                       "mu": _rows(item["mu"]), "var": _rows(item["var"])}
                if "params" in item:
                    rec["params"] = {
                        k: torch.as_tensor(v).detach().cpu().to(
                            torch.float64).numpy()
                        for k, v in item["params"].items()}
                if "idx" in item:
                    rec.update(best=item["best"], idx=np.asarray(item["idx"]),
                               acquisition=item["acquisition"],
                               lam=item["lam"])
                out.append(rec)
        return out


def _rows(t) -> np.ndarray:
    import torch

    a = torch.as_tensor(t).detach().cpu().to(torch.float64).numpy()
    return a[None] if a.ndim == 1 else a


class Search:
    """One search of the window: its session and what it answered."""

    def __init__(self, session):
        self.session = session
        self.inner: list = []
        self.censored: list[bool] = []
        gate = self._gate = session.gate
        if gate is not None:
            def logged(hw, count=True):
                out = gate(hw, count)
                self.censored.append(out is not None)
                return out
            session.gate = logged

    def fills(self) -> int:
        """Probes searched ahead of their trial so far (speculation)."""
        return self.session.engine.stats.get("spec_evaluated", 0)

    def record(self) -> dict:
        """Plain data of everything the check compares."""
        s = self.session
        res = s.loop.result
        n = len(res.points)
        censored = (self.censored if self.session.gate is not self._gate
                    else [False] * n)
        # A probe the gate log does not account for is checked as refuted.
        censored = (list(censored) + [None] * n)[:n]
        inner = []
        for items, results in self.inner:
            for (hw, layer), r in zip(items, results):
                inner.append({
                    "hw": _hw(hw), "layer": layer.name,
                    "points": [_mapping(m) for m in r.points],
                    "values": [float(v) for v in r.values],
                    "best_point": _mapping(r.best_point)})
        return {
            "outer": [{"hw": _hw(hw), "value": float(v), "censored": c}
                      for hw, v, c in zip(res.points, res.values, censored)],
            "inner": inner,
            "cache": [((_hw(hw), layer.name), (_mapping(m), float(edp)))
                      for (hw, layer), (m, edp) in s.engine.cache.items()],
            "best": {"edp": float(s.best["edp"]),
                     "hw": _hw(s.best["hw"]) if s.best["hw"] else None},
        }

    def summary(self) -> dict:
        s = self.session
        res = s.result()
        out = {"seed": s.engine.config.seed, "done": s.done,
               "probes": len(s.loop.result.points),
               "stats": {k: res.stats.get(k) for k in (
                   "spec_evaluated", "spec_hits", "spec_hit_rate",
                   "probes_gated", "prune_considered", "prune_pruned",
                   "pruned_fraction", "cache_hits", "cache_misses")}}
        if res.best_hw is not None:
            out["best_log10_edp"] = float(math.log10(res.best_model_edp))
            out["design_hash"] = design_hash(res)
        return out


def _hw(hw) -> dict:
    return dataclasses.asdict(hw)


def _mapping(m):
    if m is None:
        return None
    return (tuple(tuple(int(x) for x in row) for row in m.factors),
            tuple(m.order_gb), tuple(m.order_dram))


def design_hash(result) -> str:
    hw = dataclasses.astuple(result.best_hw)
    maps = sorted((n, dataclasses.astuple(m))
                  for n, m in result.best_mappings.items())
    return hashlib.sha256(repr((hw, maps)).encode()).hexdigest()


# --- the run -----------------------------------------------------------------

def card() -> dict:
    """The card's name and power limit, from nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out = f"nvidia-smi failed: {e}"
    return {"nvidia_smi": out}


def run_cell(workload: str, config: dict, traffic: dict, seed: int,
             seconds: float, trace: bool, device: str = "cuda",
             patch=None) -> dict:
    """Set up, measure, check.  Returns the result line and the earlier
    line's facts.  `patch`, where given, adds hooks of its own around the
    window (the control and the planted faults): `patch(patches)`."""
    import torch

    from repro_torch.core import CodesignEngine
    from reference import check

    info: dict = {"workload": workload, "seed": seed, "device": device,
                  "threads": torch.get_num_threads(),
                  "host_loop_s": [host_loop_s()]}
    seeds, warm_seed = search_seeds(seed)
    layers = layers_of(config)
    cuda = device == "cuda"
    if cuda:
        from repro_torch.kernels import build

        info["build_s"] = build.build_all(("edp_reduce",))
        torch.cuda.reset_peak_memory_stats()
    warm = CodesignEngine(warm_up_config(
        codesign_config(config, traffic, warm_seed, device)))
    warm.run(layers)
    warm.close()
    del warm
    if cuda:
        torch.cuda.synchronize()

    patches = Patches()
    if patch is not None:
        patch(patches)
    recorder = Recorder(seed)
    recorder.install(patches)
    tracer = None
    if trace:
        tracer = tracing.Tracer()
        tracer.install(patches)
        if cuda:
            prof = tracing.start_profiler()
    searches: list[Search] = []
    engines = []
    try:
        setup_s = process_age_s()
        usage0 = _usage()
        t0, wall_ns = time.perf_counter(), time.time_ns()
        if tracer is not None:
            tracer.start()
        step_ends = []
        ahead = 0
        while True:
            if not searches or searches[-1].session.done:
                engine = CodesignEngine(codesign_config(
                    config, traffic, next(seeds), device))
                engines.append(engine)
                searches.append(recorder.session(engine, layers))
            search = searches[-1]
            fills = search.fills()
            search.session.step()
            step_ends.append(time.perf_counter() - t0)
            if step_ends[-1] < seconds:
                continue
            # The step that crosses the mark ends the window; where it
            # searched probes ahead of their trials (speculation), the
            # window runs on through as many steps, which take them up.
            ahead = ahead - 1 if ahead else search.fills() - fills
            if ahead <= 0 or search.session.done:
                break
        if cuda:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
        usage = _usage(usage0)
    finally:
        patches.remove()
    events = None
    if tracer is not None and cuda:
        t_read = time.perf_counter()
        events = tracing.device_events(prof, wall_ns)
        info["trace_read_s"] = time.perf_counter() - t_read
    for engine in engines:
        engine.close()
    info["host_loop_s"].append(host_loop_s())

    probes = sum(len(s.session.loop.result.points) for s in searches)
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    info.update(card() if cuda else {})
    steps = len(step_ends)
    info.update(window_s=window_s, setup_s=setup_s, steps=steps,
                step_s=[b - a for a, b in zip([0.0] + step_ends, step_ends)],
                probes=probes, usage=usage,
                searches=[s.summary() for s in searches])
    records = [s.record() for s in searches]
    gp_records = recorder.gp_records()
    info["gp_checked"] = dict(recorder.gp_seen)
    cfg = engines[0].config
    record = None
    if tracer is not None:
        record = {"window_s": window_s, "probes": probes,
                  "spans": dict(tracer.spans),
                  "missing": dict(tracer.missing),
                  "k1b": tracer.k1b_launches(),
                  "k1b_kernel": tracing.K1B_KERNEL,
                  "gp_flops": tracer.gp_flops(), "device": events}
    del searches, engines, recorder, tracer
    if cuda:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    verdict = check.check(records, config, prune_margin(cfg), gp_records)
    info["check_s"] = time.perf_counter() - t_check
    metrics = {}
    if trace:
        for name, unit in metric_names(workload, trace=True):
            value = load_reader(name)(record)
            if value is not None:
                metrics[name] = {"value": value, "unit": unit}
    else:
        for name, unit in metric_names(workload, trace=False):
            value = {"probe_s": window_s / probes if probes else None,
                     "setup_s": setup_s}.get(name)
            if value is not None:
                metrics[name] = {"value": value, "unit": unit}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": memory_peak}
    line = {"correct": verdict["correct"], "attempted": verdict["attempted"],
            "failed": verdict["failed"], "metrics": metrics, "device": dev}
    if record is not None:
        info["trace_missing"] = record["missing"]
        info["k1b_launches"] = len(record["k1b"])
        if events:
            dev["busy_s"] = busy_s(events)
            dev["window_s"] = window_s
            line["breakdown"] = breakdown(record)
        info["device_events"] = len(events) if events is not None else None
    line["check"] = verdict["numbers"]
    return {"line": line, "info": info}


def host_loop_s() -> float:
    """Seconds a fixed pure-Python loop takes: the host's speed for the
    search's single-threaded host work, read before and after the window."""
    t = time.perf_counter()
    x = 0
    for i in range(1_000_000):
        x += i * i
    return time.perf_counter() - t


def _usage(since: dict | None = None) -> dict:
    """The process's CPU seconds, page faults and context switches (since
    `since`): how much of the window the host gave the run."""
    import resource

    r = resource.getrusage(resource.RUSAGE_SELF)
    now = {"user_s": r.ru_utime, "sys_s": r.ru_stime,
           "minor_faults": r.ru_minflt, "major_faults": r.ru_majflt,
           "voluntary_switches": r.ru_nvcsw,
           "involuntary_switches": r.ru_nivcsw}
    if since is None:
        return now
    return {k: now[k] - since[k] for k in now}
