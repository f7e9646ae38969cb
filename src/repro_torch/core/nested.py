"""Nested hardware/software co-design (paper §4.1, Fig. 1).

Outer loop: constrained BO over hardware configurations (50 trials in the paper).
Inner loop: for each candidate hardware, per-layer constrained BO over software
mappings (250 trials in the paper); layer-wise EDPs are summed into the model
EDP that the hardware optimizer sees.  The hardware objective is noisy (the
inner search is stochastic) -> noise kernel on; a hardware point with no
discoverable mapping for some layer is an *unknown-constraint* violation.

The search is configured by one typed, serializable `CodesignConfig`
(`repro_torch.core.config`) and driven by a `CodesignEngine`, which owns the
(hw, layer) -> best-mapping cache, the inner-seed stream, and a pluggable
*probe-evaluation strategy* (`PROBE_STRATEGIES`):

  "sequential"     L per-layer `optimize_software` searches per hardware probe
  "layer_batched"  one lockstep `bo_maximize_many` call per probe: the L
                   per-layer searches advance together, one fused device
                   program + one stacked GP fit per BO round
  "probe_fanout"   layer_batched per probe, PLUS the outer loop's H warmup
                   probes -- independent work items -- fanned out as ONE
                   H*L-run stacked `bo_maximize_many` (each run seeded exactly
                   as its probe's sequential search would be, so results are
                   identical; on the torch backend every BO round is a single
                   (H*L*B,)-row device program, one launch of kernel K1)
  "speculative"    probe_fanout, PLUS speculative fan-out of the scored outer
                   trials: each trial's top-`hw.spec_k` acquisition candidates
                   are evaluated as ONE k*L-run stacked `bo_maximize_many`
                   (the argmax feeds the outer history exactly as the
                   sequential path would; the k-1 speculative results prefill
                   the (hw, layer) cache so later trials that select them are
                   free -- hit-rate reported in `CoDesignResult.stats`)
  "auto"           layer_batched when the backend is "torch", else sequential

Probe seeds are *content-derived* (`CodesignEngine.probe_seed`: a stable hash
of the run seed and the probe's fields), so a probe's inner search is the same
no matter when -- or how speculatively -- it is evaluated; that is what makes
every strategy above bit-identical to "sequential" (within the stacked GP's
Cholesky regime, see tests/test_speculative.py).

Where the stacked inner searches run is the engine's executor
(`repro_torch.parallel`: inline, or a pool of spawn-started workers).
`codesign(**legacy_kwargs)` remains as a thin deprecation shim.
"""

from __future__ import annotations

import dataclasses
import hashlib
import warnings
from typing import Callable, Sequence

import numpy as np

from repro_torch import trace
from repro_torch.core.bo import (BOLoop, BOResult, FanoutSearchSpec,
                                 InfeasibleSpace, _resolve_search_config,
                                 bo_maximize, bo_maximize_many, score_topk)
from repro_torch.core.cache import LRUCache, counters_snapshot
from repro_torch.core.config import (CodesignConfig, EngineConfig,
                                     SWSearchConfig, config_from_legacy_kwargs)
from repro_torch.core.hwspace import HardwareSpace
from repro_torch.core.swspace import SoftwareSpace, fanout_spaces
from repro_torch.device import resolve_device
from repro_torch.timeloop.arch import HardwareConfig, hw_from_tuple
from repro_torch.timeloop.mapping import Mapping
from repro_torch.timeloop.model import evaluate
from repro_torch.timeloop.workloads import ConvLayer


@dataclasses.dataclass
class CoDesignResult:
    best_hw: HardwareConfig
    best_mappings: dict[str, Mapping]
    best_model_edp: float            # sum over layers, pJ*cycles
    hw_result: BOResult
    layer_edps: dict[str, float]
    # Engine accounting for the run: speculative probes evaluated / consumed
    # as cache hits and the resulting hit rate (all zero for non-speculative
    # strategies), plus the bound-and-prune pass's candidates considered /
    # pruned and the resulting pruned fraction, and the scored probes whose
    # whole inner search was vetoed by the bound gate (`probes_gated`; all
    # zero with prune="off").
    stats: dict | None = None


_SEARCH_FIELDS = {f.name for f in dataclasses.fields(SWSearchConfig)}
_ENGINE_FIELDS = {f.name for f in dataclasses.fields(EngineConfig)}


def _split_config(config, engine, overrides):
    """Normalize (search config, engine config, keyword overrides) into
    one validated pair.  Overrides are the configs' own field names -- search
    fields (n_trials, pool_size, ...) land on the search config, engine fields
    (backend, device, batched, gp_refit_every, ...) on the engine config;
    anything else raises TypeError."""
    search_kw = {k: overrides.pop(k) for k in list(overrides)
                 if k in _SEARCH_FIELDS}
    engine_kw = {k: overrides.pop(k) for k in list(overrides)
                 if k in _ENGINE_FIELDS}
    if overrides:
        raise TypeError(f"unexpected keyword argument(s) {sorted(overrides)}; "
                        f"valid: {sorted(_SEARCH_FIELDS | _ENGINE_FIELDS)}")
    cfg = _resolve_search_config(config, search_kw)  # shared type-check site
    if engine is not None and not isinstance(engine, EngineConfig):
        raise TypeError(f"engine must be an EngineConfig, got {engine!r}")
    eng = engine if engine is not None else EngineConfig()
    if engine_kw:
        eng = dataclasses.replace(eng, **engine_kw)
    return cfg, eng


def _software_space(hw: HardwareConfig, layer: ConvLayer,
                    eng: EngineConfig) -> SoftwareSpace:
    return SoftwareSpace(hw, layer, batched=eng.batched, backend=eng.backend,
                         device=eng.device)


def optimize_software(
    hw: HardwareConfig,
    layer: ConvLayer,
    config: SWSearchConfig | None = None,
    *,
    seed: int = 0,
    engine: EngineConfig | None = None,
    **overrides,
) -> BOResult:
    """One per-layer software-mapping search (paper §4.3).  Configured by a
    `SWSearchConfig` + `EngineConfig`; individual fields may be overridden by
    keyword (`optimize_software(hw, layer, n_trials=60, device="cpu")`)."""
    cfg, eng = _split_config(config, engine, overrides)
    space = _software_space(hw, layer, eng)
    try:
        return bo_maximize(
            space, cfg,
            noisy=False,  # deterministic evaluator (paper §4.3)
            seed=seed,
            gp_refit_every=eng.gp_refit_every,
            device=eng.device,
        )
    except InfeasibleSpace:
        # No feasible mapping could even be sampled -> report an empty result;
        # the hardware level treats this as an unknown-constraint violation.
        return BOResult(None, -np.inf, [], [], [])


def optimize_software_many(
    hw: HardwareConfig,
    layers: Sequence[ConvLayer],
    config: SWSearchConfig | None = None,
    *,
    seed: int = 0,
    engine: EngineConfig | None = None,
    **overrides,
) -> list[BOResult]:
    """Layer-batched twin of `optimize_software`: the L per-layer searches of
    one hardware probe advance in lockstep through `bo_maximize_many` (each
    seeded exactly as the sequential per-layer calls would be), one fused
    evaluation program + one stacked surrogate fit per BO round.  A layer with
    no sampleable mapping yields an empty `BOResult` (best_point None), same
    as `optimize_software`'s InfeasibleSpace handling."""
    cfg, eng = _split_config(config, engine, overrides)
    spaces = [_software_space(hw, layer, eng) for layer in layers]
    return bo_maximize_many(
        spaces, cfg,
        noisy=False,  # deterministic evaluator (paper §4.3)
        seed=seed,
        gp_refit_every=eng.gp_refit_every,
        device=eng.device,
    )


def optimize_software_fanout(
    items: Sequence[tuple[HardwareConfig, ConvLayer]],
    config: SWSearchConfig | None = None,
    *,
    seeds: Sequence[int],
    engine: EngineConfig | None = None,
    pad_to: int | None = None,
) -> list[BOResult]:
    """Probe-fanout twin of `optimize_software_many`: one stacked multi-run
    search over (hardware, layer) pairs that may span *different* hardware
    probes, each run seeded individually (`seeds[i]`, exactly as the
    sequential per-probe calls would be).  On the torch backend every BO
    round of all H*L runs is a single (H*L*B,)-row device program -- the
    hardware vector rides per row, like the layer vector.

    `pad_to` pads the stack to a fixed run count with copies of run 0 on the
    torch backend (see `swspace.fanout_spaces`): the speculative outer loop's
    per-trial item count varies as cached probes drop out.  Only the first
    `len(items)` results are returned."""
    if len(items) != len(seeds):
        raise ValueError(f"{len(seeds)} seeds for {len(items)} items")
    cfg, eng = _split_config(config, engine, {})
    spaces = fanout_spaces(items, batched=eng.batched, backend=eng.backend,
                           device=eng.device, pad_to=pad_to)
    seeds = list(seeds)
    if len(spaces) > len(items):  # padded runs replay run 0's search
        seeds += [seeds[0]] * (len(spaces) - len(items))
    return bo_maximize_many(
        spaces, cfg,
        noisy=False,
        seed=seeds,
        gp_refit_every=eng.gp_refit_every,
        device=eng.device,
    )[:len(items)]


# --- probe-evaluation strategies -------------------------------------------------


def _cache_entry(hw: HardwareConfig, layer: ConvLayer,
                 r: BOResult) -> tuple[Mapping | None, float]:
    if r.best_point is None:
        return (None, float("inf"))
    return (r.best_point, evaluate(hw, r.best_point, layer).edp)


class ProbeStrategy:
    """How a `CodesignEngine` evaluates one hardware probe's inner searches.

    `evaluate_probe` must fill `engine.cache` for the probe's layers (honoring
    `use_cache`); `prefetch` optionally batches the inner searches of a whole
    warmup pool ahead of the per-probe calls (the probe-fanout capability).
    Register implementations in `PROBE_STRATEGIES`."""

    name = "base"

    def evaluate_probe(self, engine: "CodesignEngine", hw: HardwareConfig,
                       seed: int) -> None:
        raise NotImplementedError

    def prefetch(self, engine: "CodesignEngine",
                 pool: Sequence[HardwareConfig]) -> None:
        """Called once with the outer warmup pool before its probes are
        evaluated; default: nothing (probes evaluate one at a time)."""

    def prefetch_topk(self, engine: "CodesignEngine",
                      cands: Sequence[HardwareConfig]) -> None:
        """Called per scored outer trial with the acquisition pool's top-k
        candidates, best first (entry 0 is the argmax the trial consumes);
        default: nothing (the speculative strategy overrides this)."""


class SequentialProbes(ProbeStrategy):
    """L sequential per-layer `optimize_software` searches per probe, stopping
    at the first layer with no feasible mapping (the pre-engine behavior)."""

    name = "sequential"

    def evaluate_probe(self, engine, hw, seed):
        cfg = engine.config
        for layer in engine._layers:
            key = (hw, layer)
            if not cfg.engine.use_cache or key not in engine.cache:
                r = optimize_software(hw, layer, cfg.sw, seed=seed,
                                      engine=cfg.engine)
                engine.cache[key] = _cache_entry(hw, layer, r)
            if engine.cache[key][0] is None:
                break  # unknown constraint: remaining layers never searched


class LayerBatchedProbes(ProbeStrategy):
    """One lockstep `bo_maximize_many` call per probe: every layer this probe
    still needs advances in one multi-run search (each layer seeded exactly as
    its sequential `optimize_software` call would be, so cached entries are
    interchangeable between strategies)."""

    name = "layer_batched"

    def evaluate_probe(self, engine, hw, seed):
        cfg = engine.config
        todo = list(dict.fromkeys(
            layer for layer in engine._layers
            if not cfg.engine.use_cache or (hw, layer) not in engine.cache))
        if not todo:
            return
        rs = optimize_software_many(hw, todo, cfg.sw, seed=seed,
                                    engine=cfg.engine)
        for layer, r in zip(todo, rs):
            engine.cache[(hw, layer)] = _cache_entry(hw, layer, r)


class ProbeFanoutProbes(LayerBatchedProbes):
    """Layer-batched per-probe evaluation PLUS warmup fan-out: the outer
    loop's H warmup probes are independent, so their H*L inner searches run as
    ONE stacked `bo_maximize_many` (content-derived per-run seeds --
    `CodesignEngine.probe_seed` -- make each run exactly the search eval_hw
    would launch for its probe; duplicate probes are searched once, exactly as
    the cache would serve them sequentially).  Requires `use_cache=True`
    (validated at `EngineConfig` construction)."""

    name = "probe_fanout"

    def prefetch(self, engine, pool):
        items, seeds, _ = engine.pending_items(pool)
        if not items:
            return
        for (hw, layer), entry in zip(items, engine.fanout(items, seeds)):
            engine.cache[(hw, layer)] = entry


class SpeculativeProbes(ProbeFanoutProbes):
    """Warmup fan-out (inherited) PLUS speculative scored trials: the outer BO
    loop hands `prefetch_topk` each trial pool's top-`hw.spec_k` acquisition
    candidates (best first), and ALL their pending (hw, layer) searches run as
    ONE stacked k*L-run `bo_maximize_many`.  Entry 0 is the argmax the trial
    itself consumes -- its searches are the trial's own work, just fanned;
    entries 1..k-1 are speculation whose results prefill the cache for
    whichever later trial selects them (hit-rate in `CodesignEngine.stats`).

    Because probe seeds are content-derived, a speculative fill is
    bit-identical to the search the sequential path would run whenever it
    first evaluates that probe, so speculation can never change what the
    outer loop finds -- only when the inner-search work happens (parity
    pinned in tests/test_speculative.py).  Requires `use_cache=True`
    (validated at `EngineConfig` construction)."""

    name = "speculative"

    def prefetch_topk(self, engine, cands):
        items, seeds, speculated = engine.pending_items(
            cands, mark_speculated=True)
        if not items:
            return
        n_layers = len(dict.fromkeys(engine._layers))
        entries = engine.fanout(
            items, seeds,
            # Bucketed fan-out width on torch: pad the stack to a whole
            # number of probes so the per-round device program takes at most
            # spec_k distinct run counts as cached probes drop out of later
            # trials' top-k, while padding (real redundant runs) stays under
            # one probe's worth -- the same stacks the reference searches.
            pad_to=-(-len(items) // n_layers) * n_layers)
        for (hw, layer), entry in zip(items, entries):
            engine.cache[(hw, layer)] = entry
        engine.stats["spec_evaluated"] += len(speculated)
        engine._speculated.update(speculated)

    def evaluate_probe(self, engine, hw, seed):
        if hw in engine._speculated:
            # First consumption of a speculative fill: the probe the outer
            # loop selected was evaluated ahead of time -> whole inner search
            # skipped (all its layers are cache hits below).
            engine._speculated.discard(hw)
            engine.stats["spec_hits"] += 1
        super().evaluate_probe(engine, hw, seed)


PROBE_STRATEGIES: dict[str, type[ProbeStrategy]] = {
    cls.name: cls
    for cls in (SequentialProbes, LayerBatchedProbes, ProbeFanoutProbes,
                SpeculativeProbes)
}


# --- the engine ------------------------------------------------------------------


class CodesignEngine:
    """Runs the nested co-design search for one `CodesignConfig`.

    Owns the pieces the old kwarg pipeline threaded implicitly:

      * the (hw, layer) -> (best mapping | None, EDP) cache.  The outer BO
        routinely re-probes hardware points (acquisition argmax over a sampled
        pool repeats configs, and pool candidates collide across trials); both
        keys are frozen dataclasses, so a hit skips the whole inner search.
        The inner search is stochastic, so caching also makes repeated probes
        of one hardware point consistent.  The cache is shared by all probe
        strategies (same keys, same values) and persists across `run` calls.
      * the probe-seed derivation: a probe's inner searches are seeded by
        `probe_seed(hw)` -- a stable content hash of (config.seed, the
        probe's fields) -- so the seed does not depend on WHEN the probe is
        evaluated.  That makes evaluation order a free variable: warmup
        fan-out, speculative prefetch, and the plain sequential walk all run
        the exact same search for any given probe.
      * the probe-evaluation strategy, resolved from
        `config.engine.strategy` against `PROBE_STRATEGIES`, and the
        speculative accounting (`stats`: probes evaluated speculatively,
        speculative cache hits; reset per `run`).
    """

    def __init__(self, config: CodesignConfig | None = None,
                 executor=None):
        self.config = config if config is not None else CodesignConfig()
        self.device = resolve_device(self.config.engine.device)
        self.backend = self.config.engine.backend
        self.strategy_name = self.config.engine.resolve_strategy()
        self.strategy = PROBE_STRATEGIES[self.strategy_name]()
        # LRU-bounded when `engine.cache_entries` > 0 (the service applies its
        # bound here); 0 keeps the historical unbounded dict behavior.
        self.cache: LRUCache = LRUCache(self.config.engine.cache_entries)
        self._layers: list[ConvLayer] = []
        self.stats: dict[str, int] = {"spec_evaluated": 0, "spec_hits": 0}
        self._speculated: set[HardwareConfig] = set()
        self._gate: Callable | None = None
        # Executor injection (the service shares one pool across slots); when
        # None, one is built lazily from `config.engine.executor` on the
        # first fan-out and owned (closed) by this engine.
        self._executor = executor
        self._owns_executor = False

    @property
    def executor(self):
        if self._executor is None:
            from repro_torch.parallel.executor import make_executor

            self._executor = make_executor(self.config.engine.executor)
            self._owns_executor = True
        return self._executor

    def fanout(self, items, seeds, pad_to: int | None = None) -> list:
        """Run one stacked multi-item inner search through the executor and
        return its `(mapping | None, EDP)` cache entries in item order.
        Placement (inline / worker pool / chunking) is invisible here:
        content-derived seeds make the entries identical everywhere."""
        spec = FanoutSearchSpec(items=tuple(items), seeds=tuple(seeds),
                                sw=self.config.sw, engine=self.config.engine,
                                pad_to=pad_to)
        return self.executor.run(spec)

    def close(self) -> None:
        """Shut down an executor this engine created (no-op for injected
        executors and the never-used lazy default)."""
        if self._owns_executor and self._executor is not None:
            self._executor.close()
            self._executor = None
            self._owns_executor = False

    def probe_seed(self, hw: HardwareConfig) -> int:
        """Content-derived inner-search seed for one hardware probe: a stable
        (process- and platform-independent) hash of the run seed and the
        probe's field values.  Every strategy seeds a probe's inner searches
        through this, which is what lets speculative/fanned-out evaluation
        reproduce the sequential path bit-for-bit."""
        data = repr((self.config.seed, dataclasses.astuple(hw))).encode()
        return int.from_bytes(
            hashlib.blake2s(data, digest_size=8).digest(), "big")

    def _make_prune_fn(self, best: dict):
        """Bound-and-prune closure for `HardwareSpace.prune_fn` (the
        semi-decoupled pass, `timeloop.bounds`): drop pool candidates whose
        summed per-layer EDP lower bound exceeds the incumbent's true model
        EDP times `prune_margin`.  RNG-free, so the sample stream is
        untouched.

        Engaged only under `prune="aggressive"`: pool-level removal redirects
        every doomed selection into a *different* full inner search, which is
        wall-clock neutral at a fixed trial budget -- and it starves the
        bound gate (`_make_probe_gate`), whose censored cheap trials are
        where the measured "safe" speedup comes from.  Returns None
        otherwise."""
        cfg = self.config
        if cfg.hw.prune != "aggressive":
            return None
        margin = cfg.hw.prune_margin
        layt = None          # (layb, caps) packed lazily: run() owns _layers
        memo = [None, None]  # one-slot (pool identity, summed bounds) memo

        def bound_sums(pool) -> np.ndarray:
            nonlocal layt
            if memo[0] is pool:
                return memo[1]
            if self.backend == "torch":
                from repro_torch.timeloop.batch_torch import (
                    edp_lower_bounds_device)
                lbs = edp_lower_bounds_device(pool, self._layers,
                                              device=self.device)
            else:
                from repro_torch.timeloop.batch import edp_lower_bounds_batch
                from repro_torch.timeloop.bounds import (
                    hw_bound_vecs, layer_caps, layer_bound_vecs)
                if layt is None:
                    layt = (layer_bound_vecs(self._layers),
                            layer_caps(self._layers))
                lbs = edp_lower_bounds_batch(hw_bound_vecs(pool), *layt)
            memo[0], memo[1] = pool, lbs.sum(axis=1)
            return memo[1]

        def prune(pool):
            incumbent = best["edp"]
            if not pool or not np.isfinite(incumbent):
                return pool  # warmup: no incumbent yet, nothing to bound
            sums = bound_sums(pool)
            keep = sums <= incumbent * margin
            self.stats["prune_considered"] += len(pool)
            if keep.all():
                return pool
            if not keep.any():
                # Guard: never empty the pool -- keep the candidate with the
                # best (lowest) bound so the BO trial always has a point.
                keep[int(np.argmin(sums))] = True
            self.stats["prune_pruned"] += int(len(pool) - keep.sum())
            return [hw for hw, k in zip(pool, keep) if k]

        return prune

    def _make_probe_gate(self, best: dict):
        """Bound gate for scored probe evaluations: when the selected probe's
        summed per-layer lower bound already exceeds the incumbent's true
        model EDP (times `prune_margin` under "aggressive"), its whole inner
        mapping search is provably wasted -- the probe cannot win -- so the
        gate skips it and hands the outer loop a *censored* utility instead:
        `-log10(max(bound, incumbent))`, an upper bound on the probe's true
        utility that is clamped to never displace the incumbent as
        `best_value`.  The incumbent itself is only ever updated by true
        evaluations, so gating cannot corrupt the final answer -- it only
        swaps a doomed search for a certificate of doom.

        The savings come from acquisition mistakes: trials whose selected
        candidate an uninformed or stale posterior ranked on top even though
        the bound already rules it out (frozen refit windows consume a pool
        ranked against a posterior that is stale by up to `gp_refit_every`
        trials).  Each such trial collapses from a full k*L-trial inner
        search to one vectorized bound lookup, and the censored observation
        teaches the surrogate the region is dominated without searching it.
        Returns None when `hw.prune == "off"`."""
        cfg = self.config
        if cfg.hw.prune == "off":
            return None
        from repro_torch.timeloop.bounds import lower_bound

        margin = 1.0 if cfg.hw.prune == "safe" else cfg.hw.prune_margin

        def gate(hw: HardwareConfig, count: bool = True) -> float | None:
            incumbent = best["edp"]
            if not np.isfinite(incumbent):
                return None  # warmup: no incumbent to bound against
            if all((hw, layer) in self.cache for layer in self._layers):
                return None  # search already paid for: use the true value
            s = sum(lower_bound(hw, layer) for layer in self._layers)
            if s <= incumbent * margin:
                return None
            if count:
                self.stats["probes_gated"] += 1
            return -float(np.log10(max(s, incumbent)))

        return gate

    def probe_doomed(self, hw: HardwareConfig) -> bool:
        """True when the bound gate would veto this probe's inner search --
        fan-out strategies use it to keep provably-wasted searches out of
        their stacked programs (the gate itself censors the probe if the
        outer loop ever consumes it)."""
        return self._gate is not None and self._gate(hw, count=False) is not None

    def pending_items(self, cands: Sequence[HardwareConfig], *,
                      mark_speculated: bool = False):
        """(hw, layer) work items still uncached for `cands` (deduplicated,
        pool order) with their content-derived seeds; `mark_speculated`
        additionally reports which non-argmax probes contributed items (the
        speculative-consumption accounting -- entry 0 of `cands` is the work
        its trial consumes itself).

        This is THE unit of schedulable inner-search work: the fan-out
        strategies stack a single trial's items into one multi-run program,
        and a co-design service (the reference's `repro.service`) stacks the
        items of many
        concurrent sessions' trials the same way -- content-derived seeds
        make both result-preserving."""
        items: list[tuple[HardwareConfig, ConvLayer]] = []
        seeds: list[int] = []
        speculated: list[HardwareConfig] = []
        seen: set[HardwareConfig] = set()
        for rank, hw in enumerate(cands):
            if hw in seen:
                continue  # later duplicate -> cache hit at evaluation time
            seen.add(hw)
            if self.probe_doomed(hw):
                continue  # bound veto: the gate censors it if ever consumed
            todo = [(hw, layer) for layer in dict.fromkeys(self._layers)
                    if (hw, layer) not in self.cache]
            if not todo:
                continue
            if mark_speculated and rank > 0:
                speculated.append(hw)
            items.extend(todo)
            seeds.extend([self.probe_seed(hw)] * len(todo))
        return items, seeds, speculated

    def session(self, layers: Sequence[ConvLayer],
                hw_callback: Callable[[int, "BOResult"], None] | None = None,
                *, prior: Sequence[dict] | None = None,
                trial_log: Callable[[dict], None] | None = None,
                ) -> "SearchSession":
        """Open a resumable `SearchSession` over `layers` (one at a time per
        engine: the session wires the engine's gate/stats/layer bookkeeping
        to itself).  `prior` seeds the outer GP with recorded trial-history
        rows and `trial_log` receives this session's finished outer trials
        (cross-run transfer; the reference records them with
        `repro.service.store.TrialHistory`)."""
        return SearchSession(self, layers, hw_callback=hw_callback,
                             prior=prior, trial_log=trial_log)

    def run(self, layers: Sequence[ConvLayer],
            hw_callback: Callable[[int, "BOResult"], None] | None = None,
            ) -> CoDesignResult:
        """Run the nested search over `layers` to completion -- a
        `SearchSession` stepped straight through (`session()` exposes the
        stepwise form).  `hw_callback(t, bo_result)`, when given, fires after
        every outer hardware trial (the `BOLoop` callback) -- the prune
        benchmark uses it to timestamp the incumbent trajectory
        (time-to-quality measurements)."""
        session = self.session(layers, hw_callback=hw_callback)
        while session.step():
            pass
        return session.result()


class SearchSession:
    """One nested co-design search as an explicit, resumable state machine.

    Wraps the outer hardware `BOLoop` plus everything `CodesignEngine.run`
    used to hold in closures: the incumbent (`best`), the bound gate, the
    probe-strategy hooks, and the per-run stats.  The outer-trial state --
    GP history, frozen pool window, elite carry-forward, prune gate -- is
    stepped one trial at a time (`step`), snapshotted (`snapshot`/`restore`),
    and interleaved with other sessions by the co-design service.

    The scheduling surface is `pending()`: the (hw, layer) inner-search work
    items the *next* `step()` will need, with their content-derived seeds.
    An external scheduler may search them by any means (fused across many
    sessions, served from a persistent store) and pre-fill `engine.cache`;
    because seeds are content-derived, the session's trajectory is
    bit-identical whether the work was pre-filled or evaluated inline.

    One live session per engine: constructing a session rebinds the engine's
    `_layers`/`stats`/`_gate`/`_speculated` bookkeeping (the same reset
    `run()` historically performed per call).  The (hw, layer) cache is NOT
    reset -- it persists across sessions by design.
    """

    def __init__(self, engine: CodesignEngine, layers: Sequence[ConvLayer],
                 hw_callback: Callable[[int, "BOResult"], None] | None = None,
                 *, prior: Sequence[dict] | None = None,
                 trial_log: Callable[[dict], None] | None = None):
        self.engine = engine
        cfg = engine.config
        self._trial_log = trial_log
        engine._layers = list(layers)
        engine.stats = {"spec_evaluated": 0, "spec_hits": 0,
                        "prune_considered": 0, "prune_pruned": 0,
                        "probes_gated": 0}
        engine._speculated = set()
        self.best: dict = {"edp": np.inf, "hw": None, "maps": None,
                           "per_layer": None}
        self.gate = engine._gate = engine._make_probe_gate(self.best)
        self._spec_k = (cfg.hw.spec_k
                        if engine.strategy_name == "speculative" else 0)
        self.space = HardwareSpace(
            num_pes=cfg.hw.num_pes,
            evaluate_fn=self._eval_hw,
            prefetch_fn=lambda pool: engine.strategy.prefetch(engine, pool),
            prefetch_topk_fn=(
                (lambda cands: engine.strategy.prefetch_topk(engine, cands))
                if self._spec_k > 1 else None),
            prefetch_topk=self._spec_k,
            prune_fn=engine._make_prune_fn(self.best),
        )
        # Cross-run transfer: an EDP-lower-bound prior mean (opt-in) and the
        # replayed trial history, both feeding the outer loop's surrogate
        # before its first warmup probe.  With no prior and the bound mean
        # off, every argument below matches the historical construction
        # exactly (warm_start with an empty history is bit-identical to
        # cold).
        mean_fn = (self._make_bound_mean_fn()
                   if cfg.hw.warm_start_bound_mean else None)
        self.n_prior = len(prior) if prior else 0
        self.loop = BOLoop(
            self.space, cfg.hw,
            noisy=True,  # inner search stochasticity (paper §4.2)
            seed=cfg.seed,
            gp_refit_every=cfg.engine.hw_gp_refit_every,
            gp_rank1=cfg.engine.gp_rank1_updates,
            callback=hw_callback,
            prior=self._prior_from_rows(prior, mean_fn) if prior else None,
            prior_mean_fn=mean_fn,
            device=cfg.engine.device,
        )
        self._cache_counts0 = (engine.cache.hits, engine.cache.misses,
                               engine.cache.evictions)
        self._feat_counts0 = counters_snapshot()

    def _make_bound_mean_fn(self):
        """Prior-mean closure for the outer GP (`hw.warm_start_bound_mean`):
        m(hw) = -log10(sum of per-layer EDP lower bounds), the
        ordering-accurate utility upper bound of `timeloop.bounds`, computed
        through the same batched bound paths as `_make_prune_fn` (identity
        memo included: the frozen-window pool re-presents across trials)."""
        engine = self.engine
        layt = None          # (layb, caps) packed lazily, as in _make_prune_fn
        memo = [None, None]  # one-slot (pool identity, m values) memo

        def mean_fn(pool) -> np.ndarray:
            nonlocal layt
            if memo[0] is pool:
                return memo[1]
            if engine.backend == "torch":
                from repro_torch.timeloop.batch_torch import (
                    edp_lower_bounds_device)
                lbs = edp_lower_bounds_device(pool, engine._layers,
                                              device=engine.device)
            else:
                from repro_torch.timeloop.batch import edp_lower_bounds_batch
                from repro_torch.timeloop.bounds import (
                    hw_bound_vecs, layer_caps, layer_bound_vecs)
                if layt is None:
                    layt = (layer_bound_vecs(engine._layers),
                            layer_caps(engine._layers))
                lbs = edp_lower_bounds_batch(hw_bound_vecs(pool), *layt)
            memo[0] = pool
            memo[1] = -np.log10(np.asarray(lbs, dtype=np.float64).sum(axis=1))
            return memo[1]

        return mean_fn

    def _prior_from_rows(self, rows: Sequence[dict], mean_fn) -> dict:
        """Convert trial-history rows (`TrialHistory.load`) into the
        `BOLoop` prior dict: every row enters the classifier data, feasible
        rows additionally enter the objective GP's (and, when the bound mean
        is on, their m values are recomputed from the recorded hardware
        through the same `mean_fn` live trials use)."""
        X_feas: list[np.ndarray] = []
        y_feas: list[float] = []
        hw_feas: list[HardwareConfig] = []
        X_all: list[np.ndarray] = []
        feas_all: list[bool] = []
        for row in rows:
            feats = np.asarray(row["features"], dtype=np.float64)
            feasible = bool(row["feasible"])
            X_all.append(feats)
            feas_all.append(feasible)
            if feasible:
                if row["utility"] is None:
                    raise ValueError(
                        "feasible trial-history row carries no utility "
                        f"(corrupt or hand-edited log): {row!r}")
                X_feas.append(feats)
                y_feas.append(float(row["utility"]))
                if mean_fn is not None:
                    hw_feas.append(hw_from_tuple(row["hw"]))
        prior = {"X_feas": X_feas, "y_feas": y_feas,
                 "X_all": X_all, "feas_all": feas_all}
        if mean_fn is not None:
            prior["m_feas"] = ([float(v) for v in np.asarray(mean_fn(hw_feas))]
                               if hw_feas else [])
        return prior

    def _log_trial(self, hw: HardwareConfig, utility: float | None,
                   feasible: bool) -> None:
        """Record one finished TRUE outer evaluation into the trial log
        (bound-gate-censored probes never reach here: their utilities are
        bound certificates, not measurements)."""
        if self._trial_log is None:
            return
        self._trial_log({
            "hw": list(dataclasses.astuple(hw)),
            "features": [float(v) for v in self.space.features(hw)],
            "utility": None if utility is None else float(utility),
            "feasible": bool(feasible),
        })

    def _eval_hw(self, hw: HardwareConfig):
        with trace.span("probe"):
            engine, best, cfg = self.engine, self.best, self.engine.config
            if self.gate is not None:
                censored = self.gate(hw)
                if censored is not None:
                    return censored, True  # bound veto: no inner search run
            engine.strategy.evaluate_probe(engine, hw, engine.probe_seed(hw))
            total_edp = 0.0
            maps: dict[str, Mapping] = {}
            per_layer: dict[str, float] = {}
            for layer in engine._layers:
                m, edp = engine.cache.get((hw, layer), (None, float("inf")))
                if m is None:
                    self._log_trial(hw, None, False)
                    # unknown constraint: no feasible mapping
                    return None, False
                total_edp += edp
                maps[layer.name] = m
                per_layer[layer.name] = edp
            if total_edp < best["edp"]:
                best.update(edp=total_edp, hw=hw, maps=maps,
                            per_layer=per_layer)
            if cfg.verbose:
                print(f"  hw {hw.pe_mesh_x}x{hw.pe_mesh_y} "
                      f"lb=({hw.lb_input},{hw.lb_weight},{hw.lb_output}) "
                      f"-> model EDP {total_edp:.3e}")
            utility = -float(np.log10(total_edp))
            self._log_trial(hw, utility, True)
            return utility, True

    @property
    def done(self) -> bool:
        return self.loop.done

    def step(self) -> bool:
        """Advance one outer stage (the warmup block, then one hardware trial
        per call); returns True while the session has more work."""
        with trace.span("search.step") as sp:
            if sp:
                sp.set(seed=self.engine.config.seed)
            return self.loop.step()

    def pending(self):
        """(items, seeds): the uncached (hw, layer) inner searches the next
        `step()` will evaluate, with their content-derived seeds.  Planning
        the outer trial to find them consumes the trial's RNG draws, but the
        plan is cached until `step()` commits it, so calling this is
        trajectory-neutral.

        Mirrors what each strategy would launch inline: the whole warmup
        pool's probes, a pre-surrogate trial's sampled probe, or a scored
        trial's acquisition argmax -- widened to the top-`hw.spec_k`
        candidates (capped by the frozen window's remaining trials, exactly
        like `_prefetch_topk`) under the speculative strategy.  Items are
        filtered through `engine.pending_items`, so cached, duplicate, and
        bound-doomed probes drop out."""
        plan = self.loop.plan()
        if plan is None:
            return [], []
        if plan["kind"] == "warmup":
            cands = list(plan["pool"])
        elif plan["kind"] == "sample":
            cands = [plan["point"]]
        else:
            k = 1
            if self._spec_k > 1:
                k_cap = plan.get("k_cap")
                k = self._spec_k if k_cap is None else min(self._spec_k, k_cap)
            idx = score_topk(trace.host(plan["utility"]), k)
            cands = [plan["pool"][int(i)] for i in idx]
        items, seeds, _ = self.engine.pending_items(cands)
        return items, seeds

    def result(self) -> CoDesignResult:
        """The session's `CoDesignResult` (final when `done`; the
        incumbent-so-far otherwise), with the engine + cache accounting for
        this session folded into `stats`."""
        engine = self.engine
        stats = dict(engine.stats)
        stats["spec_hit_rate"] = (
            stats["spec_hits"] / stats["spec_evaluated"]
            if stats["spec_evaluated"] else 0.0)
        stats["pruned_fraction"] = (
            stats["prune_pruned"] / stats["prune_considered"]
            if stats["prune_considered"] else 0.0)
        h0, m0, e0 = self._cache_counts0
        stats["cache_hits"] = engine.cache.hits - h0
        stats["cache_misses"] = engine.cache.misses - m0
        stats["cache_evictions"] = engine.cache.evictions - e0
        stats["cache_size"] = len(engine.cache)
        stats["prior_rows"] = self.n_prior
        feat = counters_snapshot()
        for key in ("hw_feat", "sw_feat", "sw_fwd"):
            for kind in ("hits", "misses"):
                name = f"{key}_{kind}"
                stats[name] = feat.get(name, 0) - self._feat_counts0.get(name, 0)
        return CoDesignResult(
            best_hw=self.best["hw"],
            best_mappings=self.best["maps"],
            best_model_edp=self.best["edp"],
            hw_result=self.loop.result,
            layer_edps=self.best["per_layer"],
            stats=stats,
        )

    def snapshot(self) -> dict:
        """Resumable session state as a plain dict: the outer loop's
        snapshot, the incumbent, the engine bookkeeping, and the (hw, layer)
        cache entries (the bound gate consults cache membership, so resuming
        without them could change when probes are censored)."""
        return {
            "loop": self.loop.snapshot(),
            "best": dict(self.best),
            "stats": dict(self.engine.stats),
            "speculated": list(self.engine._speculated),
            "cache": list(self.engine.cache.items()),
        }

    def restore(self, snap: dict) -> "SearchSession":
        """Load a `snapshot()` into this (freshly constructed, same engine
        config + layers) session.  The incumbent dict is updated in place --
        the gate/prune/eval closures hold a reference to it."""
        self.loop.restore(snap["loop"])
        self.n_prior = self.loop.n_prior
        self.best.update(snap["best"])
        self.engine.stats = dict(snap["stats"])
        self.engine._speculated = set(snap["speculated"])
        for key, value in snap["cache"]:
            self.engine.cache[key] = value
        return self


def codesign(
    layers: Sequence[ConvLayer],
    config: CodesignConfig | None = None,
    **legacy_kwargs,
) -> CoDesignResult:
    """Run the nested co-design search.

    The supported surface is `codesign(layers, config=CodesignConfig(...))`
    (or `CodesignEngine(config).run(layers)` to keep the cache across runs).
    The pre-config kwargs (`n_hw_trials=...`, `sw_pool=...`,
    `layer_batched=...`, `device=...`) still work as a thin shim -- mapped
    through `config_from_legacy_kwargs` -- but emit a DeprecationWarning."""
    if config is not None and not isinstance(config, CodesignConfig):
        # Loud break for pre-config positional callers (num_pes used to be
        # the second positional argument).
        raise TypeError(
            f"config must be a CodesignConfig, got {config!r}; legacy "
            f"options must be passed by keyword (num_pes=...)")
    if legacy_kwargs:
        if config is not None:
            raise TypeError(
                "pass either config= or legacy keyword arguments, not both")
        warnings.warn(
            "codesign(**kwargs) is deprecated: build a CodesignConfig and "
            "call codesign(layers, config=...) or "
            "CodesignEngine(config).run(layers)",
            DeprecationWarning, stacklevel=2)
        config = config_from_legacy_kwargs(**legacy_kwargs)
    engine = CodesignEngine(config)
    try:
        return engine.run(layers)
    finally:
        engine.close()
