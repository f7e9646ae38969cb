"""Typed, serializable search configuration for the co-design stack.

The search is configured by a small set of frozen dataclasses:

  `SearchConfig`      one BO loop's budget + acquisition + surrogate
    `SWSearchConfig`    inner (software-mapping) defaults: 250 trials / 30 warmup
    `HWSearchConfig`    outer (hardware) defaults: 50 trials / 5 warmup + num_pes
  `EngineConfig`      evaluation machinery: backend, device, probe strategy,
                      GP-refit stride, batched protocol, cache
  `CodesignConfig`    the composition (+ seed, verbose) -- the single object a
                      `CodesignEngine` runs; JSON round-trips via
                      `to_dict`/`from_dict`/`to_json`/`from_json`
  `ExecutorConfig`    where stacked inner searches run (inline or a pool of
                      spawn-started worker processes)
  `ServiceConfig`     the co-design service driver (`repro_torch.service`)

Every enumerated string (backend / device / surrogate / acquisition / probe
strategy) is validated HERE, at construction, through one shared
`validate_choice` site -- a bad value raises `ValueError` before any search
starts instead of threading silently to a deep call site.

`config_from_legacy_kwargs` maps the pre-config `codesign(**kwargs)` surface
onto a `CodesignConfig` (the deprecation shim in `repro_torch.core.nested`
uses it); `LEGACY_KWARG_MAP` is the old-kwarg -> config-field table.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

from repro_torch.device import DEVICE_TYPES

# "torch": the device engine (`timeloop.batch_torch`, kernel K1 on the card);
# "numpy": the host engine (`timeloop.batch`).  The GP is torch on either.
BACKENDS = ("numpy", "torch")
SURROGATES = ("gp_linear", "gp_se", "rf")
ACQUISITIONS = ("lcb", "ei")
STRATEGIES = ("auto", "sequential", "layer_batched", "probe_fanout",
              "speculative")
PRUNE_MODES = ("off", "safe", "aggressive")
EXECUTOR_KINDS = ("inline", "process")


def validate_choice(field: str, value, choices, optional: bool = False) -> None:
    """The one ValueError site for enumerated config strings."""
    if optional and value is None:
        return
    if value not in choices:
        allowed = " | ".join(repr(c) for c in choices)
        extra = " | None" if optional else ""
        raise ValueError(f"{field} must be one of {allowed}{extra}, "
                         f"got {value!r}")


def validate_device(value) -> None:
    """A device string: "cuda", "cpu" or "cuda:N" (availability is checked
    where the device is first used, `repro_torch.device.resolve_device`)."""
    kind, _, index = str(value).partition(":") if isinstance(value, str) \
        else ("", "", "")
    if kind not in DEVICE_TYPES or (index and not index.isdigit()):
        raise ValueError(f"device must be 'cuda', 'cuda:N' or 'cpu', "
                         f"got {value!r}")


def _validate_positive_int(field: str, value, minimum: int = 1) -> None:
    if not isinstance(value, int) or isinstance(value, bool) or value < minimum:
        raise ValueError(f"{field} must be an int >= {minimum}, got {value!r}")


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """One constrained-BO loop: budget, acquisition, surrogate (paper §3).

    elite_k: candidate carry-forward width.  When > 0, each scored trial's
    acquisition pool is the fresh `pool_size` draw PLUS the previous scored
    trial's top-`elite_k` not-yet-evaluated candidates, so strong candidates
    survive pool resampling (the persistent-candidate trick of large-scale BO
    systems, cf. BoTorch/Vizier in PAPERS.md) and the acquisition argmax over
    the superset pool is a strictly better acquisition optimization.  It is
    also what gives the speculative outer loop its cache hits: a speculated
    candidate can actually be selected later instead of vanishing with its
    pool.  Applies to list-pool spaces (the hardware loop); 0 disables."""

    n_trials: int = 250
    n_warmup: int = 30
    pool_size: int = 150
    acquisition: str = "lcb"
    lam: float = 1.0
    surrogate: str = "gp_linear"
    elite_k: int = 0

    def __post_init__(self) -> None:
        validate_choice("acquisition", self.acquisition, ACQUISITIONS)
        validate_choice("surrogate", self.surrogate, SURROGATES)
        _validate_positive_int("n_trials", self.n_trials)
        _validate_positive_int("n_warmup", self.n_warmup, minimum=0)
        _validate_positive_int("pool_size", self.pool_size)
        _validate_positive_int("elite_k", self.elite_k, minimum=0)


@dataclasses.dataclass(frozen=True)
class SWSearchConfig(SearchConfig):
    """Inner per-layer software-mapping search (250 trials in the paper)."""


@dataclasses.dataclass(frozen=True)
class HWSearchConfig(SearchConfig):
    """Outer hardware search (50 trials / 5 warmup in the paper) plus the
    PE budget that parameterizes the hardware space itself.

    spec_k: fan-out width of the `strategy="speculative"` outer loop -- at each
    scored trial the top-k acquisition candidates are evaluated as one stacked
    multi-run program (the argmax feeds the BO history; the k-1 speculative
    results prefill the (hw, layer) cache).  Ignored by other strategies.

    prune: the semi-decoupled bound-and-prune pass (`timeloop.bounds`).  A
    scored probe whose summed per-layer EDP *lower bound* already exceeds the
    threshold below has its whole inner mapping search skipped (the engine's
    bound gate observes a censored, bound-derived utility instead, and the
    speculative fan-out never launches the search); the incumbent is only
    ever updated by true evaluations, so a vetoed probe provably cannot
    corrupt the final design:
      "off"         (default) no pruning
      "safe"        threshold = incumbent EDP exactly; bound <= truth, so a
                    vetoed probe provably cannot beat the incumbent
      "aggressive"  threshold = incumbent EDP * prune_margin -- margin < 1
                    also vetoes probes whose best case is within (1 - margin)
                    of the incumbent, trading completeness for speed; the
                    pool-level prune hook (`HardwareSpace.prune_fn`)
                    additionally drops bounded-out candidates before the
                    acquisition ranks them
    prune_margin: the "aggressive" threshold multiplier (> 0; ignored by
    "safe", which always uses exactly 1.0).  Pool-level removal is reserved
    for "aggressive" because redirecting a doomed selection into a different
    full search is wall-clock neutral -- the measured speedup of "safe"
    comes from censoring doomed selections, which pool removal would
    starve.

    warm_start: cross-run transfer (`repro_torch.service`).  When True, a
    service
    request consumes the workload set's recorded trial history
    (`TrialHistory`, keyed by `history_key`) as prior observations seeding
    the outer GP/classifier before the first warmup probe, and exact
    design-store misses fall back to an approximate nearest-neighbor lookup
    whose mapping seeds the inner search as a warm-start incumbent
    (re-evaluated exactly on the target hardware; `warm_hits` in stats).
    With no history and no store the search is bit-identical to
    warm_start=False -- priors only ever ADD surrogate data.
    warm_start_rows: cap on consumed prior rows (most recent first).
    warm_start_bound_mean: additionally center the outer GP on the EDP
    lower bound (`timeloop.bounds`: m(x) = -log10(sum of per-layer bounds),
    an ordering-accurate upper bound on utility); the GP fits residuals
    y - m(x) and posteriors add m back.  Off by default: it changes the
    search trajectory even without history (an opt-in prior model, not a
    pure transfer knob)."""

    n_trials: int = 50
    n_warmup: int = 5
    num_pes: int = 168
    spec_k: int = 4
    elite_k: int = 4  # carry-forward on by default for the outer loop
    prune: str = "off"
    prune_margin: float = 1.0
    warm_start: bool = False
    warm_start_rows: int = 256
    warm_start_bound_mean: bool = False

    def __post_init__(self) -> None:
        super().__post_init__()
        _validate_positive_int("num_pes", self.num_pes)
        _validate_positive_int("spec_k", self.spec_k)
        validate_choice("prune", self.prune, PRUNE_MODES)
        if not (isinstance(self.prune_margin, (int, float))
                and not isinstance(self.prune_margin, bool)
                and self.prune_margin > 0.0):
            raise ValueError(
                f"prune_margin must be a number > 0, got {self.prune_margin!r}")
        for field in ("warm_start", "warm_start_bound_mean"):
            if not isinstance(getattr(self, field), bool):
                raise ValueError(
                    f"{field} must be a bool, got {getattr(self, field)!r}")
        _validate_positive_int("warm_start_rows", self.warm_start_rows)


@dataclasses.dataclass(frozen=True)
class ExecutorConfig:
    """Where stacked inner-search dispatches run
    (`repro_torch.parallel.executor`).

    kind         "inline"   run each submitted search spec synchronously in
                            the learner process (the historical behavior --
                            zero overhead, zero processes)
                 "process"  a pool of persistent spawn-started worker
                            processes pulls whole stacked k*L-run searches
                            from a task queue and returns (mapping, EDP)
                            entries.  Each worker opens its own CUDA context
                            on the engine's device at its first search (none
                            is inherited).  Content-derived probe seeds make
                            the results identical to inline for every worker
                            count.
    n_workers    worker-pool width for kind="process"; 0 (default) resolves
                 to min(4, cpu_count).
    chunk_items  split each submitted spec into chunks of at most this many
                 (hw, layer) items so one stacked dispatch spreads across
                 idle workers; 0 (default) splits evenly across the pool
                 (ceil(n_items / n_workers)).  Chunking only regroups which
                 runs share a stacked fit -- the same composition freedom the
                 service's cross-request fusion already exercises -- so it
                 cannot change results in the pinned Cholesky regime.
    """

    kind: str = "inline"
    n_workers: int = 0
    chunk_items: int = 0

    def __post_init__(self) -> None:
        validate_choice("kind", self.kind, EXECUTOR_KINDS)
        _validate_positive_int("n_workers", self.n_workers, minimum=0)
        _validate_positive_int("chunk_items", self.chunk_items, minimum=0)

    def resolve_workers(self) -> int:
        if self.n_workers:
            return self.n_workers
        return max(1, min(4, os.cpu_count() or 1))


def _coerce_executor(obj, owner: str) -> ExecutorConfig:
    """Accept an ExecutorConfig, a JSON dict (the from_dict path), or None."""
    if obj is None:
        return ExecutorConfig()
    if isinstance(obj, ExecutorConfig):
        return obj
    if isinstance(obj, dict):
        try:
            return ExecutorConfig(**obj)
        except TypeError as e:
            raise ValueError(f"invalid {owner}.executor dict: {e}") from None
    raise ValueError(f"{owner}.executor must be an ExecutorConfig or dict, "
                     f"got {obj!r}")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Evaluation machinery, orthogonal to either loop's search budget.

    backend         "torch" (default: the device engine, kernel K1 on the
                    card) | "numpy" (the host engine; the GP stays torch)
    device          "cuda" (default) | "cpu" (or "cuda:N"): where the GP and
                    the torch engine run.  A CUDA device on a machine without
                    one raises RuntimeError naming it; nothing falls back.
    strategy        probe-evaluation strategy for the nested search:
                      "sequential"    L per-layer searches per hardware probe
                      "layer_batched" one lockstep `bo_maximize_many` per probe
                      "probe_fanout"  layer_batched + the outer warmup's H
                                      independent probes fanned out as ONE
                                      H*L-run stacked `bo_maximize_many`
                      "speculative"   probe_fanout + per scored outer trial the
                                      top-`hw.spec_k` acquisition candidates
                                      fan out as one k*L-run stacked program
                                      (argmax consumed, the rest cached)
                      "auto"          layer_batched on torch, sequential on numpy
    gp_refit_every  inner-loop surrogate refit stride (amortization)
    hw_gp_refit_every
                    OUTER-loop surrogate refit stride.  Trials inside one
                    refit window score their pools with the same posterior,
                    so with candidate carry-forward (`hw.elite_k`) the top-k
                    of a window's first trial is exactly the q-batch the
                    following trials select from -- the regime where
                    `strategy="speculative"`'s prefetch turns into cache hits
                    (cf. Vizier's parallel suggestions from one posterior).
                    1 (default) refits every trial like the paper.
    batched         expose the batched evaluation protocol to the BO loop
    use_cache       share the (hw, layer) -> best-mapping cache across probes
    gp_rank1_updates
                    amortize the OUTER surrogate between aligned refits: each
                    scored trial's feasible observation is appended to the GP
                    through an O(n^2) rank-1 Cholesky border update (frozen
                    hyperparameters) instead of waiting for the next O(n^3)
                    refit, and the posterior reuses the cached factor.  Off by
                    default: a mid-window posterior update changes frozen-
                    window trajectories (fresher, but not bit-identical to
                    the paper's refit-every-trial schedule).
    cache_entries   LRU bound on the engine's (hw, layer) -> best-mapping
                    cache (0 = unbounded, the historical behavior).  Content-
                    derived probe seeds make eviction result-preserving under
                    prune="off" (a re-search reproduces the evicted entry
                    bit-for-bit); with the bound gate on, eviction can change
                    *when* probes are censored, so bounded runs are only
                    guaranteed identical to unbounded ones while nothing is
                    evicted.  Long-lived service processes set this
                    (`ServiceConfig.cache_entries`).
    executor        where stacked inner-search dispatches run
                    (`ExecutorConfig`; dicts from the JSON surface are
                    coerced).  Purely a placement knob: it cannot enter the
                    design-store key because it cannot change results.
    """

    backend: str = "torch"
    device: str = "cuda"
    strategy: str = "auto"
    gp_refit_every: int = 1
    hw_gp_refit_every: int = 1
    batched: bool = True
    use_cache: bool = True
    gp_rank1_updates: bool = False
    cache_entries: int = 0
    executor: ExecutorConfig = dataclasses.field(
        default_factory=ExecutorConfig)

    def __post_init__(self) -> None:
        object.__setattr__(self, "executor",
                           _coerce_executor(self.executor, "EngineConfig"))
        validate_choice("backend", self.backend, BACKENDS)
        validate_device(self.device)
        validate_choice("strategy", self.strategy, STRATEGIES)
        _validate_positive_int("gp_refit_every", self.gp_refit_every)
        _validate_positive_int("hw_gp_refit_every", self.hw_gp_refit_every)
        _validate_positive_int("cache_entries", self.cache_entries, minimum=0)
        if self.strategy in ("probe_fanout", "speculative") and not self.use_cache:
            raise ValueError(
                f"strategy={self.strategy!r} requires use_cache=True: the "
                "fan-out prefills the (hw, layer) cache that probe evaluation "
                "reads")

    def resolve_strategy(self) -> str:
        """Concrete strategy name ('auto' resolved against the backend)."""
        if self.strategy != "auto":
            return self.strategy
        if self.batched and self.backend == "torch":
            return "layer_batched"
        return "sequential"


@dataclasses.dataclass(frozen=True)
class CodesignConfig:
    """The full nested-search configuration a `CodesignEngine` runs."""

    sw: SWSearchConfig = dataclasses.field(default_factory=SWSearchConfig)
    hw: HWSearchConfig = dataclasses.field(default_factory=HWSearchConfig)
    engine: EngineConfig = dataclasses.field(default_factory=EngineConfig)
    seed: int = 0
    verbose: bool = False

    def __post_init__(self) -> None:
        for field, cls in (("sw", SWSearchConfig), ("hw", HWSearchConfig),
                           ("engine", EngineConfig)):
            if not isinstance(getattr(self, field), cls):
                raise ValueError(
                    f"{field} must be a {cls.__name__}, "
                    f"got {getattr(self, field)!r}")

    # --- serialization ----------------------------------------------------------

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "CodesignConfig":
        """Inverse of `to_dict`; sections and fields may be omitted (defaults
        apply), unknown keys raise ValueError."""
        d = dict(d)
        try:
            sw = SWSearchConfig(**d.pop("sw", None) or {})
            hw = HWSearchConfig(**d.pop("hw", None) or {})
            engine = EngineConfig(**d.pop("engine", None) or {})
            return cls(sw=sw, hw=hw, engine=engine, **d)
        except TypeError as e:  # unknown field name in some section
            raise ValueError(f"invalid CodesignConfig dict: {e}") from None

    def to_json(self, **json_kw) -> str:
        json_kw.setdefault("indent", 2)
        json_kw.setdefault("sort_keys", True)
        return json.dumps(self.to_dict(), **json_kw)

    @classmethod
    def from_json(cls, s: str) -> "CodesignConfig":
        return cls.from_dict(json.loads(s))


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Co-design service driver configuration (`repro_torch.service`).

    max_slots      concurrent search sessions advanced per scheduler tick
                   (the slot-admission width; queued requests wait for a
                   free slot, like `launch/serve.py`'s decode batch)
    fuse           fuse every admitted session's pending inner searches into
                   ONE cross-request stacked `bo_maximize_many` dispatch per
                   tick (False: one dispatch per session per tick -- the
                   ablation baseline; results are identical either way)
    store_dir      persistent design-store directory (None: no store).  The
                   store is keyed by content hash of (hw, layer, search
                   config, probe seed), so hits are exact replays.
    cache_entries  LRU bound applied to each request's engine (hw, layer)
                   cache when the request's own `EngineConfig.cache_entries`
                   is 0 -- long-lived service processes must not grow
                   memory without bound.
    executor       where the scheduler's fused per-tick dispatches run
                   (`ExecutorConfig`).  kind="process" also overlaps ticks:
                   sessions whose pending work is still in flight park while
                   sessions with resolved results step immediately.
    store_max_entries  disk-footprint bound for the design store: after each
                   request retires, entries beyond this cap are evicted
                   oldest-first (`DesignStore.prune`).  0 = unbounded.
    history_dir    cross-run trial-history directory (None: no history).
                   When set, every non-portfolio request appends its finished
                   outer trials under its workload set's `history_key`, and
                   requests with `HWSearchConfig.warm_start` replay those
                   rows as outer-GP prior observations
                   (`repro_torch.service.store.TrialHistory`).
    """

    max_slots: int = 4
    fuse: bool = True
    store_dir: str | None = None
    cache_entries: int = 65536
    executor: ExecutorConfig = dataclasses.field(
        default_factory=ExecutorConfig)
    store_max_entries: int = 0
    history_dir: str | None = None

    def __post_init__(self) -> None:
        object.__setattr__(self, "executor",
                           _coerce_executor(self.executor, "ServiceConfig"))
        _validate_positive_int("max_slots", self.max_slots)
        _validate_positive_int("cache_entries", self.cache_entries, minimum=0)
        _validate_positive_int("store_max_entries", self.store_max_entries,
                               minimum=0)
        for field in ("store_dir", "history_dir"):
            value = getattr(self, field)
            if value is not None and not isinstance(value, str):
                raise ValueError(
                    f"{field} must be a str or None, got {value!r}")

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ServiceConfig":
        try:
            return cls(**d)
        except TypeError as e:
            raise ValueError(f"invalid ServiceConfig dict: {e}") from None


# --- legacy kwarg surface --------------------------------------------------------

# old codesign kwarg -> (section, config field); None section = CodesignConfig
# top level.  `device` is the port's own engine field.
LEGACY_KWARG_MAP: dict[str, tuple[str | None, str]] = {
    "num_pes": ("hw", "num_pes"),
    "n_hw_trials": ("hw", "n_trials"),
    "n_hw_warmup": ("hw", "n_warmup"),
    "hw_pool": ("hw", "pool_size"),
    "n_sw_trials": ("sw", "n_trials"),
    "n_sw_warmup": ("sw", "n_warmup"),
    "sw_pool": ("sw", "pool_size"),
    "backend": ("engine", "backend"),
    "device": ("engine", "device"),
    "batched": ("engine", "batched"),
    "use_cache": ("engine", "use_cache"),
    "gp_refit_every": ("engine", "gp_refit_every"),
    "seed": (None, "seed"),
    "verbose": (None, "verbose"),
    # acquisition / lam / surrogate applied to BOTH loops (the legacy API had
    # one knob); layer_batched maps onto engine.strategy (see below).
}
_SHARED_SEARCH_KEYS = ("acquisition", "lam", "surrogate")


def config_from_legacy_kwargs(**kw) -> CodesignConfig:
    """Map the pre-config `codesign(**kwargs)` surface to a `CodesignConfig`.

    `layer_batched` (bool | None) becomes `engine.strategy`:
    None -> "auto", True -> "layer_batched", False -> "sequential"."""
    sections: dict[str | None, dict] = {"sw": {}, "hw": {}, "engine": {},
                                        None: {}}
    if "layer_batched" in kw:
        lb = kw.pop("layer_batched")
        sections["engine"]["strategy"] = (
            "auto" if lb is None else "layer_batched" if lb else "sequential")
    for key in _SHARED_SEARCH_KEYS:
        if key in kw:
            v = kw.pop(key)
            sections["sw"][key] = v
            sections["hw"][key] = v
    for key, value in kw.items():
        if key not in LEGACY_KWARG_MAP:
            raise TypeError(
                f"codesign() got an unexpected keyword argument {key!r}; "
                f"valid legacy kwargs: "
                f"{sorted(LEGACY_KWARG_MAP) + ['layer_batched', *_SHARED_SEARCH_KEYS]}")
        section, field = LEGACY_KWARG_MAP[key]
        sections[section][field] = value
    return CodesignConfig(
        sw=SWSearchConfig(**sections["sw"]),
        hw=HWSearchConfig(**sections["hw"]),
        engine=EngineConfig(**sections["engine"]),
        **sections[None],
    )
