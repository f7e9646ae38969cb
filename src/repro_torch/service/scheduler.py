"""Co-design as a service: a request-queue driver over `SearchSession`s.

Clients submit co-design requests (layers + a `CodesignConfig`, as objects or
JSON); the service admits up to `ServiceConfig.max_slots` of them as live
`SearchSession`s and advances all of them in lockstep ticks, the slot-admission
shape of `launch/serve.py`'s decode batch.  Each tick:

  1. admit queued requests into free slots (higher `priority` first, FIFO
     within a priority);
  2. collect every un-parked session's `pending()` work -- the (hw, layer)
     inner software searches its next outer trial needs, with
     content-derived seeds;
  3. resolve what it can from the persistent `DesignStore` (exact replays,
     keyed by `design_key`), deduplicate identical searches against
     everything queued or already in flight, and fuse the remainder into ONE
     cross-request stacked dispatch per fuse group (requests whose search
     config + backend agree share a group; `fuse=False` keeps one dispatch
     per request -- the ablation baseline), submitted to the service's
     executor (`repro_torch.parallel`) as a pickle-safe `FanoutSearchSpec`;
  4. collect resolved dispatches (blocking only when every live session is
     parked), prefill each owning session's cache, publish entries to the
     store, and `step()` each session whose work resolved one outer trial.

With the default inline executor every dispatch resolves in its own tick and
the schedule is exactly the historical synchronous one.  With
`ExecutorConfig(kind="process")` the ticks *overlap*: sessions whose pending
work is still in flight park while sessions with resolved results step
immediately, so one slow fuse group no longer gates every other request --
the learner process keeps all outer GP/acquisition state machines hot while
worker processes run the stacked inner searches.

Because probe seeds are content-derived and `SearchSession.pending()` is
trajectory-neutral (the outer plan is cached until `step()` commits it), a
request's result is bit-identical to running its engine standalone -- fusion
and the store move inner-search work across requests and across runs, never
change it.  Two scope notes: cross-request stacking inherits the stacked GP's
Cholesky-regime contract (see tests/test_torch_layer_batch.py), and under
`strategy="sequential"` with `hw.prune != "off"` the standalone path stops a
probe's per-layer searches at the first infeasible layer while the service
prefills all of them, which can shift WHEN the bound gate censors -- the
batched strategies (layer_batched/probe_fanout/speculative) search all layers
inline too and carry no such caveat.
"""

from __future__ import annotations

import dataclasses
import json
import time

import numpy as np

from repro_torch.core.bo import FanoutSearchSpec
from repro_torch.core.config import CodesignConfig, ServiceConfig
from repro_torch.core.nested import CodesignEngine, CoDesignResult, SearchSession
from repro_torch.parallel.executor import make_executor
from repro_torch.service.store import (DesignStore, TrialHistory, design_key,
                                 history_key)
from repro_torch.timeloop.model import evaluate
from repro_torch.timeloop.workloads import ConvLayer
from repro_torch.workloads.portfolio import (PortfolioConfig, PortfolioSession,
                                       make_portfolio_engine)
from repro_torch.workloads.zoo import resolve_workload


@dataclasses.dataclass(frozen=True)
class ServiceRequest:
    """One co-design request: the layers to co-design for and the full search
    config.  `rid=None` lets the service assign one at submission.

    `priority` (higher first) orders admission from the queue and the per-tick
    fuse-group submission to the executor; within one priority, admission
    stays FIFO.  Priorities only reorder WHEN work runs -- content-derived
    seeds keep every request's result identical either way.

    A request carries either `layers` OR a `portfolio` (a `PortfolioConfig`
    naming member workload sets + traffic weights): portfolio requests are
    served as `PortfolioSession`s over the union of their members' layers."""

    layers: tuple[ConvLayer, ...] = ()
    config: CodesignConfig = dataclasses.field(default_factory=CodesignConfig)
    rid: str | None = None
    priority: int = 0
    portfolio: PortfolioConfig | None = None

    def __post_init__(self) -> None:
        if self.portfolio is not None:
            if not isinstance(self.portfolio, PortfolioConfig):
                raise ValueError(
                    f"portfolio must be a PortfolioConfig, got "
                    f"{self.portfolio!r}")
            if self.layers:
                raise ValueError(
                    "pass either layers or portfolio, not both (a portfolio "
                    "request searches the union of its members' layers)")
            if self.config.hw.prune != "off":
                raise ValueError(
                    "portfolio requests require config.hw.prune='off' (the "
                    "EDP lower-bound gate is incompatible with the weighted "
                    "member objective)")
        elif not self.layers:
            raise ValueError("request has no layers")
        if not isinstance(self.priority, int) or isinstance(self.priority,
                                                            bool):
            raise ValueError(
                f"priority must be an int, got {self.priority!r}")
        object.__setattr__(self, "layers", tuple(self.layers))

    # --- JSON queue surface -------------------------------------------------------

    @classmethod
    def from_dict(cls, d: dict) -> "ServiceRequest":
        """`layers` is either a workload name -- a paper set ("dqn") or a zoo
        model ("llama4_maverick_400b_a17b") -- or a list of `ConvLayer` field
        dicts; `portfolio` a `PortfolioConfig` dict (replaces `layers`);
        `config` a `CodesignConfig` dict (sections may be omitted)."""
        d = dict(d)
        layers = d.pop("layers", None)
        if isinstance(layers, str):
            layers = resolve_workload(layers)  # raises listing known names
        elif layers is not None:
            layers = [ConvLayer(**ld) if isinstance(ld, dict) else ld
                      for ld in layers]
        portfolio = d.pop("portfolio", None)
        if isinstance(portfolio, dict):
            portfolio = PortfolioConfig.from_dict(portfolio)
        config = d.pop("config", None)
        if isinstance(config, dict):
            config = CodesignConfig.from_dict(config)
        elif config is None:
            config = CodesignConfig()
        rid = d.pop("rid", None)
        priority = d.pop("priority", 0)
        if d:
            raise ValueError(f"unknown request key(s) {sorted(d)}")
        return cls(layers=tuple(layers or ()), config=config, rid=rid,
                   priority=priority, portfolio=portfolio)

    def to_dict(self) -> dict:
        return {
            "rid": self.rid,
            "priority": self.priority,
            "layers": [dataclasses.asdict(layer) for layer in self.layers],
            "config": self.config.to_dict(),
            "portfolio": (self.portfolio.to_dict()
                          if self.portfolio is not None else None),
        }

    @classmethod
    def from_json(cls, s: str) -> "ServiceRequest":
        return cls.from_dict(json.loads(s))

    def to_json(self, **json_kw) -> str:
        json_kw.setdefault("sort_keys", True)
        return json.dumps(self.to_dict(), **json_kw)


@dataclasses.dataclass
class ServiceResponse:
    rid: str
    result: CoDesignResult   # stats carry store_hits/store_misses/latency_s
    latency_s: float         # admission -> completion wall clock
    ticks: int               # scheduler ticks the request was live


class _Slot:
    """One admitted request: its engine + live session and per-request
    accounting.  `waiting` holds the design keys of this session's pending
    searches that are still in flight on the executor -- a slot with a
    non-empty `waiting` set is *parked*: it neither re-gathers nor steps
    until every key resolves (the overlapped-tick mechanism)."""

    def __init__(self, request: ServiceRequest, engine: CodesignEngine,
                 session: SearchSession):
        self.request = request
        self.engine = engine
        self.session = session
        self.t0 = time.perf_counter()
        self.ticks = 0
        self.store_hits = 0
        self.store_misses = 0
        self.waiting: set[str] = set()
        # Cross-run transfer accounting: whether this request opted into
        # warm starts (hw.warm_start), how many approximate store hits
        # seeded its inner searches, and how many history rows its outer GP
        # consumed.
        self.warm_start = False
        self.warm_hits = 0
        self.prior_rows = 0


class CodesignService:
    """The request-queue driver.  `submit()` requests (objects, dicts, or JSON
    strings), then `run()` to drain the queue; per-request `ServiceResponse`s
    come back keyed by rid, each bit-identical to the standalone
    `CodesignEngine(config).run(layers)` result (see the module docstring for
    the two scope notes)."""

    def __init__(self, config: ServiceConfig | None = None,
                 store: DesignStore | None = None, executor=None):
        self.config = config if config is not None else ServiceConfig()
        if store is None and self.config.store_dir is not None:
            store = DesignStore(self.config.store_dir)
        self.store = store
        # Cross-run trial history (`ServiceConfig.history_dir`): every
        # non-portfolio request logs its finished outer trials here, and
        # requests with `hw.warm_start` replay the matching workload set's
        # rows into their outer GP.
        self.history = (TrialHistory(self.config.history_dir)
                        if self.config.history_dir is not None else None)
        # design_key -> (mapping, edp): approximate-store-hit warm starts
        # resolved this tick, consumed at collect time by warm_start slots
        # (the stored entry stays the PURE search result -- a store hit must
        # remain an exact replay for every other consumer).
        self._warm: dict[str, tuple] = {}
        # The executor every fused dispatch runs on: injected (shared pools
        # amortize worker start-up across services) or built from
        # `ServiceConfig.executor` and owned -- `close()` shuts an owned
        # pool down.
        self._owns_executor = executor is None
        self.executor = executor if executor is not None \
            else make_executor(self.config.executor)
        self._queue: list[ServiceRequest] = []
        self._slots: list[_Slot] = []
        self._next_rid = 0
        self._next_job = 0
        # design_key -> [(slot, item), ...] for every unresolved search, and
        # job id -> fuse group for every dispatch in flight.  Both persist
        # across ticks: with a process executor, a tick's dispatches may
        # resolve several ticks later while other sessions keep stepping.
        self._owners: dict[str, list[tuple[_Slot, tuple]]] = {}
        self._inflight: dict[int, dict] = {}
        # service-level accounting (per-request numbers land in result.stats)
        self.stats = {"ticks": 0, "fused_dispatches": 0, "fused_items": 0,
                      "deduped_items": 0}

    def close(self) -> None:
        """Shut down an owned executor pool (no-op for injected executors);
        idempotent."""
        if self._owns_executor:
            self.executor.close()

    def __enter__(self) -> "CodesignService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def submit(self, request: ServiceRequest | dict | str) -> str:
        """Enqueue a request (admitted when a slot frees up); returns its rid,
        assigning `"r<n>"` when the request carries none."""
        if isinstance(request, str):
            request = ServiceRequest.from_json(request)
        elif isinstance(request, dict):
            request = ServiceRequest.from_dict(request)
        if request.rid is None:
            request = dataclasses.replace(request, rid=f"r{self._next_rid}")
        self._next_rid += 1
        if any(r.rid == request.rid for r in self._queue) or \
                any(s.request.rid == request.rid for s in self._slots):
            raise ValueError(f"duplicate request id {request.rid!r}")
        self._queue.append(request)
        return request.rid

    def run(self) -> dict[str, ServiceResponse]:
        """Drain the queue: tick until every submitted request completed."""
        responses: dict[str, ServiceResponse] = {}
        while self._queue or self._slots:
            self._tick(responses)
        return responses

    # --- internals ----------------------------------------------------------------

    def _admit(self) -> None:
        # Higher priority admits first; the sort is stable, so submission
        # order (FIFO) breaks ties exactly as before priorities existed.
        self._queue.sort(key=lambda r: -r.priority)
        while self._queue and len(self._slots) < self.config.max_slots:
            req = self._queue.pop(0)
            cfg = req.config
            if cfg.engine.cache_entries == 0 and self.config.cache_entries:
                # service memory bound: long-lived processes must not grow the
                # (hw, layer) cache without limit unless the request insists
                cfg = dataclasses.replace(cfg, engine=dataclasses.replace(
                    cfg.engine, cache_entries=self.config.cache_entries))
            if req.portfolio is not None:
                engine = make_portfolio_engine(cfg, executor=self.executor)
                session = PortfolioSession(engine, req.portfolio)
                slot = _Slot(req, engine, session)
            else:
                engine = CodesignEngine(cfg, executor=self.executor)
                prior = trial_log = None
                if self.history is not None:
                    # Always log (cold runs feed future warm ones); only
                    # consume when the request opted in.
                    hkey = history_key(req.layers, cfg.hw, cfg.sw, cfg.engine)
                    trial_log = (lambda row, _hk=hkey:
                                 self.history.append(_hk, row))
                    if cfg.hw.warm_start:
                        prior = self.history.load(
                            hkey, max_rows=cfg.hw.warm_start_rows)
                session = engine.session(req.layers, prior=prior or None,
                                         trial_log=trial_log)
                slot = _Slot(req, engine, session)
                slot.warm_start = cfg.hw.warm_start
                slot.prior_rows = len(prior) if prior else 0
            self._slots.append(slot)

    def _transplant(self, slot: _Slot, item: tuple):
        """Approximate store hit for one (hw, layer) search: the nearest
        stored hardware point's best mapping for the same layer, re-evaluated
        through the true model ON THE TARGET hardware.  Returns an exact
        `(mapping, edp)` cache entry (or None: no neighbor, or its mapping is
        invalid here) -- never a replayed neighbor result, so everything this
        serves carries an exact EDP."""
        hw, layer = item
        near = self.store.nearest(hw, layer)
        if near is None:
            return None
        _, mapping, _ = near
        ev = evaluate(hw, mapping, layer)
        if not np.isfinite(ev.edp):
            return None  # neighbor's mapping doesn't even fit this hardware
        slot.warm_hits += 1
        return (mapping, float(ev.edp))

    def _fuse_key(self, slot: _Slot):
        """Requests may share one stacked dispatch iff every knob their inner
        searches consume agrees -- the fields `design_key` hashes, and the
        device the dispatch runs on."""
        eng = slot.engine.config.engine
        return (dataclasses.astuple(slot.engine.config.sw), eng.backend,
                eng.device, eng.batched, eng.gp_refit_every)

    def _tick(self, responses: dict[str, ServiceResponse]) -> None:
        self.stats["ticks"] += 1
        self._admit()

        # Gather each un-parked session's pending inner searches (higher
        # request priority gathers -- and therefore submits -- first);
        # resolve store hits, dedup identical searches against everything
        # queued OR already in flight (equal design_key implies equal fuse
        # key: the key hashes the same fields), fuse the rest.  Parked slots
        # are skipped: `pending()` is trajectory-neutral, so their pending
        # work is exactly the in-flight work they are waiting on.
        groups: dict[tuple, dict] = {}
        for slot in sorted(self._slots, key=lambda s: -s.request.priority):
            if slot.waiting:
                continue
            items, seeds = slot.session.pending()
            sw_cfg = slot.engine.config.sw
            eng_cfg = slot.engine.config.engine
            for item, seed in zip(items, seeds):
                key = design_key(item[0], item[1], sw_cfg, eng_cfg, seed)
                if key in self._owners:  # identical search queued/in flight
                    self._owners[key].append((slot, item))
                    slot.waiting.add(key)
                    self.stats["deduped_items"] += 1
                    continue
                if self.store is not None:
                    entry = self.store.get(key)
                    if entry is not None:
                        slot.store_hits += 1
                        slot.engine.cache[item] = entry
                        continue
                    slot.store_misses += 1
                    if slot.warm_start:
                        # Approximate hit: a close stored hardware point's
                        # mapping, re-evaluated exactly on THIS hardware,
                        # competes with the search result at collect time.
                        warm = self._transplant(slot, item)
                        if warm is not None:
                            self._warm[key] = warm
                self._owners[key] = [(slot, item)]
                slot.waiting.add(key)
                fk = (self._fuse_key(slot) if self.config.fuse
                      else ("slot", slot.request.rid))
                g = groups.setdefault(fk, {"items": [], "seeds": [],
                                           "keys": [], "slot": slot, "q": 1})
                g["items"].append(item)
                g["seeds"].append(seed)
                g["keys"].append(key)
                g["q"] = max(g["q"], len(dict.fromkeys(slot.engine._layers)))

        # One stacked multi-run dispatch per fuse group, submitted to the
        # executor (inline: runs now; process: workers pull it while the
        # learner keeps ticking).  On the torch backend every BO round of ALL
        # fused requests' searches is one stacked device forward.  Pad to a
        # whole number of probes (the speculative strategy's bucketing), the
        # same stacks a standalone run of each request searches.
        for g in groups.values():
            cfg = g["slot"].engine.config
            spec = FanoutSearchSpec(
                items=tuple(g["items"]), seeds=tuple(g["seeds"]),
                sw=cfg.sw, engine=cfg.engine,
                pad_to=-(-len(g["items"]) // g["q"]) * g["q"])
            jid = self._next_job
            self._next_job += 1
            self.executor.submit(jid, spec)
            self._inflight[jid] = g
            self.stats["fused_dispatches"] += 1
            self.stats["fused_items"] += len(g["items"])

        # Collect whatever has resolved; block only when every live session
        # is parked (nothing could step anyway).  Each resolved entry
        # prefills every owning session's cache and lands in the store.
        block = bool(self._inflight) and \
            all(s.waiting for s in self._slots)
        for jid, entries in self.executor.ready(block=block):
            g = self._inflight.pop(jid)
            for key, item, entry in zip(g["keys"], g["items"], entries):
                # A transplanted warm start competes with the search result
                # per warm-started owner (both EDPs are exact, so best-of is
                # never worse); the store always receives the PURE search
                # entry -- a store hit stays an exact replay of the search.
                warm = self._warm.pop(key, None)
                for slot, s_item in self._owners.pop(key):
                    e = entry
                    if warm is not None and slot.warm_start \
                            and warm[1] < entry[1]:
                        e = warm
                    slot.engine.cache[s_item] = e
                    slot.waiting.discard(key)
                if self.store is not None:
                    self.store.put(key, entry, hw=item[0], layer=item[1])

        # Advance every session whose results resolved one outer stage;
        # sessions with work still in flight stay parked.  Retire completed
        # requests.
        still = []
        for slot in self._slots:
            if slot.waiting:
                still.append(slot)
                continue
            slot.ticks += 1
            if slot.session.step():
                still.append(slot)
            else:
                responses[slot.request.rid] = self._finish(slot)
        self._slots = still

    def _finish(self, slot: _Slot) -> ServiceResponse:
        latency = time.perf_counter() - slot.t0
        result = slot.session.result()
        result.stats.update(store_hits=slot.store_hits,
                            store_misses=slot.store_misses,
                            warm_hits=slot.warm_hits,
                            prior_rows=slot.prior_rows,
                            latency_s=latency, ticks=slot.ticks)
        if self.store is not None and self.config.store_max_entries:
            # Disk-footprint bound for long-lived services: evict oldest
            # entries beyond the cap as each request retires.
            self.store.prune(self.config.store_max_entries)
        return ServiceResponse(rid=slot.request.rid, result=result,
                               latency_s=latency, ticks=slot.ticks)
