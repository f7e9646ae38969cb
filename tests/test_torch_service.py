"""The co-design service on the port (`repro_torch.service`), on the CPU:
request scheduling, cross-request fusion, the persistent design store,
session snapshot/resume and the legacy `codesign(**kwargs)` shim -- the
reference's tests/test_service.py, run on `repro_torch`.

The load-bearing contract is *bit-parity*: a request served by the
`CodesignService` -- its inner searches fused with other requests' into one
stacked dispatch per tick, possibly prefilled from the store -- must produce
exactly the result of running its engine standalone.  That holds because

  * probe seeds are content-derived (`CodesignEngine.probe_seed`), so an
    inner search is the same wherever/whenever it runs;
  * `SearchSession.pending()` is trajectory-neutral (the outer plan is
    cached until `step()` commits it);
  * `bo_maximize_many` stacking is composition-independent within the
    stacked GP's Cholesky regime (budgets here keep every fit inside it --
    see tests/test_torch_layer_batch.py).

The engine is the port's default, backend="torch" (kernel K1b's plain
version on the CPU), on device="cpu".  Bars: exact equality.
"""

import dataclasses
import json
import threading

import numpy as np
import pytest
import torch

from repro_torch.core import (CodesignConfig, CodesignEngine, EngineConfig,
                        HWSearchConfig, LRUCache, ServiceConfig,
                        SWSearchConfig, SearchSession, codesign,
                        config_from_legacy_kwargs)
from repro_torch.core import nested as nested_mod
from repro_torch.service import (CodesignService, DesignStore, ServiceRequest,
                           design_key)
from repro_torch.timeloop import MODEL_LAYERS


def svc_config(seed=0, strategy="sequential", n_hw=4, **eng):
    # sw n_trials=12 keeps every stacked GP fit in the Cholesky regime where
    # cross-request stacking is bit-identical to standalone searches.
    return CodesignConfig(
        sw=SWSearchConfig(n_trials=12, n_warmup=5, pool_size=15),
        hw=HWSearchConfig(n_trials=n_hw, n_warmup=2, pool_size=15, spec_k=2),
        engine=EngineConfig(strategy=strategy, device="cpu", **eng),
        seed=seed)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the GP's matrices are tiny, and test workers run
    side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MIXED_REQUESTS = [  # mixed workloads x strategies x seeds
    ("dqn", svc_config(0, "sequential")),
    ("mlp", svc_config(1, "speculative")),
    ("dqn", svc_config(2, "layer_batched")),
    ("mlp", svc_config(3, "probe_fanout")),
]


def _standalone(model, config):
    return CodesignEngine(config).run(MODEL_LAYERS[model])


def _assert_parity(got, ref, where=""):
    assert got.best_hw == ref.best_hw, where
    assert got.best_model_edp == ref.best_model_edp, where
    assert got.best_mappings == ref.best_mappings, where
    assert np.array_equal(got.hw_result.history, ref.hw_result.history), where
    assert got.hw_result.points == ref.hw_result.points, where


class _FanoutSpy:
    """Record every stacked dispatch `optimize_software_fanout` runs."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        self._orig = nested_mod.optimize_software_fanout

        def spy(items, *a, **kw):
            self.calls.append(list(items))
            return self._orig(items, *a, **kw)

        # Every executor path -- the scheduler's FanoutSearchSpec.run and
        # the engine's fanout() alike -- resolves the function through the
        # module attribute at call time, so patching here sees them all.
        nested_mod.optimize_software_fanout = spy
        return self

    def __exit__(self, *exc):
        nested_mod.optimize_software_fanout = self._orig


# --- cross-request parity ---------------------------------------------------------


@pytest.mark.parametrize("fuse", [True, False])
def test_concurrent_requests_match_standalone(fuse):
    """N mixed concurrent requests through the service == N standalone runs,
    with and without cross-request fusion (fusion only moves work)."""
    refs = [_standalone(m, c) for m, c in MIXED_REQUESTS]
    svc = CodesignService(ServiceConfig(max_slots=len(MIXED_REQUESTS),
                                        fuse=fuse))
    rids = [svc.submit(ServiceRequest(layers=tuple(MODEL_LAYERS[m]), config=c))
            for m, c in MIXED_REQUESTS]
    responses = svc.run()
    assert set(responses) == set(rids)
    for rid, ref in zip(rids, refs):
        _assert_parity(responses[rid].result, ref, where=rid)
        stats = responses[rid].result.stats
        assert stats["latency_s"] > 0 and stats["ticks"] > 0


def test_staggered_admission_matches_standalone():
    """max_slots < N: requests are admitted as slots free up (different
    n_trials retire at different ticks) -- parity must survive sessions
    joining mid-stream."""
    reqs = [("dqn", svc_config(0, n_hw=3)), ("mlp", svc_config(1, n_hw=5)),
            ("dqn", svc_config(2, n_hw=4)), ("mlp", svc_config(3, n_hw=3))]
    refs = [_standalone(m, c) for m, c in reqs]
    svc = CodesignService(ServiceConfig(max_slots=2))
    rids = [svc.submit(ServiceRequest(layers=tuple(MODEL_LAYERS[m]), config=c))
            for m, c in reqs]
    responses = svc.run()
    for rid, ref in zip(rids, refs):
        _assert_parity(responses[rid].result, ref, where=rid)


def test_identical_requests_dedup_to_one_search_stream():
    """Two identical concurrent requests need each (hw, layer) search ONCE:
    equal design keys collapse across requests, both sessions get the same
    prefilled entries, both results match standalone."""
    ref = _standalone("dqn", svc_config(7))
    svc = CodesignService(ServiceConfig(max_slots=2))
    with _FanoutSpy() as spy:
        rids = [svc.submit(ServiceRequest(layers=tuple(MODEL_LAYERS["dqn"]),
                                          config=svc_config(7)))
                for _ in range(2)]
        responses = svc.run()
    for rid in rids:
        _assert_parity(responses[rid].result, ref, where=rid)
    searched = [it for call in spy.calls for it in call]
    assert len(searched) == len(set(searched))  # nothing dispatched twice
    assert svc.stats["deduped_items"] > 0


def test_fused_dispatch_count():
    """With fusion on, every tick issues at most ONE stacked dispatch for
    requests sharing a search config (the cross-request fusion claim, counted
    at the dispatch site)."""
    svc = CodesignService(ServiceConfig(max_slots=3, fuse=True))
    with _FanoutSpy() as spy:
        for seed, model in enumerate(("dqn", "mlp", "dqn")):
            svc.submit(ServiceRequest(layers=tuple(MODEL_LAYERS[model]),
                                      config=svc_config(seed)))
        svc.run()
    assert len(spy.calls) == svc.stats["fused_dispatches"]
    assert len(spy.calls) <= svc.stats["ticks"]
    # and the fused streams really carried several requests' work: some
    # dispatch mixes more than one hardware point's items
    assert any(len({hw for hw, _ in call}) > 1 for call in spy.calls)


# --- the design store -------------------------------------------------------------


def test_store_roundtrip_feasible_and_infeasible(tmp_path):
    from repro_torch.timeloop import eyeriss_168
    from repro_torch.core.nested import optimize_software

    hw = eyeriss_168()
    layer = MODEL_LAYERS["dqn"][0]
    cfg = svc_config(0)
    r = optimize_software(hw, layer, cfg.sw, seed=3, engine=cfg.engine)
    entry = nested_mod._cache_entry(hw, layer, r)

    store = DesignStore(str(tmp_path))
    key = design_key(hw, layer, cfg.sw, cfg.engine, 3)
    assert store.get(key) is None and store.misses == 1
    store.put(key, entry)
    assert store.get(key) == entry  # exact mapping + exact float EDP
    assert store.hits == 1 and len(store) == 1

    store.put("beef" * 8, (None, float("inf")))  # infeasibility is cached too
    assert store.get("beef" * 8) == (None, float("inf"))
    assert len(store) == 2


def test_design_key_separates_what_changes_the_search():
    from repro_torch.timeloop import eyeriss_168

    hw = eyeriss_168()
    layer = MODEL_LAYERS["dqn"][0]
    cfg = svc_config(0)
    base = design_key(hw, layer, cfg.sw, cfg.engine, 3)
    assert base == design_key(hw, layer, cfg.sw, cfg.engine, 3)
    # strategy moves work around, never changes a search -> same key; the
    # device and the executor do not change it either (the card's decisions
    # equal the CPU's), so a store written on one serves the other
    for same in ({"strategy": "speculative"}, {"device": "cuda"},
                 {"executor": {"kind": "process", "n_workers": 2}}):
        assert base == design_key(
            hw, layer, cfg.sw, dataclasses.replace(cfg.engine, **same), 3)
    for other in (
        design_key(hw, layer, cfg.sw, cfg.engine, 4),
        design_key(hw, MODEL_LAYERS["dqn"][1], cfg.sw, cfg.engine, 3),
        design_key(hw, layer, dataclasses.replace(cfg.sw, n_trials=13),
                   cfg.engine, 3),
        design_key(hw, layer, cfg.sw,
                   dataclasses.replace(cfg.engine, gp_refit_every=2), 3),
        design_key(hw, layer, cfg.sw,
                   dataclasses.replace(cfg.engine, backend="numpy"), 3),
        design_key(hw, layer, cfg.sw,
                   dataclasses.replace(cfg.engine, batched=False), 3),
    ):
        assert other != base


def test_warm_store_rerun_runs_zero_inner_searches(tmp_path):
    """The store acceptance criterion: resubmitting a served workload against
    the same store performs ZERO inner mapping searches -- every (hw, layer)
    result is an exact replay from disk -- and still returns the standalone
    result bit-for-bit."""
    reqs = MIXED_REQUESTS[:2]
    refs = [_standalone(m, c) for m, c in reqs]
    sc = ServiceConfig(max_slots=2, store_dir=str(tmp_path))

    cold = CodesignService(sc)
    rids = [cold.submit(ServiceRequest(layers=tuple(MODEL_LAYERS[m]),
                                       config=c)) for m, c in reqs]
    cold_resp = cold.run()
    assert all(cold_resp[r].result.stats["store_misses"] > 0 for r in rids)
    assert len(cold.store) > 0

    warm = CodesignService(sc)
    with _FanoutSpy() as spy:
        rids2 = [warm.submit(ServiceRequest(layers=tuple(MODEL_LAYERS[m]),
                                            config=c)) for m, c in reqs]
        warm_resp = warm.run()
    assert spy.calls == []  # zero inner searches
    for rid, ref in zip(rids2, refs):
        _assert_parity(warm_resp[rid].result, ref, where=rid)
        stats = warm_resp[rid].result.stats
        assert stats["store_misses"] == 0 and stats["store_hits"] > 0


# --- executor fan-out + overlapped ticks ---------------------------------------


@pytest.fixture(scope="module")
def service_pool():
    """One shared 2-worker pool for the service-executor tests (spawn +
    import cost paid once)."""
    from repro_torch.parallel.executor import ProcessExecutor

    ex = ProcessExecutor(n_workers=2)
    yield ex
    ex.close()


def test_process_executor_service_matches_standalone(service_pool):
    """The mixed batch through a process-executor service -- overlapped
    ticks: sessions park while their fused dispatches are in flight, step
    as results land -- is bit-identical to standalone runs."""
    refs = [_standalone(m, c) for m, c in MIXED_REQUESTS]
    svc = CodesignService(ServiceConfig(max_slots=len(MIXED_REQUESTS)),
                          executor=service_pool)
    rids = [svc.submit(ServiceRequest(layers=tuple(MODEL_LAYERS[m]), config=c))
            for m, c in MIXED_REQUESTS]
    responses = svc.run()
    for rid, ref in zip(rids, refs):
        _assert_parity(responses[rid].result, ref, where=rid)
    assert not svc._inflight and not svc._owners  # nothing leaked in flight


def test_mixed_fuse_groups_stagger_under_executor(service_pool):
    """Staggered admission with INCOMPATIBLE configs (different sw budgets):
    requests with different sw_cfg must land in separate fuse groups --
    every submitted spec carries exactly one config, and both configs'
    groups are dispatched -- and still match standalone parity."""
    cfg_a = svc_config(0, n_hw=3)
    cfg_b = dataclasses.replace(
        svc_config(1, n_hw=4),
        sw=SWSearchConfig(n_trials=10, n_warmup=4, pool_size=14))
    reqs = [("dqn", cfg_a), ("mlp", cfg_b), ("dqn", cfg_b),
            ("mlp", dataclasses.replace(cfg_a, seed=9))]
    refs = [_standalone(m, c) for m, c in reqs]

    svc = CodesignService(ServiceConfig(max_slots=2), executor=service_pool)
    submitted = []
    orig_submit = svc.executor.submit

    def spy_submit(jid, spec):
        submitted.append(spec)
        return orig_submit(jid, spec)

    svc.executor.submit = spy_submit
    try:
        rids = [svc.submit(ServiceRequest(layers=tuple(MODEL_LAYERS[m]),
                                          config=c)) for m, c in reqs]
        responses = svc.run()
    finally:
        svc.executor.submit = orig_submit
    for rid, ref in zip(rids, refs):
        _assert_parity(responses[rid].result, ref, where=rid)
    assert len(submitted) == svc.stats["fused_dispatches"]
    assert {s.sw for s in submitted} == {cfg_a.sw, cfg_b.sw}


def test_priority_orders_admission():
    """max_slots=1 serializes the slot: the high-priority request admits --
    and with equal budgets completes -- first even when submitted last;
    FIFO order is preserved within a priority level."""
    svc = CodesignService(ServiceConfig(max_slots=1))
    layers = tuple(MODEL_LAYERS["dqn"])
    lo1 = svc.submit(ServiceRequest(layers=layers, config=svc_config(0, n_hw=3)))
    lo2 = svc.submit(ServiceRequest(layers=layers, config=svc_config(1, n_hw=3)))
    hi = svc.submit(ServiceRequest(layers=layers, config=svc_config(2, n_hw=3),
                                   priority=3))
    responses = svc.run()
    assert list(responses) == [hi, lo1, lo2]


def test_request_priority_validation_and_roundtrip():
    req = ServiceRequest(layers=tuple(MODEL_LAYERS["dqn"]), priority=5,
                         config=svc_config(2), rid="p")
    assert ServiceRequest.from_json(req.to_json()) == req
    assert ServiceRequest.from_dict({"layers": "dqn"}).priority == 0
    with pytest.raises(ValueError, match="priority"):
        ServiceRequest(layers=tuple(MODEL_LAYERS["dqn"]), priority="high")
    with pytest.raises(ValueError, match="priority"):
        ServiceRequest(layers=tuple(MODEL_LAYERS["dqn"]), priority=True)


# --- store stats + prune ---------------------------------------------------------


def test_store_stats_and_oldest_first_prune(tmp_path):
    import os

    store = DesignStore(str(tmp_path))
    keys = [f"{i:02x}" + "f" * 30 for i in range(6)]  # one shard each
    for i, key in enumerate(keys):
        store.put(key, (None, float("inf")))
        os.utime(store._path(key), (1000.0 + i, 1000.0 + i))
    st = store.stats()
    assert st["entries"] == 6 == len(store)
    assert st["bytes"] > 0
    assert len(st["shards"]) == 6
    assert all(s == {"entries": 1, "bytes": st["bytes"] // 6}
               for s in st["shards"].values())

    assert store.prune(2) == 4  # oldest four evicted
    assert store.stats()["entries"] == 2
    assert store.get(keys[-1]) is not None  # newest survive
    assert store.get(keys[-2]) is not None
    assert store.get(keys[0]) is None
    assert store.prune(2) == 0  # idempotent at the bound
    assert store.prune(0) == 2  # full eviction
    assert len(store) == 0
    with pytest.raises(ValueError):
        store.prune(-1)
    with pytest.raises(ValueError):
        store.prune(2.5)


# --- session snapshot / resume ----------------------------------------------------


def test_session_snapshot_restore_resumes_bit_identically():
    """Interrupt a session halfway, snapshot, restore into a FRESH engine +
    session, finish there: the result equals the uninterrupted run (GP refit
    from the data prefix is deterministic; the cache rides in the
    snapshot)."""
    cfg = svc_config(5, "speculative", n_hw=6)
    layers = MODEL_LAYERS["dqn"]
    ref = CodesignEngine(cfg).run(layers)

    first = CodesignEngine(cfg).session(layers)
    for _ in range(3):
        assert first.step()
    snap = first.snapshot()

    resumed = CodesignEngine(cfg).session(layers).restore(snap)
    while resumed.step():
        pass
    _assert_parity(resumed.result(), ref)


def test_snapshot_refuses_mid_trial():
    cfg = svc_config(0)
    session = CodesignEngine(cfg).session(MODEL_LAYERS["dqn"])
    session.pending()  # plans the warmup block without committing it
    with pytest.raises(RuntimeError):
        session.snapshot()
    assert session.step()  # the cached plan commits; the session continues


def test_pending_is_trajectory_neutral():
    """Calling pending() (any number of times) before each step cannot change
    the trajectory: the outer plan is cached until committed."""
    cfg = svc_config(4)
    layers = MODEL_LAYERS["mlp"]
    ref = CodesignEngine(cfg).run(layers)
    session = CodesignEngine(cfg).session(layers)
    while True:
        items, seeds = session.pending()
        assert len(items) == len(seeds)
        assert session.pending()[0] == items  # cached plan -> same answer
        if not session.step():
            break
    _assert_parity(session.result(), ref)


# --- legacy shim ------------------------------------------------------------------


def test_legacy_shim_routes_through_search_session():
    """codesign(**legacy_kwargs) emits ONE consolidated DeprecationWarning and
    drives the same SearchSession machinery as the config API."""
    sessions = []
    orig = nested_mod.SearchSession

    class SpySession(orig):
        def __init__(self, *a, **kw):
            sessions.append(self)
            super().__init__(*a, **kw)

    nested_mod.SearchSession = SpySession
    try:
        with pytest.warns(DeprecationWarning) as record:
            codesign(MODEL_LAYERS["dqn"], n_hw_trials=3, n_hw_warmup=2,
                     n_sw_trials=10, n_sw_warmup=4, sw_pool=15, hw_pool=15,
                     device="cpu")
    finally:
        nested_mod.SearchSession = orig
    assert len(record) == 1  # one consolidated warning
    assert len(sessions) == 1  # the run was the session, stepped through


# --- config + request surface -----------------------------------------------------


def test_service_config_validation_and_roundtrip():
    sc = ServiceConfig(max_slots=2, fuse=False, store_dir="/tmp/x",
                       cache_entries=10)
    assert ServiceConfig.from_dict(sc.to_dict()) == sc
    with pytest.raises(ValueError):
        ServiceConfig(max_slots=0)
    with pytest.raises(ValueError):
        ServiceConfig(cache_entries=-1)
    with pytest.raises(ValueError):
        ServiceConfig(store_dir=7)
    with pytest.raises(ValueError):
        ServiceConfig.from_dict({"bogus": 1})


def test_request_json_roundtrip_and_model_names():
    req = ServiceRequest(layers=tuple(MODEL_LAYERS["dqn"]),
                         config=svc_config(2), rid="abc")
    back = ServiceRequest.from_json(req.to_json())
    assert back == req
    named = ServiceRequest.from_dict({"layers": "mlp"})
    assert named.layers == tuple(MODEL_LAYERS["mlp"])
    assert named.config == CodesignConfig()
    with pytest.raises(ValueError):
        ServiceRequest.from_dict({"layers": "nope"})
    with pytest.raises(ValueError):
        ServiceRequest.from_dict({"layers": "dqn", "bogus": 1})
    with pytest.raises(ValueError):
        ServiceRequest(layers=())


def test_submit_accepts_json_and_rejects_duplicate_rids():
    svc = CodesignService(ServiceConfig(max_slots=1))
    rid = svc.submit(json.dumps({"layers": "dqn", "rid": "x",
                                 "config": svc_config(0).to_dict()}))
    assert rid == "x"
    with pytest.raises(ValueError):
        svc.submit(ServiceRequest(layers=tuple(MODEL_LAYERS["dqn"]),
                                  rid="x"))
    assert svc.submit(ServiceRequest(layers=tuple(MODEL_LAYERS["dqn"]))) \
        .startswith("r")


# --- bounded caches ---------------------------------------------------------------


def test_lru_cache_bounds_and_counts():
    c = LRUCache(maxsize=2)
    c["a"], c["b"] = 1, 2
    assert c["a"] == 1  # refreshes recency
    c["c"] = 3          # evicts "b" (least recent)
    assert "b" not in c and "a" in c and "c" in c
    assert c.evictions == 1
    assert c.hits == 3          # the read + two membership hits
    assert c.misses == 1        # the "b" probe
    unbounded = LRUCache(0)
    for i in range(100):
        unbounded[i] = i
    assert len(unbounded) == 100 and unbounded.evictions == 0


def test_service_applies_cache_bound_to_requests():
    """A request that leaves engine.cache_entries at 0 gets the service-level
    LRU bound; eviction accounting surfaces in its result stats."""
    svc = CodesignService(ServiceConfig(max_slots=1, cache_entries=3))
    rid = svc.submit(ServiceRequest(layers=tuple(MODEL_LAYERS["dqn"]),
                                    config=svc_config(0)))
    stats = svc.run()[rid].result.stats
    assert stats["cache_size"] <= 3
    assert stats["cache_evictions"] > 0


def test_legacy_kwargs_map_onto_the_config_and_the_same_result():
    """`config_from_legacy_kwargs` maps each old kwarg to its config field
    (shared search knobs to both loops, layer_batched to the strategy), and
    the shim's result is the config API's."""
    cfg = config_from_legacy_kwargs(
        n_hw_trials=3, n_hw_warmup=2, n_sw_trials=10, n_sw_warmup=4,
        sw_pool=15, hw_pool=15, lam=0.5, layer_batched=True, device="cpu",
        backend="numpy", seed=4)
    assert (cfg.hw.n_trials, cfg.hw.n_warmup, cfg.hw.pool_size) == (3, 2, 15)
    assert (cfg.sw.n_trials, cfg.sw.n_warmup, cfg.sw.pool_size) == (10, 4, 15)
    assert cfg.sw.lam == cfg.hw.lam == 0.5
    assert cfg.engine.strategy == "layer_batched"
    assert (cfg.engine.device, cfg.engine.backend, cfg.seed) == (
        "cpu", "numpy", 4)
    assert config_from_legacy_kwargs(layer_batched=None).engine.strategy \
        == "auto"
    with pytest.raises(TypeError, match="unexpected keyword"):
        config_from_legacy_kwargs(n_trials=3)
    with pytest.warns(DeprecationWarning):
        legacy = codesign(MODEL_LAYERS["dqn"], n_hw_trials=3, n_hw_warmup=2,
                          n_sw_trials=10, n_sw_warmup=4, sw_pool=15,
                          hw_pool=15, device="cpu", backend="numpy", seed=4)
    _assert_parity(legacy, CodesignEngine(
        config_from_legacy_kwargs(
            n_hw_trials=3, n_hw_warmup=2, n_sw_trials=10, n_sw_warmup=4,
            sw_pool=15, hw_pool=15, device="cpu", backend="numpy",
            seed=4)).run(MODEL_LAYERS["dqn"]))
    with pytest.raises(TypeError, match="CodesignConfig"):
        codesign(MODEL_LAYERS["dqn"], 168)
    with pytest.raises(TypeError, match="not both"):
        codesign(MODEL_LAYERS["dqn"], CodesignConfig(), seed=1)
