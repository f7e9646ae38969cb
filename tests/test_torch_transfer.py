"""Cross-run transfer on the port (`repro_torch.service`), on the CPU:
trial-history warm starts for the outer GP, approximate design-store hits,
and the persistence/cache hardening -- the reference's tests/test_transfer.py,
run on `repro_torch`.

The load-bearing contracts:

  * EXACTNESS -- warm starting never replays approximate results.  Prior
    rows seed only the surrogate's data (incumbent/history/budget come from
    this run's evaluations), and an approximate store hit's mapping is
    re-evaluated on the *target* hardware before it can serve.  Corollary:
    warm_start=True with an EMPTY history is bit-identical to a cold run --
    pinned here against the checked-in goldens for all four seed workloads
    (backend="numpy", as the port reproduces them).
  * Warm-vs-cold quality has NO universal guarantee (priors reshape the
    outer acquisition); the pinned-seed test documents configurations where
    warm is never worse and strictly improves, as in the reference.

The other tests run the port's default engine, backend="torch", on the CPU.
"""

import dataclasses
import hashlib
import json
import os
import threading
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import (CodesignConfig, EngineConfig, HWSearchConfig,
                        LRUCache, ServiceConfig, SWSearchConfig)
from repro_torch.core.cache import SlotCache
from repro_torch.core.hwspace import HardwareSpace
from repro_torch.service import (CodesignService, DesignStore, ServiceRequest,
                           TrialHistory, history_key)
from repro_torch.timeloop import MODEL_LAYERS
from repro_torch.timeloop.mapping import Mapping
from repro_torch.timeloop.model import evaluate

GOLDEN_PATH = Path(__file__).parent / "goldens" / "codesign.json"


def transfer_config(seed=0, n_hw=4, warm=False, **hw_kw):
    return CodesignConfig(
        sw=SWSearchConfig(n_trials=12, n_warmup=5, pool_size=15),
        hw=HWSearchConfig(n_trials=n_hw, n_warmup=2, pool_size=15, spec_k=2,
                          warm_start=warm, **hw_kw),
        engine=EngineConfig(device="cpu"),
        seed=seed)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the GP's matrices are tiny, and test workers run
    side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def serve_one(model, config, store_dir=None, history_dir=None):
    svc = CodesignService(ServiceConfig(store_dir=store_dir,
                                        history_dir=history_dir))
    rid = svc.submit(ServiceRequest(layers=tuple(MODEL_LAYERS[model]),
                                    config=config))
    return svc.run()[rid].result


# --- empty history is exactly a cold run -------------------------------------------


@pytest.mark.parametrize("model", ("resnet", "dqn", "mlp", "transformer"))
def test_warm_start_empty_history_matches_golden(model, tmp_path):
    """warm_start=True over an empty history must be bit-identical to cold:
    the same winning design hash and EDP the checked-in goldens pin.  (The
    golden configs force backend=numpy, so both CI jobs run one program.)"""
    cfg = CodesignConfig(
        sw=SWSearchConfig(n_trials=10, n_warmup=5, pool_size=15),
        hw=HWSearchConfig(n_trials=3, n_warmup=2, pool_size=12,
                          num_pes=256 if model == "transformer" else 168,
                          warm_start=True),
        engine=EngineConfig(backend="numpy", device="cpu"),
        seed=0)
    result = serve_one(model, cfg, history_dir=str(tmp_path / "history"))
    hw = dataclasses.astuple(result.best_hw)
    maps = sorted((name, dataclasses.astuple(m))
                  for name, m in result.best_mappings.items())
    got = {
        "design_sha256": hashlib.sha256(repr((hw, maps)).encode()).hexdigest(),
        "best_log10_edp": round(float(np.log10(result.best_model_edp)), 6),
        "n_trials": len(result.hw_result.history),
    }
    assert got == json.loads(GOLDEN_PATH.read_text())[model]
    assert result.stats["prior_rows"] == 0


# --- pinned warm-vs-cold quality ---------------------------------------------------


@pytest.mark.parametrize("model,seed,strict", [
    ("mlp", 0, True), ("mlp", 1, True), ("dqn", 1, True), ("mlp", 3, False),
])
def test_warm_start_not_worse_at_pinned_seeds(model, seed, strict, tmp_path):
    """At these pinned (workload, seed) points a warm-started run's incumbent
    is never worse than cold at the same outer budget -- strictly better
    where marked.  (Deterministic per backend, and these trajectories agree
    across both backends; see the module docstring for why this is a pinned
    property, not a universal one.)"""
    store, hist = str(tmp_path / "store"), str(tmp_path / "history")
    cold = serve_one(model, transfer_config(seed), store, hist)
    warm = serve_one(model, transfer_config(seed, warm=True), store, hist)
    assert warm.stats["prior_rows"] > 0
    if strict:
        assert warm.best_model_edp < cold.best_model_edp
    else:
        assert warm.best_model_edp <= cold.best_model_edp


# --- approximate store hits stay exact ---------------------------------------------


def test_approximate_hit_serves_exact_target_edp(tmp_path):
    """`nearest` returns the neighbor's OWN (mapping, edp); the transplant
    path must re-evaluate that mapping on the target hardware and serve the
    target's exact EDP -- never the neighbor's."""
    store_dir = str(tmp_path / "store")
    layers = MODEL_LAYERS["dqn"]
    serve_one("dqn", transfer_config(0), store_dir)  # populate with metadata

    store = DesignStore(store_dir)
    target = HardwareSpace().sample(np.random.default_rng(123))
    near = store.nearest(target, layers[0])
    assert near is not None
    neighbor_hw, mapping, neighbor_edp = near
    # the returned edp belongs to the neighbor's hardware...
    assert neighbor_edp == evaluate(neighbor_hw, mapping, layers[0]).edp

    # ...and the scheduler's transplant serves the target's exact evaluation
    svc = CodesignService(ServiceConfig(store_dir=store_dir))
    slot = types.SimpleNamespace(warm_hits=0)
    warm = svc._transplant(slot, (target, layers[0]))
    ev = evaluate(target, mapping, layers[0])
    if np.isfinite(ev.edp):
        assert warm == (mapping, float(ev.edp)) and slot.warm_hits == 1
        assert warm[1] != neighbor_edp or target == neighbor_hw
    else:  # mapping invalid on the target: no warm start, never a wrong EDP
        assert warm is None and slot.warm_hits == 0

    # a layer the store has never seen finds no neighbor
    other = dataclasses.replace(layers[0], C=layers[0].C + 1)
    assert store.nearest(target, other) is None


# --- trial history: round-trip, torn lines, concurrent writers ---------------------


def _row(i, feasible=True):
    return {"hw": [168, 512, 55296, 16.0, 12, 14, 192, 224, 96, 1, 1, 1, 4,
                   1, 1, 1, [0.2, 1.0, 2.0, 6.0, 200.0, float(i)]],
            "features": [float(i)] * 3,
            "utility": (-0.5 * i) if feasible else None,
            "feasible": feasible}


def test_history_append_load_roundtrip(tmp_path):
    hist = TrialHistory(str(tmp_path))
    hist.append("ab" * 16, _row(0))
    hist.append("ab" * 16, _row(1, feasible=False))
    hist.append("cd" * 16, _row(2))  # distinct key: distinct file
    rows = hist.load("ab" * 16)
    assert [r["feasible"] for r in rows] == [True, False]
    assert rows[0]["utility"] == 0.0 and rows[1]["utility"] is None
    assert rows[0]["hw"][-1] == (0.2, 1.0, 2.0, 6.0, 200.0, 0.0)  # tuples back
    assert len(hist.load("cd" * 16)) == 1
    assert hist.load("ef" * 16) == []  # unknown key: empty, not an error
    # max_rows keeps the most recent
    for i in range(5):
        hist.append("ab" * 16, _row(10 + i))
    tail = hist.load("ab" * 16, max_rows=3)
    assert [r["features"][0] for r in tail] == [12.0, 13.0, 14.0]


def test_history_skips_torn_and_foreign_lines(tmp_path):
    hist = TrialHistory(str(tmp_path))
    key = "ab" * 16
    hist.append(key, _row(0))
    path = hist._path(key)
    with open(path, "ab") as f:
        f.write(b'{"hw": [1, 2], "feat')       # torn mid-write
    hist.append(key, _row(1))
    with open(path, "ab") as f:
        f.write(b'{"foreign": true}\n')        # schema-invalid
    rows = hist.load(key)
    # the torn line glues onto the next valid one, killing both -- but never
    # the reader; every line before and after survives
    assert [r["features"][0] for r in rows] == [0.0]
    hist.append(key, _row(2))
    assert [r["features"][0] for r in hist.load(key)] == [0.0, 2.0]


def test_history_concurrent_writers(tmp_path):
    """O_APPEND single-write rows from many threads all land whole."""
    hist = TrialHistory(str(tmp_path))
    key = "ab" * 16
    n_threads, n_rows = 8, 25

    def writer(t):
        h = TrialHistory(str(tmp_path))  # own fd per writer, like processes
        for i in range(n_rows):
            h.append(key, _row(t * 1000 + i))

    threads = [threading.Thread(target=writer, args=(t,))
               for t in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    rows = hist.load(key)
    assert len(rows) == n_threads * n_rows
    seen = {int(r["features"][0]) for r in rows}
    assert seen == {t * 1000 + i for t in range(n_threads)
                    for i in range(n_rows)}


def test_history_key_invariances():
    layers = tuple(MODEL_LAYERS["dqn"])
    base = transfer_config(0)
    key = history_key(layers, base.hw, base.sw, base.engine)
    # excluded knobs: budgets, seeds-by-construction, warm_start*, spec_k
    for hw_kw in ({"n_trials": 9}, {"n_warmup": 1}, {"pool_size": 60},
                  {"spec_k": 3}, {"warm_start": True},
                  {"warm_start_rows": 7}, {"prune": "safe"}):
        alt_hw = dataclasses.replace(base.hw, **hw_kw)
        assert history_key(layers, alt_hw, base.sw, base.engine) == key
    # included: the workload set, the hw-space parameterization, the inner
    # search config, and the engine fields that determine inner results
    assert history_key(layers[:-1], base.hw, base.sw, base.engine) != key
    assert history_key(layers, dataclasses.replace(base.hw, num_pes=256),
                       base.sw, base.engine) != key
    assert history_key(layers, base.hw,
                       dataclasses.replace(base.sw, n_trials=13),
                       base.engine) != key
    assert history_key(layers, base.hw, base.sw,
                       dataclasses.replace(base.engine, backend="numpy")) != key
    # the device is not hashed: a history written on the card serves the CPU
    assert history_key(layers, base.hw, base.sw,
                       dataclasses.replace(base.engine, device="cuda")) == key


# --- config surface ----------------------------------------------------------------


def test_warm_start_config_validation_and_roundtrip():
    for bad in ({"warm_start": "yes"}, {"warm_start_bound_mean": 1},
                {"warm_start_rows": 0}, {"warm_start_rows": -3}):
        with pytest.raises(ValueError):
            HWSearchConfig(**bad)
    with pytest.raises(ValueError):
        ServiceConfig(history_dir=7)
    cfg = transfer_config(0, warm=True, warm_start_rows=64)
    assert CodesignConfig.from_json(cfg.to_json()) == cfg
    sc = ServiceConfig(history_dir="/tmp/h")
    assert ServiceConfig.from_dict(json.loads(json.dumps(sc.to_dict()))) == sc


# --- hardening regressions (the four bugfixes) -------------------------------------


def test_store_get_malformed_entry_is_a_miss_and_evicted(tmp_path):
    """Schema-invalid (valid JSON, wrong shape) and undecodable entries are
    misses, and the poisoned file is removed so it cannot fail every future
    get."""
    store = DesignStore(str(tmp_path))
    key = "ab" * 16
    store.put(key, (None, float("inf")))
    path = store._path(key)
    for poison in (b'{"feasible": true}',       # KeyError: no mapping/edp
                   b'{"feasible": true, "mapping": 3, "edp": 1.0}',
                   b"not json at all"):
        with open(path, "wb") as f:
            f.write(poison)
        misses = store.misses
        assert store.get(key) is None
        assert store.misses == misses + 1
        assert not os.path.exists(path)
        store.put(key, (None, float("inf")))  # store stays usable
    assert store.get(key) == (None, float("inf"))


def test_slot_cache_re_put_replaces_in_place():
    """A re-put of a live key must update that slot, not append a duplicate:
    the duplicate made `get` serve the stale older slot and pushed a distinct
    live entry out of the memo."""
    a, b = object(), object()
    cache = SlotCache("test_transfer_slots", capacity=2)
    cache.put(a, 1)
    cache.put(a, 2)
    assert cache.get(a) == 2            # pre-fix: stale 1 (older slot wins)
    cache.put(b, 10)
    cache.put(a, 3)
    assert cache.get(b) == 10           # pre-fix: b evicted by a's duplicate
    assert cache.get(a) == 3
    assert len(cache._slots) == 2


def test_lru_cache_in_then_read_counts_once():
    c = LRUCache(maxsize=4)
    c["a"] = 1
    assert "a" in c and c["a"] == 1
    assert (c.hits, c.misses) == (1, 0)  # pre-fix: (2, 0)
    assert "b" not in c
    with pytest.raises(KeyError):
        c["b"]
    assert (c.hits, c.misses) == (1, 1)  # pre-fix: (1, 2)
    # any operation between the probe and the read clears the prime
    assert "a" in c
    c["x"] = 0
    assert c["a"] == 1
    assert (c.hits, c.misses) == (3, 1)
    # direct reads (no membership probe) still count normally
    assert c["x"] == 0
    assert (c.hits, c.misses) == (4, 1)


def test_store_prune_ties_break_on_path_not_size(tmp_path):
    """Equal-mtime entries evict in path order, independent of entry size.
    Pre-fix the (mtime, size, path) triple sort tie-broke on SIZE, so
    eviction order depended on how many bytes each mapping serialized to."""
    store = DesignStore(str(tmp_path))
    big = Mapping(factors=((2, 3, 5, 7, 11, 13, 17),) * 3,
                  order_lb=(0, 1, 2, 3, 4, 5, 6),
                  order_gb=(6, 5, 4, 3, 2, 1, 0),
                  order_dram=(0, 2, 4, 6, 1, 3, 5))
    keys = ["aa" + "0" * 30, "bb" + "0" * 30, "cc" + "0" * 30]
    store.put(keys[0], (big, 1.0))               # large file, path-smallest
    store.put(keys[1], (big, 2.0))               # large file
    store.put(keys[2], (None, float("inf")))     # tiny file, path-largest
    for k in keys:
        os.utime(store._path(k), (1_000_000.0, 1_000_000.0))
    assert store.prune(max_entries=1) == 2
    # path order evicts aa then bb; size order would have evicted cc first
    assert store.get(keys[2]) == (None, float("inf"))
    assert store.get(keys[0]) is None and store.get(keys[1]) is None
