"""The port's span recorder (`repro_torch.trace`) on the CPU.

A span records only while a `torch.profiler` session is open; the search's
layers each open theirs (`search.step` > `probe` > `inner.search` > `gp.fit`,
with `inner.sample`, `inner.observe`, `gp.score`, `gp.update`,
`cost_model.*` and `host.wait` beside them).  Held here: nothing is
recorded outside a session; a short search under a CPU profiler yields every
kind with the parent chain; the counts the spans carry agree with what the
search did; the buffer's bound, and that a new session empties it; and the
search's result is the same with the profiler open and closed.
"""

import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import trace
from repro_torch.core import (CodesignConfig, CodesignEngine, EngineConfig,
                              HWSearchConfig, SWSearchConfig)
from repro_torch.core.bo import bo_maximize, bo_maximize_many
from repro_torch.core.gp import (GP, GPClassifierStack, GPStack, _bucket,
                                 _bucket_stack)
from repro_torch.core.swspace import fanout_spaces
from repro_torch.timeloop import MODEL_LAYERS
from repro_torch.timeloop import batch as tlb
from repro_torch.timeloop.eyeriss import eyeriss_168

DEV = "cpu"
KINDS = ("search.step", "probe", "inner.search", "inner.sample",
         "inner.observe", "gp.fit", "gp.score", "gp.update",
         "cost_model.forward", "cost_model.bound", "cost_model.scalar",
         "host.wait")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _profiler():
    return profile(activities=[ProfilerActivity.CPU])


def _config() -> CodesignConfig:
    # Warm-up fan-out, then scored probes searched one by one (the chain
    # search.step > probe > inner.search > gp.fit); the safe gate and the
    # bound prior mean run both lower-bound paths, rank-1 updates the outer
    # GP's `append_observation`.
    return CodesignConfig(
        sw=SWSearchConfig(n_trials=8, n_warmup=4, pool_size=10),
        hw=HWSearchConfig(n_trials=4, n_warmup=2, pool_size=10,
                          prune="safe", warm_start_bound_mean=True),
        engine=EngineConfig(device=DEV, strategy="probe_fanout",
                            hw_gp_refit_every=2, gp_rank1_updates=True),
        seed=5)


def _search() -> dict:
    """Two sessions on one engine (the second finds every probe cached):
    everything the search decided."""
    engine = CodesignEngine(_config())
    layers = MODEL_LAYERS["dqn"]
    out = []
    for _ in range(2):
        session = engine.session(layers)
        while session.step():
            pass
        res = session.result()
        out.append({
            "best_hw": res.best_hw, "best_mappings": res.best_mappings,
            "best_model_edp": res.best_model_edp,
            "points": res.hw_result.points,
            "values": res.hw_result.values,
            "history": res.hw_result.history,
            "stats": res.stats})
    return {"sessions": out, "cache": engine.cache.items()}


@pytest.fixture(scope="module")
def runs():
    trace.clear()
    off = _search()
    spans_off = trace.spans()
    with _profiler():
        on = _search()
    spans_on = trace.spans()
    trace.clear()
    return {"off": off, "on": on, "spans_off": spans_off,
            "spans": spans_on}


def test_nothing_recorded_without_a_profiler(runs):
    assert runs["spans_off"] == []
    assert not trace.span("probe")
    with trace.span("probe", outcome="x") as sp:
        sp.set(outcome="y")
    assert trace.spans() == []


@pytest.mark.parametrize("kind", KINDS)
def test_a_search_under_a_cpu_profiler_yields_every_kind(runs, kind):
    spans = [s for s in runs["spans"] if s[0] == kind]
    assert spans, f"no {kind} span"
    for name, t0, t1, parent, attrs in spans:
        assert 0 < t0 <= t1
        assert parent is None or runs["spans"][parent][1] <= t0


def test_the_parent_chain(runs):
    spans = runs["spans"]

    def chain(i):
        out = []
        while i is not None:
            out.append(spans[i][0])
            i = spans[i][3]
        return out

    chains = {tuple(chain(i)) for i, s in enumerate(spans)
              if s[0] == "gp.fit"}
    assert ("gp.fit", "inner.search", "probe", "search.step") in chains
    # Every span of a session nests in one of its steps.
    assert all(chain(i)[-1] == "search.step" for i in range(len(spans)))


def test_probe_outcomes(runs):
    # A probe searched where an `inner.search` span opened inside it; the
    # warm-up fan-out searches in its step, ahead of the probes.
    spans = runs["spans"]
    steps = [i for i, s in enumerate(spans) if s[0] == "search.step"]
    n_first = len(runs["on"]["sessions"][0]["points"])
    probes = [i for i, s in enumerate(spans) if s[0] == "probe"]
    assert len(probes) == n_first + len(runs["on"]["sessions"][1]["points"])
    searched = set()
    for s in spans:
        if s[0] == "inner.search":
            p = s[3]
            while p is not None and spans[p][0] != "probe":
                p = spans[p][3]
            if p is not None:
                searched.add(p)
    assert searched and searched <= set(probes[:n_first])
    # The second session finds every probe in the cache: none searches.
    assert not searched & set(probes[n_first:])
    assert all(spans[i][4]["seed"] == 5 for i in steps)


def test_spans_leave_the_search_unchanged(runs):
    off, on = runs["off"], runs["on"]
    assert off["cache"] == on["cache"]
    for a, b in zip(off["sessions"], on["sessions"]):
        assert a["best_hw"] == b["best_hw"]
        assert a["best_mappings"] == b["best_mappings"]
        assert a["best_model_edp"] == b["best_model_edp"]
        assert a["points"] == b["points"]
        assert np.array_equal(a["values"], b["values"])
        assert np.array_equal(a["history"], b["history"])
        assert a["stats"] == b["stats"]


@pytest.mark.parametrize("pad_to", [None, 6])
def test_inner_trials_add_up_to_the_results_points(pad_to):
    hw = eyeriss_168()
    layers = MODEL_LAYERS["dqn"]
    spaces = fanout_spaces([(hw, ly) for ly in layers], device=DEV,
                           pad_to=pad_to)
    seeds = [11] * len(spaces)
    trace.clear()
    with _profiler():
        many = bo_maximize_many(spaces, n_trials=7, n_warmup=4,
                                pool_size=10, seed=seeds, device=DEV)
        one = bo_maximize(spaces[0], n_trials=6, n_warmup=4, pool_size=10,
                          seed=3, device=DEV)
    spans = [s for s in trace.spans() if s[0] == "inner.search"]
    trace.clear()
    assert [s[4] for s in spans] == [
        {"runs": len(spaces), "trials": sum(len(r.points) for r in many)},
        {"runs": 1, "trials": len(one.points)}]
    assert spans[0][4]["trials"] == 7 * len(spaces)


def test_inner_sample_spans_carry_the_samplers_counters():
    """Each `inner.sample` span carries the pools it requested and the
    mappings drawn and kept for them while a profiler is open; the counters
    count alike with it closed, and the lockstep search's results are the
    same bits either way."""
    hw = eyeriss_168()
    spaces = fanout_spaces([(hw, ly) for ly in MODEL_LAYERS["resnet"]],
                           device=DEV)
    kw = dict(n_trials=7, n_warmup=4, pool_size=10, seed=[11] * len(spaces),
              device=DEV)
    trace.clear()
    c0 = tlb.pool_counts()
    off = bo_maximize_many(spaces, **kw)
    c1 = tlb.pool_counts()
    assert trace.spans() == []
    with _profiler():
        on = bo_maximize_many(spaces, **kw)
    c2 = tlb.pool_counts()
    attrs = [s[4] for s in trace.spans() if s[0] == "inner.sample"]
    trace.clear()
    for a, b in zip(off, on):
        assert a.points == b.points and a.best_point == b.best_point
        assert np.array_equal(a.values, b.values)
        assert np.array_equal(a.history, b.history)
    delta = dict(zip(("pools", "drawn", "kept"),
                     (n2 - n1 for n1, n2 in zip(c1, c2))))
    assert delta == dict(zip(delta, (n1 - n0 for n0, n1 in zip(c0, c1))))
    # One span for the warm-up, one a lockstep trial; together they hold
    # every pool the search drew.
    assert len(attrs) == 1 + 7 - 4
    assert {k: sum(a[k] for a in attrs) for k in delta} == delta
    assert attrs[0] == dict(attrs[0], pools=len(spaces),
                            kept=4 * len(spaces))
    assert all(a["drawn"] >= a["kept"] > 0 and a["pools"] > 0
               for a in attrs)


def test_gp_fit_attrs_match_the_stack_that_was_fit():
    rng = np.random.default_rng(0)
    ns, d = (5, 13, 9), 14
    Xs = [rng.normal(size=(n, d)) for n in ns]
    ys = [rng.normal(size=n) for n in ns]
    trace.clear()
    with _profiler():
        GPStack(kind="linear", noisy=False, steps=6, device=DEV).fit(Xs, ys)
        GP(kind="linear", steps=4, device=DEV).fit(Xs[1], ys[1])
        GPClassifierStack(steps=3, device=DEV).fit(
            Xs[:2], [y > 0 for y in ys[:2]])
    fits = [s[4] for s in trace.spans() if s[0] == "gp.fit"]
    trace.clear()
    assert fits == [
        {"runs": 3, "rows": _bucket_stack(13), "d": d, "steps": 6,
         "kind": "linear", "path": "eager"},
        {"runs": 1, "rows": _bucket(13), "d": d, "steps": 4,
         "kind": "linear", "path": "eager"},
        {"runs": 2, "rows": _bucket_stack(13), "d": d, "steps": 3,
         "kind": "se", "path": "eager"}]


@pytest.mark.parametrize("fit", ["stack_woodbury", "single_se", "single_tol"])
def test_a_cpu_fit_records_the_eager_path(fit):
    """Under a CPU profiler every `gp.fit` span says `path` "eager": K4 runs
    only on the card."""
    rng = np.random.default_rng(1)
    Xs = [rng.normal(size=(n, 11)) for n in (20, 40)]
    ys = [rng.normal(size=len(x)) for x in Xs]
    trace.clear()
    with _profiler():
        if fit == "stack_woodbury":
            GPStack(kind="linear", noisy=False, steps=2, device=DEV).fit(Xs,
                                                                         ys)
        else:
            GP(kind="se" if fit == "single_se" else "linear", steps=2,
               fit_tol=1.0 if fit == "single_tol" else 0.0,
               device=DEV).fit(Xs[0], ys[0])
    paths = [s[4].get("path") for s in trace.spans() if s[0] == "gp.fit"]
    trace.clear()
    assert paths == ["eager"]


def test_host_readback_records_its_wait():
    x = torch.arange(4.0)
    trace.clear()
    with _profiler():
        a = trace.host(x)
        b = trace.host(np.ones(2))
    spans = trace.spans()
    trace.clear()
    assert np.array_equal(a, x.numpy()) and np.array_equal(b, np.ones(2))
    assert [s[0] for s in spans] == ["host.wait"]


def test_the_buffer_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(trace, "CAPACITY", 3)
    trace.clear()
    with _profiler():
        with trace.span("a", k=1):
            for _ in range(4):
                with trace.span("b"):
                    pass
    spans = trace.spans()
    assert [(s[0], s[3], s[4]) for s in spans] == [
        ("a", None, {"k": 1}), ("b", 0, {}), ("b", 0, {})]
    assert all(s[2] is not None for s in spans)
    assert trace.dropped() == 2
    trace.clear()
    assert trace.spans() == [] and trace.dropped() == 0


def test_spans_are_snapshots():
    trace.clear()
    with _profiler():
        with trace.span("a") as sp:
            open_now = trace.spans()
            sp.set(n=2)
    assert open_now == [("a", open_now[0][1], None, None, {})]
    assert collections.Counter(s[0] for s in trace.spans()) == {"a": 1}
    assert trace.spans()[0][4] == {"n": 2}
    trace.clear()


def test_the_outer_gp_update_carries_its_rows(runs):
    updates = [s[4] for s in runs["spans"] if s[0] == "gp.update"]
    assert updates and all(u["rows"] in (8, 16, 32) for u in updates)
    bounds = [s[4] for s in runs["spans"] if s[0] == "cost_model.bound"]
    assert any("rows" in b for b in bounds)     # the device twin
    assert any("rows" not in b for b in bounds)  # the scalar bound
    forwards = [s[4]["rows"] for s in runs["spans"]
                if s[0] == "cost_model.forward"]
    assert forwards and all(r % 8 == 0 for r in forwards)



def test_a_new_session_empties_the_buffer():
    trace.clear()
    with _profiler():
        with trace.span("a"):
            pass
    assert [s[0] for s in trace.spans()] == ["a"]
    with trace.span("between"):  # no session: records nothing
        pass
    with _profiler():
        with trace.span("b"):
            pass
        with trace.span("c"):
            pass
    assert [s[0] for s in trace.spans()] == ["b", "c"]
    trace.clear()


def test_a_torch_without_the_flag_records_nothing(monkeypatch):
    # A stand-in for a torch whose profiler module lacks the flag.
    monkeypatch.setattr(trace, "_profiler", object())
    trace.clear()
    with _profiler():
        with trace.span("a") as sp:
            assert not sp
    assert trace.spans() == []
