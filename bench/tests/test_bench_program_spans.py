"""The metrics that read the program's own spans (`bench/program_spans.py`
and its four readers), on synthetic records: the alignment of the program's
clock to the record's, the refusals that make a metric read None, the idle
time inside spans, each reader's value and its None where its spans are
missing, and the report of what the metrics leave out.

    PYTHONPATH=src python -m pytest -q bench/tests
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT / "src")]

import harness  # noqa: E402
import program_spans  # noqa: E402
from repro_torch import trace  # noqa: E402

NEW = ("gp.fit_share", "gp.fit_ms", "gp.fit_device_idle_share",
       "host.wait_share")
# The program's clock reads 1000 s at the window's start.
T0 = 1000.0


def _ns(t: float) -> int:
    return round((T0 + t) * 1e9)


def _program(jitter=(0.0, 0.0)):
    """Two steps; each holds a probe, an inner search, a fit and a wait."""
    out = []
    for t, dj in zip((1.0, 5.0), jitter):
        step = len(out)
        out.append(("search.step", _ns(t + 1e-5 + dj), _ns(t + 3.0), None,
                    {"seed": 7}))
        probe = len(out)
        out.append(("probe", _ns(t + 0.1), _ns(t + 2.9), step, {}))
        inner = len(out)
        out.append(("inner.search", _ns(t + 0.2), _ns(t + 2.8), probe,
                    {"runs": 4, "trials": 240}))
        out.append(("gp.fit", _ns(t + 0.5), _ns(t + 1.5), inner,
                    {"runs": 4, "rows": 64, "d": 14, "steps": 80,
                     "kind": "linear"}))
        out.append(("gp.fit", _ns(t + 0.6), _ns(t + 0.8), len(out) - 1,
                    {"kind": "se"}))
        out.append(("host.wait", _ns(t + 2.0), _ns(t + 2.25), inner, {}))
    return out


def _record(device=None, probes=2):
    hooks = [("SearchSession.step", 1.0, 4.0 + 1e-5),
             ("SearchSession.step", 5.0, 8.0 + 1e-5)]
    return {"window_s": 10.0, "probes": probes,
            "spans": {"outer": hooks}, "missing": {}, "device": device}


@pytest.fixture
def program(monkeypatch):
    def use(spans):
        monkeypatch.setattr(trace, "spans", lambda: list(spans))
    return use


def test_the_offset_and_residual_are_found():
    spans = _program(jitter=(0.0, 4e-4))
    offset, residual = program_spans.alignment(
        spans, _record()["spans"]["outer"])
    assert offset == pytest.approx(T0 + 1e-5, abs=1e-9)
    assert residual == pytest.approx(4e-4, abs=1e-9)


def test_load_maps_spans_onto_the_window(program):
    program(_program())
    spans = program_spans.load(_record())
    fit = spans[3]
    assert fit[0] == "gp.fit" and fit[3] == 2
    assert fit[1] == pytest.approx(1.5 - 1e-5, abs=1e-9)
    assert fit[2] == pytest.approx(2.5 - 1e-5, abs=1e-9)


@pytest.mark.parametrize("case", ["count", "residual", "none", "no_hooks"])
def test_misalignment_gives_none(program, case):
    spans = _program()
    record = _record()
    if case == "count":
        spans = spans[:6]
    elif case == "residual":
        spans = _program(jitter=(0.0, 1.2e-3))
    elif case == "none":
        spans = []
    else:
        record["spans"] = {}
    program(spans)
    assert program_spans.load(record) is None
    for name in NEW:
        assert harness.load_reader(name)(_record_with_device(record)) is None


def _record_with_device(record):
    record = dict(record)
    record["device"] = [("k", 0.0, 0.5)]
    return record


def test_idle_time_inside_spans_is_exact():
    within = [(1.0, 2.0), (3.0, 5.0), (6.0, 6.5)]
    events = sorted([("a", 0.5, 1.2), ("b", 1.1, 1.3), ("c", 1.5, 1.6),
                     ("d", 2.5, 3.5), ("e", 3.4, 3.6), ("f", 4.0, 4.25),
                     ("g", 4.5, 7.0), ("h", 8.0, 9.0)], key=lambda e: e[1])
    # Busy inside: 0.3 + 0.1 in the first, 0.6 + 0.25 + 0.5 in the second,
    # all 0.5 of the third.
    idle = program_spans.idle_inside(events, within)
    assert idle == pytest.approx(3.5 - (0.4 + 1.35 + 0.5), abs=1e-12)
    assert program_spans.idle_inside([], within) == pytest.approx(3.5)
    assert program_spans.idle_inside(events, []) == 0.0


def test_outermost_skips_nested_spans_of_the_same_name(program):
    program(_program())
    fits = program_spans.outermost(program_spans.load(_record()), "gp.fit")
    assert [s[4].get("rows") for s in fits] == [64, 64]
    assert program_spans.outermost(None, "gp.fit") == []


def test_each_reader_reads_the_spans(program):
    program(_program())
    device = [("k", 1.5, 1.75), ("k", 1.7, 1.8), ("k", 6.0, 6.5)]
    record = _record(device=device)
    read = {name: harness.load_reader(name)(record) for name in NEW}
    assert read["gp.fit_share"] == pytest.approx(100.0 * 2.0 / 10.0)
    assert read["gp.fit_ms"] == pytest.approx(1000.0)
    # Busy inside the fits: 0.3 in the first (from 1.5 - 1e-5), 0.5 in the
    # second.
    assert read["gp.fit_device_idle_share"] == pytest.approx(
        100.0 * (2.0 - 0.8) / 2.0, abs=1e-3)
    assert read["host.wait_share"] == pytest.approx(100.0 * 0.5 / 10.0)


@pytest.mark.parametrize("name", NEW)
def test_each_reader_is_none_without_its_spans(program, name):
    spans = _program()
    missing = {"gp.fit_share": "gp.fit", "gp.fit_ms": "gp.fit",
               "gp.fit_device_idle_share": "gp.fit",
               "host.wait_share": "host.wait"}[name]
    # Spans of the kind renamed: the indices of the others stay.
    program([(("other",) + s[1:]) if s[0] == missing else s for s in spans])
    assert harness.load_reader(name)(
        _record(device=[("k", 0.0, 9.0)])) is None


def test_readers_are_none_without_the_program_recorder(monkeypatch):
    import repro_torch

    # A program that lacks the recorder: `repro_torch.trace` fails to import.
    monkeypatch.delattr(repro_torch, "trace")
    monkeypatch.setitem(sys.modules, "repro_torch.trace", None)
    assert program_spans.load(_record()) is None
    for name in NEW:
        assert harness.load_reader(name)(_record(device=[])) is None


def test_self_time_and_time_by_shape(program):
    program(_program())
    spans = program_spans.load(_record())
    own = program_spans.self_time(spans)
    assert own["search.step"] == pytest.approx(2 * (0.2 - 1e-5), abs=1e-9)
    assert own["probe"] == pytest.approx(0.4, abs=1e-9)
    assert own["inner.search"] == pytest.approx(2 * (2.6 - 1.0 - 0.25),
                                                abs=1e-9)
    assert own["gp.fit"] == pytest.approx(2.0, abs=1e-9)
    assert own["host.wait"] == pytest.approx(0.5, abs=1e-9)
    shapes = program_spans.by_shape(spans)
    assert shapes["gp.fit"] == {
        "d=14 kind=linear rows=64 runs=4 steps=80": [2, pytest.approx(2.0)],
        "kind=se": [2, pytest.approx(0.4)]}
    assert shapes["inner.search"] == {"runs=4": [2, pytest.approx(5.2)]}
    assert "probe" not in shapes and "host.wait" not in shapes


def test_probes_searched_and_answered():
    spans = [("search.step", 0.0, 9.0, None, {}),
             ("probe", 0.1, 3.0, 0, {}),
             ("cost_model.bound", 0.2, 0.3, 1, {}),
             ("inner.search", 0.4, 2.0, 1, {}),
             ("probe", 3.1, 3.2, 0, {}),
             ("probe", 3.3, 8.0, 0, {}),
             ("inner.search", 3.4, 5.0, 5, {}),
             ("inner.search", 5.1, 7.0, 5, {})]
    assert program_spans.probes(spans) == {"searched": 2, "answered": 1}


def test_the_report(program):
    program(_program())
    device = [("k", 1.5, 1.75), ("k", 1.7, 1.8), ("k", 6.0, 6.5)]
    record = _record(device=device)
    record["spans"]["gp"] = [("GPStack.fit", 1.5, 2.5), ("GP.fit", 5.5, 6.6)]
    rep = program_spans.report(record)
    assert rep["alignment_s"] == (pytest.approx(T0 + 1e-5), 0.0)
    assert rep["spans"] == 12
    assert rep["probes"] == {"searched": 2, "answered": 0}
    assert rep["trials_per_probe"] == pytest.approx(240.0)
    assert rep["program_gp_share"] == pytest.approx(20.0)
    assert rep["hooks_gp_share"] == pytest.approx(21.0)
    assert rep["program_cost_model_share"] == 0.0
    assert rep["hooks_cost_model_share"] == 0.0
    assert rep["idle_share_inside"] == {"gp.fit": pytest.approx(60.0,
                                                                abs=1e-3),
                                        "host.wait": pytest.approx(100.0)}
    # Busy 1.5-1.8 and 6.0-6.5: the gaps 1.8-6.0 (inside the first step,
    # after its probe), 6.5-10 and 0-1.5 (no program span open).
    assert rep["idle_gaps"] == [["search.step", pytest.approx(4.2)],
                                ["harness", pytest.approx(3.5)],
                                ["harness", pytest.approx(1.5)]]
    lags = rep["wait_lags"]
    assert lags["n"] == 2 and lags["below_zero"] == 0
    assert lags["min_s"] == pytest.approx(7.25 - 1e-5 - 6.5)
    assert lags["median_s"] == pytest.approx(
        (3.25 - 1e-5 - 1.8 + 7.25 - 1e-5 - 6.5) / 2)
    assert "idle_gaps" not in program_spans.report(_record())


def test_innermost_names_the_chain_open_at_a_time(program):
    program(_program())
    spans = program_spans.load(_record())
    assert program_spans.innermost(spans, 1.7) == (
        "gp.fit < gp.fit < inner.search < probe < search.step")
    assert program_spans.innermost(spans, 3.1) == (
        "host.wait < inner.search < probe < search.step")
    assert program_spans.innermost(spans, 4.5) == "harness"


def test_a_wait_that_ends_before_the_device_counts_below_zero():
    spans = [("host.wait", 1.0, 1.9, None, {}), ("host.wait", 3.0, 3.5,
                                                None, {})]
    lags = program_spans.wait_lags([("k", 0.5, 2.0), ("k", 2.5, 3.0)], spans)
    assert lags == {"n": 2, "median_s": pytest.approx(0.2),
                    "min_s": pytest.approx(-0.1), "below_zero": 1}
    assert program_spans.wait_lags([("k", 5.0, 6.0)], spans) is None


def test_the_report_is_none_where_the_spans_do_not_align(program):
    program(_program()[:6])
    assert program_spans.report(_record()) is None
