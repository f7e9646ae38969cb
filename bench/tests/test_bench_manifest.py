"""The benchmark's manifest and its files: every piece found by name, the
names and units of the contract, each metric's `moves`, the result line's
keys, and the check that no run loaded JAX or the JAX package.

    PYTHONPATH=src python -m pytest -q bench/tests
"""

from __future__ import annotations

import json
import re
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT / "src")]

import harness  # noqa: E402
from reference import check  # noqa: E402

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")
LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_manifest_keys_and_limits():
    assert list(MANIFEST) == ["command", "paths", "run_seconds", "configs",
                              "workloads", "end_to_end", "per_layer"]
    assert MANIFEST["command"][:2] == ["python3", "bench/run.py"]
    assert all(PATH.fullmatch(p) and (ROOT / p).is_dir()
               for p in MANIFEST["paths"])
    assert 1 <= MANIFEST["run_seconds"] <= 51
    cells = len(MANIFEST["workloads"])
    # A full check of 24 cells fits a check's 43,200 seconds.
    worst = (2 + 14 * 24) * (MANIFEST["run_seconds"] + 60) + 24 * 180 + 1200
    assert worst <= 43200 and 1 <= cells <= 24
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_names_are_unique_and_allowed(group):
    names = [e["name"] for e in MANIFEST[group]]
    assert len(set(names)) == len(names)
    assert all(NAME.fullmatch(n) for n in names)
    for e in MANIFEST[group]:
        for key in ("why", "layer", "source"):
            if key in e and not e[key].startswith("http"):
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]
                assert "\t" not in e[key]
        if "unit" in e:
            assert UNIT.fullmatch(e["unit"])
            assert e["better"] in ("lower", "higher")


@pytest.mark.parametrize("cell", MANIFEST["workloads"],
                         ids=lambda c: c["name"])
def test_each_cell_finds_its_files(cell):
    _, config, traffic = harness.load_cell(cell["name"])
    assert config["name"] == cell["config"]
    assert traffic["name"] == cell["traffic"]
    assert cell["chips"] in (1, 4) and len(cell["why"]) <= 200
    for metric in MANIFEST["per_layer"]:
        if cell["name"] in metric.get("workloads", [cell["name"]]):
            assert callable(harness.load_reader(metric["name"]))
    cfg = harness.codesign_config(config, traffic, 7, "cpu")
    assert cfg.hw.num_pes == config["budget"]["num_pes"]


@pytest.mark.parametrize("entry", MANIFEST["configs"],
                         ids=lambda c: c["name"])
def test_config_files_match_their_entries(entry):
    path = ROOT / entry["file"]
    assert path.is_relative_to(BENCH) and path.name == f"{entry['name']}.json"
    config = json.loads(path.read_text())
    assert config["source"] == entry["source"]
    assert config["reduced"] == entry["reduced"] == []
    assert config["dtype"] == "float64"
    assert any(w["config"] == entry["name"] for w in MANIFEST["workloads"])


def test_configs_are_the_papers_layers():
    from repro_torch.timeloop.arch import HardwareConfig
    from repro_torch.timeloop.workloads import MODEL_LAYERS

    for name in ("resnet", "dqn"):
        config = json.loads((BENCH / "configs" / f"{name}.json").read_text())
        assert harness.layers_of(config) == MODEL_LAYERS[name]
        hw = HardwareConfig(num_pes=config["budget"]["num_pes"])
        budget = config["budget"]
        assert (hw.lb_budget, hw.gb_entries, hw.dram_bandwidth) == (
            budget["lb_budget"], budget["gb_entries"],
            budget["dram_bandwidth"])
        e = hw.energy
        assert budget["energy"] == {"mac": e.mac, "lb": e.lb, "noc": e.noc,
                                    "gb": e.gb, "dram": e.dram}


@pytest.mark.parametrize("metric", MANIFEST["per_layer"],
                         ids=lambda m: m["name"])
def test_each_metric_moves_an_end_to_end_metric_its_cells_report(metric):
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert metric["moves"] in e2e
    cells = {w["name"] for w in MANIFEST["workloads"]}
    for cell in metric.get("workloads", sorted(cells)):
        assert cell in cells
        assert cell in e2e[metric["moves"]].get("workloads", [cell])
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")
    assert 1 <= len(metric["layer"]) <= 200


def test_every_cell_reports_setup_and_another_end_to_end_metric():
    for cell in MANIFEST["workloads"]:
        names = [n for n, _ in harness.metric_names(cell["name"], False)]
        assert "setup_s" in names and len(names) >= 2
        assert harness.metric_names(cell["name"], True)
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("loaded, found", [
    (["repro_torch", "repro_torch.core"], []),
    (["repro"], ["repro"]),
    (["repro.core"], ["repro.core"]),
    (["jax.numpy"], ["jax.numpy"]),
    (["jaxlib"], ["jaxlib"]),
    (["flax.linen"], ["flax.linen"]),
    (["jaxtyping", "reproducible"], []),
])
def test_forbidden_modules_compares_whole_top_level_names(monkeypatch,
                                                          loaded, found):
    for name in loaded:
        monkeypatch.setitem(sys.modules, name, object())
    assert [n for n in harness.forbidden_modules() if n in loaded] == found


@pytest.mark.parametrize("seed", [7, 3141598301, 2**31 + 5])
def test_every_seed_searches_the_same_set_in_its_own_order(seed):
    import itertools

    first, _ = harness.search_seeds(11)
    fixed = set(itertools.islice(first, harness.SEARCHES))
    seeds, warm = harness.search_seeds(seed)
    drawn = list(itertools.islice(seeds, 3 * harness.SEARCHES))
    passes = [drawn[i:i + harness.SEARCHES]
              for i in range(0, len(drawn), harness.SEARCHES)]
    assert all(sorted(p) == sorted(fixed) for p in passes)
    assert len(fixed) == harness.SEARCHES and warm not in fixed
    again, warm_again = harness.search_seeds(seed)
    assert list(itertools.islice(again, len(drawn))) == drawn
    assert warm_again == warm


def test_seeds_draw_different_orders():
    import itertools

    orders = {tuple(itertools.islice(harness.search_seeds(s)[0],
                                     harness.SEARCHES)) for s in range(20)}
    assert len(orders) > 1


def _tiny(traffic: dict) -> dict:
    t = json.loads(json.dumps(traffic))
    t["search"]["sw"].update(n_trials=8, n_warmup=4, pool_size=16)
    t["search"]["hw"].update(n_trials=5, n_warmup=2, pool_size=8)
    return t


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_has_the_contracts_keys(trace):
    import torch

    torch.set_num_threads(2)
    cell, config, traffic = harness.load_cell("dqn.speculative")
    out = harness.run_cell(cell["name"], config, _tiny(traffic), 2**31 + 5,
                           0.5, trace, device="cpu")
    line = out["line"]
    assert list(line) == LINE_KEYS + ["check"]
    assert line["correct"] is True and line["attempted"] >= 1
    assert list(line["check"]) == list(check.LIMITS)
    want = {n for n, _ in harness.metric_names(cell["name"], trace)}
    # A CPU run opens no profiler: no device trace, and the program records
    # no spans, so only the hooks' metrics have something to read.
    unread = {m["name"] for m in MANIFEST["per_layer"]
              if m["source"] == "device_trace"
              or "import program_spans" in (
                  BENCH / "metrics" / f"{m['name']}.py").read_text()}
    assert set(line["metrics"]) == want - unread
    if trace:
        assert line["metrics"]
    assert out["info"]["probes"] == line["attempted"]
    assert harness.forbidden_modules() == []
