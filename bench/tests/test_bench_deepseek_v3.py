"""The `deepseek_v3` configuration and the sampler's two metrics:

  * the configuration's layers and counts are the port's registry set
    (`resolve_workload("deepseek-v3")`), its budget `HardwareConfig(
    num_pes=256)`'s, and its published keys the registry's;
  * `inner.draws_per_kept` and `inner.sample_ms_per_pool` on synthetic
    records: their values, the cost model's spans inside the sampling left
    out of its time, and None where the spans carry no counters (a program
    that records none).

    PYTHONPATH=src python -m pytest -q bench/tests
"""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT / "src")]

import harness  # noqa: E402
from repro_torch import trace  # noqa: E402

CONFIG = json.loads((BENCH / "configs" / "deepseek_v3.json").read_text())
T0 = 1000.0


def test_the_layers_are_the_registrys_decode_set():
    from repro_torch.workloads import resolve_workload
    from repro_torch.workloads.mla_decode import decode_set

    assert harness.layers_of(CONFIG) == resolve_workload("deepseek-v3")
    assert ([ly["count"] for ly in CONFIG["layers"]]
            == list(decode_set("deepseek_v3").counts))


def test_the_budget_is_the_papers_256_pe_budget():
    from repro_torch.timeloop.arch import HardwareConfig

    hw = HardwareConfig(num_pes=256)
    e = hw.energy
    assert CONFIG["budget"] == {
        "num_pes": 256, "lb_budget": hw.lb_budget,
        "gb_entries": hw.gb_entries, "dram_bandwidth": hw.dram_bandwidth,
        "energy": {"mac": e.mac, "lb": e.lb, "noc": e.noc, "gb": e.gb,
                   "dram": e.dram}}


def test_the_published_keys_are_the_registrys():
    from repro_torch.workloads.mla_decode import DECODE_32K, DEEPSEEK_V3, SOURCE

    assert CONFIG["source"] == SOURCE
    for key, value in dataclasses.asdict(DEEPSEEK_V3).items():
        assert CONFIG[key] == value, key
    assert {k: CONFIG["assumed"][k] for k in ("batch", "context",
                                              "tokens_per_expert")} \
        == dataclasses.asdict(DECODE_32K)


# --- the sampler's metrics -----------------------------------------------------

def _ns(t: float) -> int:
    return round((T0 + t) * 1e9)


def _program(samples, forward_s=0.0):
    """One step holding `inner.sample` spans of the given attributes, each
    0.5 s long, each with a `cost_model.forward` of `forward_s` inside."""
    out = [("search.step", _ns(1.0), _ns(9.0), None, {"seed": 7})]
    for i, attrs in enumerate(samples):
        t = 1.5 + i
        out.append(("inner.sample", _ns(t), _ns(t + 0.5), 0, dict(attrs)))
        if forward_s:
            out.append(("cost_model.forward", _ns(t + 0.1),
                        _ns(t + 0.1 + forward_s), len(out) - 1,
                        {"rows": 64}))
    return out


def _record():
    return {"window_s": 10.0, "probes": 1,
            "spans": {"outer": [("SearchSession.step", 1.0, 9.0)]},
            "missing": {}, "device": None}


@pytest.fixture
def program(monkeypatch):
    def use(spans):
        monkeypatch.setattr(trace, "spans", lambda: list(spans))
    return use


def test_draws_per_kept_and_ms_per_pool(program):
    program(_program([{"pools": 4, "drawn": 40, "kept": 16},
                      {"pools": 4, "drawn": 200, "kept": 80}]))
    assert harness.load_reader("inner.draws_per_kept")(_record()) \
        == pytest.approx(240 / 96)
    assert harness.load_reader("inner.sample_ms_per_pool")(_record()) \
        == pytest.approx(1e3 * 1.0 / 8)


def test_ms_per_pool_leaves_out_the_cost_model(program):
    program(_program([{"pools": 4, "drawn": 40, "kept": 16},
                      {"pools": 4, "drawn": 200, "kept": 80}],
                     forward_s=0.2))
    assert harness.load_reader("inner.sample_ms_per_pool")(_record()) \
        == pytest.approx(1e3 * (1.0 - 2 * 0.2) / 8)
    assert harness.load_reader("inner.draws_per_kept")(_record()) \
        == pytest.approx(240 / 96)


@pytest.mark.parametrize("name", ["inner.draws_per_kept",
                                  "inner.sample_ms_per_pool"])
@pytest.mark.parametrize("samples", [[], [{}, {}]])
def test_none_without_the_counters(program, name, samples):
    program(_program(samples))
    assert harness.load_reader(name)(_record()) is None
