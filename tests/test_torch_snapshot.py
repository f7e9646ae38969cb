"""`SearchSession` snapshots across the packages
(`repro_torch.convert.session_snapshot_from_reference` /
`session_snapshot_to_reference`).

A search is taken half-way by one package -- the outer loop's warm-up block
of the golden budgets (`tests/test_golden.py`) -- snapshotted, carried over
as a plain image (tuples, lists, numpy arrays, the numpy RNG state) and
finished by the other; the reference runs in a subprocess
(`tests/torch_port_reference.py`, task "session"):

  * reference -> port and port -> reference on backend "numpy": the design
    hash and log10 EDP equal `tests/goldens/codesign.json`;
  * reference "jax" -> port "torch" and port "torch" -> reference "jax":
    the design hash, log10 EDP and outer history equal the reference's
    uninterrupted jax run;
  * a portfolio session's snapshot through the plain image and back into
    the port finishes as the uninterrupted portfolio search.

Bars: exact.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_port_reference import pack, run_reference, unpack

from repro_torch import convert
from repro_torch.core import (CodesignConfig, CodesignEngine, EngineConfig,
                              HWSearchConfig, SWSearchConfig)
from repro_torch.timeloop import MODEL_LAYERS
from repro_torch.workloads import PortfolioConfig, portfolio_session

GOLDEN_PATH = Path(__file__).parent / "goldens" / "codesign.json"
MODELS = ("dqn", "mlp")
BACKENDS = {"numpy": "numpy", "torch": "jax"}   # port -> reference
HALF = 1     # steps taken before the snapshot: the outer warm-up block


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(model: str, backend: str) -> CodesignConfig:
    """The golden config (`tests/test_torch_codesign.py:_config`) on the
    CPU with the port's `backend`."""
    return CodesignConfig(
        sw=SWSearchConfig(n_trials=10, n_warmup=5, pool_size=15),
        hw=HWSearchConfig(n_trials=3, n_warmup=2, pool_size=12,
                          num_pes=256 if model == "transformer" else 168),
        engine=EngineConfig(device="cpu", backend=backend), seed=0)


def _reference_config(model: str, backend: str) -> dict:
    d = _config(model, "numpy").to_dict()
    d["engine"] = {"backend": BACKENDS[backend]}
    return d


def _summary(result) -> dict:
    hw = dataclasses.astuple(result.best_hw)
    maps = sorted((n, dataclasses.astuple(m))
                  for n, m in result.best_mappings.items())
    return {"sha256": hashlib.sha256(repr((hw, maps)).encode()).hexdigest(),
            "log10_edp": float(np.log10(result.best_model_edp)),
            "history": np.asarray(result.hw_result.history)}


def _reference_summary(out: dict, name: str) -> dict:
    return {"sha256": str(out[name + "_sha256"]),
            "log10_edp": float(out[name + "_log10_edp"]),
            "history": out[name + "_history"]}


def _check(got: dict, model: str, backend: str, reference_run: dict):
    if backend == "numpy":
        golden = json.loads(GOLDEN_PATH.read_text())[model]
        assert got["sha256"] == golden["design_sha256"]
        assert round(got["log10_edp"], 6) == golden["best_log10_edp"]
        assert len(got["history"]) == golden["n_trials"]
    # the reference's uninterrupted run, on either backend
    assert got["sha256"] == reference_run["sha256"]
    assert got["log10_edp"] == reference_run["log10_edp"]
    np.testing.assert_array_equal(got["history"], reference_run["history"])


CASES = [(m, b) for m in MODELS for b in BACKENDS]


@pytest.fixture(scope="module")
def reference_half(tmp_path_factory):
    """The reference taken half-way on every case, with its uninterrupted
    runs."""
    cases = [{"name": f"{m}_{b}", "model": m, "mode": "take", "steps": HALF,
              "config": _reference_config(m, b)} for m, b in CASES]
    return run_reference({"task": "session", "cases": cases}, {},
                         tmp_path_factory.mktemp("session_take"))


@pytest.fixture(scope="module")
def port_half_finished_by_reference(tmp_path_factory):
    """The port taken half-way on every case, finished by the reference."""
    arrays, cases = {}, []
    for m, b in CASES:
        session = CodesignEngine(_config(m, b)).session(MODEL_LAYERS[m])
        for _ in range(HALF):
            session.step()
        image = convert.session_snapshot_to_reference(session.snapshot())
        arrays[f"{m}_{b}_snapshot"] = pack(image)
        cases.append({"name": f"{m}_{b}", "model": m, "mode": "finish",
                      "config": _reference_config(m, b)})
    return run_reference({"task": "session", "cases": cases}, arrays,
                         tmp_path_factory.mktemp("session_finish"))


@pytest.mark.parametrize("model,backend", CASES)
def test_reference_snapshot_finished_by_the_port(reference_half, model,
                                                 backend):
    name = f"{model}_{backend}"
    snap = convert.session_snapshot_from_reference(
        unpack(reference_half[name + "_snapshot"]))
    session = CodesignEngine(_config(model, backend)).session(
        MODEL_LAYERS[model]).restore(snap)
    while session.step():
        pass
    _check(_summary(session.result()), model, backend,
           _reference_summary(reference_half, name))


@pytest.mark.parametrize("model,backend", CASES)
def test_port_snapshot_finished_by_the_reference(
        port_half_finished_by_reference, reference_half, model, backend):
    name = f"{model}_{backend}"
    _check(_reference_summary(port_half_finished_by_reference, name), model,
           backend, _reference_summary(reference_half, name))


def test_plain_image_round_trip_is_the_identity():
    """A port snapshot through its plain image and back equals itself,
    hardware, mappings and layers rebuilt as equal objects."""
    session = CodesignEngine(_config("dqn", "numpy")).session(
        MODEL_LAYERS["dqn"])
    session.step()
    snap = session.snapshot()
    image = convert.session_snapshot_to_reference(snap)
    back = convert.session_snapshot_from_reference(unpack(pack(image)))
    assert back["cache"] == snap["cache"] and len(back["cache"]) > 0
    assert back["best"] == snap["best"]
    assert back["speculated"] == snap["speculated"]
    for key in ("result", "elites", "observed", "window_pool"):
        assert back["loop"][key] == snap["loop"][key], key
    flat = repr(image)
    assert "HardwareConfig" not in flat and "Mapping" not in flat
    assert "ConvLayer" not in flat


def test_portfolio_snapshot_through_the_plain_image():
    cfg = dataclasses.replace(_config("dqn", "numpy"), hw=HWSearchConfig(
        n_trials=3, n_warmup=2, pool_size=12))
    pf = PortfolioConfig(workloads=("dqn", "mlp"), weights=(2.0, 1.0))
    whole = portfolio_session(pf, cfg)
    while whole.step():
        pass
    want = whole.result()
    first = portfolio_session(pf, cfg)
    first.step()
    image = convert.session_snapshot_to_reference(first.snapshot())
    resumed = portfolio_session(pf, cfg).restore(
        convert.session_snapshot_from_reference(unpack(pack(image))))
    while resumed.step():
        pass
    got = resumed.result()
    assert got.best_hw == want.best_hw
    assert got.best_model_edp == want.best_model_edp
    assert got.stats["portfolio_pareto"] == want.stats["portfolio_pareto"]
