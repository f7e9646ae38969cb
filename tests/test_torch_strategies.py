"""The port's outer-loop machinery beyond the default path, on the CPU:

  * the probe strategies `probe_fanout` and `speculative` are bit-identical to
    `sequential` (same best hardware, mappings, outer history and points) on
    both port backends -- content-derived probe seeds make evaluation order
    free (after `tests/test_speculative.py`, whose budgets keep every stacked
    GP fit in the Cholesky regime);
  * the bound gate `prune="safe"` reproduces `tests/goldens/codesign.json`
    on both backends (after `tests/test_prune.py`);
  * the warm-start prior plumbing: an empty prior is the cold run, and a
    prior of recorded trial rows with the bound prior mean -- the EDP lower
    bounds, through `batch_torch.edp_lower_bounds_device` on the torch
    backend -- is consumed identically by both backends (after
    `tests/test_transfer.py`).
"""

import dataclasses
import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import (CodesignConfig, CodesignEngine, EngineConfig,
                              HWSearchConfig, SWSearchConfig)
from repro_torch.timeloop import MODEL_LAYERS

GOLDEN_PATH = Path(__file__).parent / "goldens" / "codesign.json"
DEV = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the GP's matrices are tiny, and test workers run
    side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spec_config(strategy, backend, **hw) -> CodesignConfig:
    # 2 warmup probes (the fan-out path) + scored trials (the speculative
    # path); sw n_trials=12 keeps every stacked GP fit in the Cholesky regime.
    return CodesignConfig(
        sw=SWSearchConfig(n_trials=12, n_warmup=6, pool_size=20),
        hw=HWSearchConfig(n_trials=4, n_warmup=2, pool_size=20, spec_k=3,
                          **hw),
        engine=EngineConfig(backend=backend, strategy=strategy, device=DEV))


def _assert_identical(a, b):
    assert a.best_hw == b.best_hw
    assert a.best_model_edp == b.best_model_edp
    assert a.best_mappings == b.best_mappings
    assert np.array_equal(a.hw_result.history, b.hw_result.history)
    assert a.hw_result.points == b.hw_result.points


@pytest.mark.parametrize("backend", ["numpy", "torch"])
@pytest.mark.parametrize("model", ["dqn"])
def test_fanout_strategies_bit_identical_to_sequential(model, backend):
    layers = MODEL_LAYERS[model]
    seq = CodesignEngine(_spec_config("sequential", backend)).run(layers)
    for strategy in ("probe_fanout", "speculative"):
        eng = CodesignEngine(_spec_config(strategy, backend))
        assert eng.strategy_name == strategy
        _assert_identical(eng.run(layers), seq)


def _golden_config(model, backend, **hw) -> CodesignConfig:
    return CodesignConfig(
        sw=SWSearchConfig(n_trials=10, n_warmup=5, pool_size=15),
        hw=HWSearchConfig(n_trials=3, n_warmup=2, pool_size=12,
                          num_pes=256 if model == "transformer" else 168,
                          **hw),
        engine=EngineConfig(backend=backend, device=DEV),
        seed=0)


def _golden_record(result) -> dict:
    hw = dataclasses.astuple(result.best_hw)
    maps = sorted((n, dataclasses.astuple(m))
                  for n, m in result.best_mappings.items())
    return {
        "design_sha256": hashlib.sha256(repr((hw, maps)).encode()).hexdigest(),
        "best_log10_edp": round(float(np.log10(result.best_model_edp)), 6),
        "n_trials": len(result.hw_result.history),
    }


@pytest.mark.parametrize("backend", ["numpy", "torch"])
@pytest.mark.parametrize("model", ["dqn", "mlp"])
def test_prune_safe_reproduces_goldens(model, backend):
    goldens = json.loads(GOLDEN_PATH.read_text())
    result = CodesignEngine(_golden_config(model, backend, prune="safe")).run(
        MODEL_LAYERS[model])
    assert _golden_record(result) == goldens[model]


def test_warm_start_prior_plumbing():
    layers = MODEL_LAYERS["dqn"]
    rows: list[dict] = []
    cold_cfg = _golden_config("dqn", "numpy")
    eng = CodesignEngine(cold_cfg)
    session = eng.session(layers, trial_log=rows.append)
    while session.step():
        pass
    cold = session.result()
    assert rows and all(set(r) == {"hw", "features", "utility", "feasible"}
                        for r in rows)

    # an empty prior is exactly the cold run
    eng = CodesignEngine(cold_cfg)
    empty = eng.session(layers, prior=[])
    while empty.step():
        pass
    _assert_identical(empty.result(), cold)

    # recorded rows + the bound prior mean: same run on both backends
    results = {}
    for backend in ("numpy", "torch"):
        cfg = _golden_config("dqn", backend, warm_start_bound_mean=True)
        warm = CodesignEngine(cfg).session(layers, prior=rows)
        while warm.step():
            pass
        results[backend] = warm.result()
        assert results[backend].stats["prior_rows"] == len(rows)
    _assert_identical(results["torch"], results["numpy"])
