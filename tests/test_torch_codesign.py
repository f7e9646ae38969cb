"""The port's nested co-design search end to end (`repro_torch.core`), at the
golden budgets of `tests/test_golden.py`, on the CPU.

  (a) backend="numpy" (host engine, torch GP) reproduces
      `tests/goldens/codesign.json` -- design hash and log10 EDP -- for all
      four workloads under the sequential and the layer-batched strategies;
  (b) backend="torch" (device engine, kernel K1's plain version on the CPU)
      gives the same design, log10 EDP and outer history as the JAX
      reference's backend="jax", run in a subprocess
      (`tests/torch_port_reference.py`); the reference's design, carried
      over as plain tuples (`repro_torch.convert`), equals the port's and
      scores the same per-layer EDPs in the port's cost model;
  (c) the lockstep multi-run search against per-layer searches lives in
      `tests/test_torch_layer_batch.py` (its own file, so the two spread
      over test workers).

Bars: exact hash and log10 EDP; identical outer histories.
"""

import dataclasses
import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_port_reference import run_reference

from repro_torch.convert import hardware_from_tuple, mapping_from_tuple
from repro_torch.core import (CodesignConfig, CodesignEngine, EngineConfig,
                              HWSearchConfig, SWSearchConfig)
from repro_torch.timeloop import MODEL_LAYERS, evaluate

GOLDEN_PATH = Path(__file__).parent / "goldens" / "codesign.json"
MODELS = ("resnet", "dqn", "mlp", "transformer")
DEV = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the GP's matrices are tiny, and test workers run
    side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _num_pes(model: str) -> int:
    return 256 if model == "transformer" else 168


def _config(model: str, **engine) -> CodesignConfig:
    """`tests/test_golden.py:_config` on the port, with the engine fields
    given (the device is the CPU)."""
    return CodesignConfig(
        sw=SWSearchConfig(n_trials=10, n_warmup=5, pool_size=15),
        hw=HWSearchConfig(n_trials=3, n_warmup=2, pool_size=12,
                          num_pes=_num_pes(model)),
        engine=EngineConfig(device=DEV, **engine),
        seed=0,
    )


def _canonical(result) -> str:
    hw = dataclasses.astuple(result.best_hw)
    maps = sorted(
        (name, dataclasses.astuple(m)) for name, m in result.best_mappings.items())
    return repr((hw, maps))


def _run(model: str, **engine) -> tuple[dict, object]:
    result = CodesignEngine(_config(model, **engine)).run(MODEL_LAYERS[model])
    return {
        "design_sha256": hashlib.sha256(_canonical(result).encode()).hexdigest(),
        "best_log10_edp": round(float(np.log10(result.best_model_edp)), 6),
        "n_trials": len(result.hw_result.history),
    }, result


@pytest.mark.e2e
@pytest.mark.parametrize("strategy", ["sequential", "layer_batched"])
@pytest.mark.parametrize("model", MODELS)
def test_numpy_backend_reproduces_goldens(model, strategy):
    goldens = json.loads(GOLDEN_PATH.read_text())
    got, _ = _run(model, backend="numpy", strategy=strategy)
    assert got == goldens[model]


@pytest.fixture(scope="module")
def reference_jax(tmp_path_factory):
    cfg = _config("resnet", backend="numpy").to_dict()
    cfg["engine"] = {"backend": "jax"}
    spec = {"task": "codesign", "models": list(MODELS), "config": cfg,
            "num_pes": {m: _num_pes(m) for m in MODELS}}
    return run_reference(spec, {}, tmp_path_factory.mktemp("ref_codesign"))


@pytest.mark.e2e
@pytest.mark.parametrize("model", MODELS)
def test_torch_backend_matches_reference_jax_backend(reference_jax, model):
    got, result = _run(model, backend="torch")
    ref = reference_jax
    assert got["design_sha256"] == str(ref[model + "_sha256"])
    assert np.log10(result.best_model_edp) == float(ref[model + "_log10_edp"])
    np.testing.assert_array_equal(result.hw_result.history,
                                  ref[model + "_history"])
    design = json.loads(str(ref[model + "_design"]))
    hw = hardware_from_tuple(design["hw"])
    maps = {n: mapping_from_tuple(t) for n, t in design["maps"].items()}
    assert hw == result.best_hw
    assert maps == result.best_mappings
    for layer in MODEL_LAYERS[model]:
        assert evaluate(hw, maps[layer.name], layer).edp == pytest.approx(
            design["layer_edps"][layer.name], rel=1e-12)
