"""The port's lockstep multi-run search (`bo_maximize_many` through
`optimize_software_many`: `LayerStackSpace`, `GPStack`) against per-layer
`optimize_software` searches, on both port backends, on the CPU (after
`tests/test_layer_batch.py`).

Budgets stay inside the stacked fit's Cholesky regime (<= 32 data rows),
where lockstep == sequential exactly.  Bar: identical best mappings, values
and histories for every layer of all four workloads.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import optimize_software, optimize_software_many
from repro_torch.timeloop import MODEL_LAYERS, eyeriss_168

MODELS = ("resnet", "dqn", "mlp", "transformer")
KW = dict(n_trials=14, n_warmup=6, pool_size=20, seed=3)
DEV = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the GP's matrices are tiny, and test workers run
    side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("backend", ["numpy", "torch"])
@pytest.mark.parametrize("model", MODELS)
def test_layer_batched_matches_sequential(model, backend):
    hw = eyeriss_168()
    layers = MODEL_LAYERS[model]
    seq = [optimize_software(hw, ly, backend=backend, device=DEV, **KW)
           for ly in layers]
    many = optimize_software_many(hw, layers, backend=backend, device=DEV,
                                  **KW)
    assert len(many) == len(layers)
    for rs, rm in zip(seq, many):
        assert rm.best_point == rs.best_point
        assert np.array_equal(rm.history, rs.history)
        assert rm.values == rs.values
