"""The paper's baselines on the port (`repro_torch.core.baselines`), on the
CPU, against the reference's (`repro.core.baselines`) run in a subprocess
(`tests/torch_port_reference.py`) on the same layers, budgets and seeds.

  * constrained random search, the TVM-style learned search (gradient-
    boosted trees) and relax-and-round BO (SE GP: the port's torch GP
    against the reference's jax GP) visit the same points in the same order
    and return the same best mapping;
  * their values and best-so-far histories agree within 1e-12 relative in
    EDP (the port evaluates through the space's batched protocol -- kernel
    K1b's plain version on backend="torch", the host engine on "numpy" --
    where the reference calls the scalar cost model);
  * on backend="torch" every evaluation goes through `cost_forward`, once a
    point (and once a TVM candidate pool).

Bars: identical points and best mappings; EDP 1e-12 relative.
"""

import json

import numpy as np
import pytest
import torch

from torch_port_reference import run_reference

from repro_torch.core import (SoftwareSpace, random_search, relax_round_bo,
                              tvm_style_search)
from repro_torch.timeloop import MODEL_LAYERS, eyeriss_168
from repro_torch.timeloop import batch_torch

BASELINES = {"random_search": random_search,
             "tvm_style_search": tvm_style_search,
             "relax_round_bo": relax_round_bo}
# (baseline, (model, layer index), kwargs); seeds 0 and 1 on ResNet's first
# paper layer (chip_smoke.py's) and on a DQN layer.
CASES = [
    ("random_search", ("resnet", 0), {"n_trials": 60, "seed": 0}),
    ("random_search", ("dqn", 1), {"n_trials": 60, "seed": 1}),
    ("tvm_style_search", ("resnet", 0),
     {"n_trials": 40, "n_warmup": 10, "pool_size": 40, "seed": 0}),
    ("tvm_style_search", ("dqn", 1),
     {"n_trials": 40, "n_warmup": 10, "pool_size": 40, "seed": 1}),
    ("relax_round_bo", ("resnet", 0),
     {"n_trials": 24, "n_warmup": 10, "pool_size": 50, "seed": 0}),
    ("relax_round_bo", ("dqn", 1),
     {"n_trials": 24, "n_warmup": 10, "pool_size": 50, "seed": 1}),
]


def _name(i: int) -> str:
    return f"case{i}"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the GP's matrices are tiny, and test workers run
    side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    spec = {"task": "baselines", "cases": [
        {"name": _name(i), "baseline": b, "layer": list(layer),
         "kwargs": kw} for i, (b, layer, kw) in enumerate(CASES)]}
    return run_reference(spec, {}, tmp_path_factory.mktemp("ref_baselines"))


def _mapping_tuple(m) -> list:
    return [[[int(f) for f in level] for level in m.factors],
            list(m.order_lb), list(m.order_gb), list(m.order_dram)]


def _edps(values) -> np.ndarray:
    """-log10(EDP) values back to EDPs (inf where infeasible)."""
    return 10.0 ** -np.asarray(values, np.float64)


@pytest.mark.parametrize("backend", ["torch", "numpy"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_baseline_matches_reference(reference, case, backend):
    baseline, (model, li), kwargs = CASES[case]
    name = _name(case)
    space = SoftwareSpace(eyeriss_168(), MODEL_LAYERS[model][li],
                          backend=backend, device="cpu")
    calls = []
    inner = batch_torch.cost_forward

    def tally(*ops):
        calls.append(ops[0].shape[0])
        return inner(*ops)

    batch_torch.cost_forward = tally
    try:
        res = BASELINES[baseline](space, **kwargs)
    finally:
        batch_torch.cost_forward = inner
    want_points = json.loads(str(reference[name + "_points"]))
    assert [_mapping_tuple(p) for p in res.points] == want_points
    assert _mapping_tuple(res.best_point) == json.loads(
        str(reference[name + "_best"]))
    assert res.n_infeasible == int(reference[name + "_n_infeasible"])
    np.testing.assert_allclose(_edps(res.values),
                               _edps(reference[name + "_values"]),
                               rtol=1e-12, atol=0)
    np.testing.assert_allclose(_edps(res.history),
                               _edps(reference[name + "_history"]),
                               rtol=1e-12, atol=0)
    # On the torch engine every evaluation is one forward (of one row, in
    # the engine's smallest bucket); TVM's candidate pools add one forward
    # each, of a larger bucket.
    n = kwargs["n_trials"]
    if backend == "numpy":
        assert calls == []
    else:
        assert calls.count(min(calls)) == n
        assert len(calls) == n or baseline == "tvm_style_search"
