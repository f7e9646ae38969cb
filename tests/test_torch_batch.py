"""The port's device cost-model engine (`repro_torch.timeloop.batch_torch`)
against the JAX reference engine (`repro.timeloop.batch_jax`), and against the
port's own NumPy host engine (`repro_torch.timeloop.batch`).

Inputs: 200-mapping candidate pools of all four paper workloads, sampled with
numpy from fixed seeds, scored on random hardware configurations (so the
masks mix valid and invalid rows).  The reference runs in a subprocess
(`tests/torch_port_reference.py`), once for the whole module.

Bars: masks exact; float64 within 1e-12 relative; float32 within 1e-6.
"""

import dataclasses

import numpy as np
import pytest

from torch_port_reference import run_reference

from repro_torch.timeloop import MODEL_LAYERS, eyeriss_168
from repro_torch.timeloop import batch as tlb
from repro_torch.timeloop import batch_torch as ttlb
from repro_torch.timeloop.arch import sample_hardware_pool
from repro_torch.timeloop.bounds import edp_lower_bounds

MODELS = ("resnet", "dqn", "mlp", "transformer")
DTYPES = ("float64", "float32")
BARS = {"float64": 1e-12, "float32": 1e-6}
KEYS = ("valid", "energy_pj", "delay_cycles", "edp", "utility", "features")


def _num_pes(model):
    return 256 if model == "transformer" else 168


def _setup():
    """Pools, hardware and the case list shared by both packages."""
    rng = np.random.default_rng(5)
    arrays, cases, local = {}, [], {}
    for m in MODELS:
        layers = MODEL_LAYERS[m]
        base = eyeriss_168() if _num_pes(m) == 168 else dataclasses.replace(
            eyeriss_168(), num_pes=256, pe_mesh_x=16, pe_mesh_y=16)
        hws = [base] + sample_hardware_pool(rng, 3, num_pes=_num_pes(m))
        pools = [tlb.sample_valid_pool(rng, base, ly, 200) for ly in layers]
        for i, p in enumerate(pools):
            key = f"{m}{i}"
            arrays[key + "_factors"] = p.factors
            arrays[key + "_order_gb"] = p.order_gb
            arrays[key + "_order_dram"] = p.order_dram
        keys = [f"{m}{i}" for i in range(len(layers))]
        refs = [[m, i] for i in range(len(layers))]
        local[m] = (hws, layers, pools)
        for dt in DTYPES:
            # one pool on random hardware (masks mix valid and invalid rows)
            cases.append({"name": f"{m}_fwd_{dt}", "kind": "forward",
                          "dtype": dt, "hw": [dataclasses.astuple(hws[1])],
                          "layers": refs[:1], "pools": keys[:1]})
            # per-layer stack: every layer of the workload on one hw
            cases.append({"name": f"{m}_stk_{dt}", "kind": "stacked",
                          "dtype": dt, "hw": [dataclasses.astuple(hws[0])],
                          "layers": refs, "pools": keys})
            # per-probe stack: each run on its own hardware probe
            probe_hws = [hws[i % len(hws)] for i in range(len(layers))]
            cases.append({"name": f"{m}_prb_{dt}", "kind": "stacked",
                          "dtype": dt,
                          "hw": [dataclasses.astuple(h) for h in probe_hws],
                          "layers": refs, "pools": keys})
            cases.append({"name": f"{m}_lb_{dt}", "kind": "bounds",
                          "dtype": dt,
                          "hw": [dataclasses.astuple(h) for h in hws],
                          "layers": refs})
    return arrays, cases, local


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    arrays, cases, local = _setup()
    ref = run_reference({"task": "batch", "cases": cases}, arrays,
                        tmp_path_factory.mktemp("ref_batch"))
    return ref, {c["name"]: c for c in cases}, local


def _assert_engine_close(got, ref, dtype):
    np.testing.assert_array_equal(got["valid"], ref["valid"])
    for k in KEYS[1:]:
        np.testing.assert_allclose(got[k], ref[k], rtol=BARS[dtype], atol=0,
                                   err_msg=k)


def _port(case, local):
    m = case["name"].split("_")[0]
    hws, layers, pools = local[m]
    dt = case["dtype"]
    if case["kind"] == "forward":
        out = ttlb.forward_device(hws[1], pools[0], layers[0], dtype=dt,
                                  device="cpu")
    else:
        hw = hws[0] if len(case["hw"]) == 1 else [
            hws[i % len(hws)] for i in range(len(layers))]
        out = ttlb.forward_device_stacked(hw, pools, layers, dtype=dt,
                                          device="cpu")
    return {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["fwd", "stk", "prb"])
@pytest.mark.parametrize("model", MODELS)
def test_forward_matches_reference(parity, model, kind, dtype):
    ref, cases, local = parity
    case = cases[f"{model}_{kind}_{dtype}"]
    got = _port(case, local)
    want = {k: ref[f"{case['name']}_{k}"] for k in KEYS}
    for k in KEYS:
        assert got[k].shape == want[k].shape, k
    _assert_engine_close(got, want, dtype)
    if kind != "fwd":
        # padding rows past a pool's length are invalid, -inf utility
        assert np.isfinite(got["utility"][got["valid"]]).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("model", MODELS)
def test_lower_bounds_match_reference(parity, model, dtype):
    ref, cases, local = parity
    hws, layers, _ = local[model]
    got = ttlb.edp_lower_bounds_device(hws, layers, dtype=dtype, device="cpu")
    want = ref[f"{model}_lb_{dtype}_lb"]
    assert got.shape == (len(hws), len(layers))
    np.testing.assert_allclose(got, want, rtol=BARS[dtype], atol=0)
    np.testing.assert_allclose(
        got, edp_lower_bounds(hws, layers), rtol=BARS[dtype], atol=0)


@pytest.mark.parametrize("model", MODELS)
def test_device_engine_matches_host_engine(model):
    """batch_torch on the CPU against the port's copy of the NumPy engine:
    the host twins (`valid_batch` / `evaluate_batch` / `features_batch`)."""
    rng = np.random.default_rng(9)
    hw = sample_hardware_pool(rng, 1, num_pes=_num_pes(model))[0]
    for layer in MODEL_LAYERS[model]:
        base = eyeriss_168()
        pool = tlb.sample_valid_pool(rng, base, layer, 200)
        for h in (base, hw):
            np.testing.assert_array_equal(
                ttlb.valid_batch(pool, h, layer, device="cpu"),
                tlb.valid_batch(pool, h, layer))
            got = ttlb.evaluate_batch(h, pool, layer, device="cpu")
            want = tlb.evaluate_batch(h, pool, layer)
            v = want["valid"]
            np.testing.assert_array_equal(got["valid"], v)
            for k in ("energy_pj", "delay_cycles", "edp"):
                np.testing.assert_allclose(got[k][v], want[k][v], rtol=1e-12,
                                           atol=0, err_msg=k)
            np.testing.assert_allclose(
                ttlb.features_batch(pool, h, layer, device="cpu"),
                tlb.features_batch(pool, h, layer), rtol=1e-12, atol=0)


def test_empty_pool_and_padding():
    hw, layer = eyeriss_168(), MODEL_LAYERS["dqn"][0]
    empty = tlb.sample_valid_pool(np.random.default_rng(0), hw, layer, 4).take(
        np.arange(0))
    out = ttlb.forward_device(hw, empty, layer, device="cpu")
    assert out["features"].shape == (0, 14)
    pool = tlb.sample_valid_pool(np.random.default_rng(1), hw, layer, 5)
    out = ttlb.forward_device_stacked(hw, [pool, empty], [layer, layer],
                                      device="cpu")
    assert out["valid"].shape == (2, 5)
    assert not out["valid"][1].any()
    assert (out["utility"][1] == -np.inf).all()
