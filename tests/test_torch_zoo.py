"""The workload zoo on the port (`repro_torch.workloads.zoo`): the MACs
cross-check against the port's `models/flops.py`, shape sanity, registry
resolution, the sampler divisor-cap guard, and every generated set held to
`tests/goldens/zoo_workloads.json` exactly (`n_layers`, `shapes_sha256`,
`total_macs`, `coverage`) -- the reference's tests/test_zoo.py, run on
`repro_torch` against the reference's own goldens."""

import dataclasses
import hashlib
import json
import warnings
from pathlib import Path

import numpy as np
import pytest

from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.models.flops import forward_flops
from repro_torch.timeloop import (MODEL_LAYERS, SAMPLER_DIVISOR_CAP, divisors,
                            eyeriss_168, sampler_divisors)
from repro_torch.timeloop.mapping import (constrained_random_mapping,
                                    mapping_is_valid,
                                    sample_constrained_batch)
from repro_torch.timeloop.workloads import _TOKENS, ConvLayer, fc
from repro_torch.workloads import (MACS_RTOL, ZOO_NAMES, known_workloads,
                             resolve_workload, workload_set, zoo_workload)
from repro_torch.workloads.zoo import ZOO_SHAPE

ZOO_GOLDEN_PATH = Path(__file__).parent / "goldens" / "zoo_workloads.json"


# --- MACs cross-check vs models/flops.py ---------------------------------------

@pytest.mark.parametrize("name", ZOO_NAMES)
def test_macs_cross_check(name):
    """2 * sum(count * macs) must equal forward_flops at the zoo tile up to
    the documented non-matmul remainder (scores+PV, elementwise gates)."""
    zw = zoo_workload(name)
    assert zw.total_macs == sum(
        c * l.macs for c, l in zip(zw.counts, zw.layers))
    flops = forward_flops(get_config(zw.arch), ZOO_SHAPE)
    assert flops == zw.model_flops
    coverage = 2.0 * zw.total_macs / flops
    assert coverage == pytest.approx(zw.coverage)
    assert 1.0 - MACS_RTOL <= coverage <= 1.0 + 1e-9, (
        f"{name}: extracted MACs cover {coverage:.4f} of forward_flops")


@pytest.mark.parametrize("name", ZOO_NAMES)
def test_shape_sanity(name):
    zw = zoo_workload(name)
    assert len(zw.layers) == len(zw.counts) > 0
    names = [l.name for l in zw.layers]
    assert len(set(names)) == len(names), "duplicate layer names"
    shapes = {(l.R, l.S, l.P, l.Q, l.C, l.K, l.stride) for l in zw.layers}
    assert len(shapes) == len(zw.layers), "duplicate shapes not merged"
    for layer, count in zip(zw.layers, zw.counts):
        assert count >= 1
        assert layer.name.startswith(zw.name + "-")
        for d in ("R", "S", "P", "Q", "C", "K"):
            assert layer.dim(d) >= 1
        assert layer.stride == 1
        assert layer.macs > 0
        # GEMM encoding: token tile on P (the encoder runs a smaller tile)
        assert layer.P in (_TOKENS, max(_TOKENS // 8, 16))
        assert layer.input_extent(layer.P, layer.R) >= layer.P


# --- registry / resolution ------------------------------------------------------

def test_workload_registry_resolution():
    assert set(ZOO_NAMES) == {
        a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}
    # paper names resolve to the exact legacy lists
    assert resolve_workload("resnet") == list(MODEL_LAYERS["resnet"])
    # zoo names resolve through the generator; dashed aliases accepted
    assert workload_set("llama4_maverick_400b_a17b") \
        == resolve_workload("llama4-maverick-400b-a17b")
    known = known_workloads()
    assert "resnet" in known and "qwen3_14b" in known
    with pytest.raises(ValueError) as ei:
        resolve_workload("nope")
    msg = str(ei.value)
    assert "resnet" in msg and "qwen3_14b" in msg


def test_zoo_workload_is_cached():
    assert zoo_workload("qwen3_14b") is zoo_workload("qwen3-14b")


# --- sampler divisor-cap guard --------------------------------------------------

def test_sampler_divisors_passthrough_below_cap():
    """Every paper and zoo dim sits under the cap: the sampler ladder is the
    exact divisor tuple (so RNG streams -- and the goldens -- are
    unchanged)."""
    dims = {layer.dim(d)
            for layers in MODEL_LAYERS.values() for layer in layers
            for d in ("R", "S", "P", "Q", "C", "K")}
    for name in ZOO_NAMES:
        for layer in zoo_workload(name).layers:
            dims.update(layer.dim(d) for d in ("R", "S", "P", "Q", "C", "K"))
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no cap warning may fire
        for n in sorted(dims):
            assert len(divisors(n)) <= SAMPLER_DIVISOR_CAP
            assert sampler_divisors(n) == divisors(n)


def test_sampler_divisors_caps_pathological_dims():
    n = 720720  # 2^4*3^2*5*7*11*13: 240 divisors
    full = divisors(n)
    assert len(full) > SAMPLER_DIVISOR_CAP
    with pytest.warns(RuntimeWarning, match="SAMPLER_DIVISOR_CAP"):
        sampler_divisors.cache_clear()
        capped = sampler_divisors(n)
    assert len(capped) <= SAMPLER_DIVISOR_CAP
    assert set(capped) <= set(full)
    assert capped[0] == 1 and capped[-1] == n
    assert list(capped) == sorted(capped)


def test_capped_dims_still_sample_valid_mappings():
    """The samplers stay structurally correct when a dim's ladder is capped:
    factor products must still equal the layer dims."""
    layer = fc("pathological", 720720, 64, _TOKENS)
    hw = eyeriss_168()
    rng = np.random.default_rng(0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for _ in range(5):
            m = constrained_random_mapping(rng, hw, layer)
            ok, reason = mapping_is_valid(m, hw, layer)
            assert ok or reason == "gb_capacity", reason
        factors, *_ = sample_constrained_batch(rng, hw, layer, 16)
    prods = factors.prod(axis=1)
    want = [layer.dim(d) for d in ("R", "S", "P", "Q", "C", "K")]
    assert (prods == np.array(want)[None, :]).all()


def test_conv_layer_divisors_method():
    layer = fc("x", 96, 7, _TOKENS)
    assert layer.divisors("C") == [1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 96]
    assert layer.divisors("K") == [1, 7]


# --- seeded golden pin ----------------------------------------------------------

def zoo_golden_record(name: str) -> dict:
    zw = zoo_workload(name)
    canonical = repr([(dataclasses.astuple(l), c)
                      for l, c in zip(zw.layers, zw.counts)])
    return {
        "shapes_sha256": hashlib.sha256(canonical.encode()).hexdigest(),
        "n_layers": len(zw.layers),
        "total_macs": zw.total_macs,
        "coverage": round(zw.coverage, 6),
    }


@pytest.mark.parametrize("name", ZOO_NAMES)
def test_zoo_matches_golden(name):
    goldens = json.loads(ZOO_GOLDEN_PATH.read_text())
    got = zoo_golden_record(name)
    want = goldens[name]
    assert got == want, (
        f"zoo workload drift on {name!r}:\n  got  {got}\n  want {want}\n"
        "the port must generate the reference's shapes")

