"""Kernel K1b of the PyTorch port (`repro_torch.kernels.cost_forward`): the
cost model's whole forward in one launch.

Its plain version (`cost_forward_ref`) is held to the forward as the port
composed it before K1b -- `prep`, K1's reduction, then the features and the
utility as separate PyTorch ops (`_unfused` below) -- on real candidate pools
of the four paper workloads: one pool per workload, the layer-stacked and
the probe-stacked packings, and a stack with padding and invalid rows.  Bars:
masks and inf positions exact; float64 bit for bit, float32 within 1e-6
relative.  The port's forward against the JAX reference is
`tests/test_torch_batch.py`, which runs through this kernel's wrapper.

The CUDA kernel itself is held against its plain version on the card by the
`cuda`-marked tests at the end (they skip without a card).  This file imports
no jax, so they run on a machine with the card but without the reference:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cost_forward.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.cost_forward import (H_EMAC, H_GBE, H_LBI, H_LBO,
                                              H_LBW, H_MX, H_MY, L_MACS,
                                              cost_forward, cost_forward_ref,
                                              prep)
from repro_torch.kernels.edp_reduce import edp_reduce
from repro_torch.timeloop import MODEL_LAYERS, eyeriss_168
from repro_torch.timeloop import batch as tlb
from repro_torch.timeloop import batch_torch as ttlb
from repro_torch.timeloop.arch import sample_hardware_pool

MODELS = ("resnet", "dqn", "mlp", "transformer")
DTYPES = ("float64", "float32")
BARS = {"float64": 0.0, "float32": 1e-6}
KEYS = ("valid", "energy_pj", "delay_cycles", "edp", "utility", "features")
CASES = (*MODELS, "layer_stacked", "probe_stacked", "padding_invalid")


def _unfused(factors, order_gb, order_dram, hwv, layv):
    """The forward before K1b: `prep`, K1's wrapper (`edp_reduce`, its plain
    version on CPU tensors), then features and utility op by op."""
    ok, fo, relo, tl, spv, sx, sy = prep(factors, order_gb, order_dram, hwv,
                                         layv)
    ev, trips = edp_reduce(fo, relo, tl.contiguous(), spv,
                           hwv[:, H_EMAC:].contiguous())
    energy, delay, edp = ev.unbind(1)
    used = spv[:, 4]
    feats = torch.stack(
        [tl[:, 0, 1] / hwv[:, H_LBI], tl[:, 0, 0] / hwv[:, H_LBW],
         tl[:, 0, 2] / hwv[:, H_LBO], tl[:, 1, :].sum(dim=1) / hwv[:, H_GBE],
         sx / hwv[:, H_MX], sy / hwv[:, H_MY],
         *[torch.log1p(trips[:, j]) for j in range(6)],
         torch.log1p(used), torch.log1p(layv[:, L_MACS] / used)], dim=1)
    inf = torch.full((), torch.inf, dtype=energy.dtype)
    return {"valid": ok,
            "energy_pj": torch.where(ok, energy, inf),
            "delay_cycles": torch.where(ok, delay, inf),
            "edp": torch.where(ok, edp, inf),
            "utility": torch.where(ok, -torch.log10(torch.where(ok, edp, 1.0)),
                                   -inf),
            "features": feats}


def _hw_pool(rng, n):
    """Eyeriss and n - 1 random 168-PE designs (the pools are sampled valid
    on Eyeriss, so on the others some rows are invalid)."""
    return [eyeriss_168()] + sample_hardware_pool(rng, n - 1, num_pes=168)


def _case_operands(case: str, dtype: str):
    rng = np.random.default_rng(13)
    hw = eyeriss_168()
    if case in MODELS:
        layers = MODEL_LAYERS[case][-1:]
        hws = hw
    elif case == "layer_stacked":
        layers = MODEL_LAYERS["resnet"]
        hws = hw
    elif case == "probe_stacked":
        layers = [MODEL_LAYERS[m][0] for m in MODELS]
        hws = _hw_pool(rng, len(layers))
    else:  # a short pool, a full one on random hardware, an empty one
        layers = [MODEL_LAYERS["dqn"][0]] * 3
        hws = _hw_pool(rng, 3)
    pools = [tlb.sample_valid_pool(rng, hw, ly, 150) for ly in layers]
    if case == "padding_invalid":
        pools = [pools[0].take(np.arange(40)), pools[1],
                 pools[2].take(np.arange(0))]
    ops = ttlb.forward_operands(hws, pools, layers, dtype, device="cpu")
    return list(ops.values())


def _pool_operands(n_rows: int, dtype: str, device):
    """`n_rows` rows of packed pools of every workload's layers (150 rows a
    256-row bucket, so every bucket ends in padding), each run on one of
    four designs (so some rows are invalid)."""
    rng = np.random.default_rng(17)
    layers = [ly for m in MODELS for ly in MODEL_LAYERS[m]]
    runs = [layers[k % len(layers)] for k in range(-(-n_rows // 256))]
    hws = _hw_pool(rng, 4)
    pools = [tlb.sample_valid_pool(rng, eyeriss_168(), ly, 150) for ly in runs]
    ops = ttlb.forward_operands([hws[k % 4] for k in range(len(runs))], pools,
                                runs, dtype, device=device)
    return [x[:n_rows].contiguous() for x in ops.values()]


def _assert_same(got, want, bar):
    assert torch.equal(got["valid"].cpu(), want["valid"].cpu())
    for k in KEYS[1:]:
        g, w = got[k].cpu(), want[k].cpu()
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert torch.equal(torch.isinf(g), torch.isinf(w)), k
        assert torch.equal(g[torch.isinf(g)], w[torch.isinf(w)]), k
        fin = torch.isfinite(w)
        assert torch.isfinite(g[fin]).all(), k
        if bar == 0.0:
            assert torch.equal(g, w), k
        else:
            rel = ((g[fin] - w[fin]).abs() / w[fin].abs().clamp(min=1e-30))
            assert rel.numel() == 0 or float(rel.max()) <= bar, k


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CASES)
def test_plain_matches_unfused_forward(case, dtype):
    ops = _case_operands(case, dtype)
    got = cost_forward_ref(*ops)
    _assert_same(got, _unfused(*ops), BARS[dtype])
    n = ops[0].shape[0]
    assert got["features"].shape == (n, 14)
    assert torch.isfinite(got["features"]).all()   # padding rows too
    valid = got["valid"]
    assert (got["utility"][~valid] == -torch.inf).all()
    assert torch.isfinite(got["utility"][valid]).all()
    if case in ("probe_stacked", "padding_invalid"):
        assert valid.any() and not valid.all()


def test_forward_device_is_one_cost_forward_call(monkeypatch):
    calls = []

    def counted(*ops):
        calls.append(ops[0].shape[0])
        return cost_forward(*ops)

    monkeypatch.setattr(ttlb, "cost_forward", counted)
    rng = np.random.default_rng(1)
    layers = MODEL_LAYERS["mlp"]
    pools = [tlb.sample_valid_pool(rng, eyeriss_168(), ly, 20) for ly in layers]
    out = ttlb.forward_device_stacked(eyeriss_168(), pools, layers,
                                      device="cpu")
    assert calls == [len(layers) * 32]
    assert out["features"].shape == (len(layers), 20, 14)


def test_wrapper_on_cpu_is_the_plain_version_and_launches_nothing():
    ops = _case_operands("probe_stacked", "float64")
    before = (cost_forward.launches, edp_reduce.launches)
    got = cost_forward(*ops)
    _assert_same(got, cost_forward_ref(*ops), 0.0)
    assert (cost_forward.launches, edp_reduce.launches) == before


@pytest.mark.parametrize("bad", ["shape", "dtype", "order_dtype", "device",
                                 "type"])
def test_wrapper_rejects_bad_operands(bad):
    ops = _case_operands("mlp", "float64")
    if bad == "shape":
        ops[3] = ops[3][:, :14]
    elif bad == "dtype":
        ops[4] = ops[4].float()
    elif bad == "order_dtype":
        ops[1] = ops[1].int()
    elif bad == "device":
        ops[3] = torch.empty(ops[3].shape, dtype=ops[3].dtype, device="meta")
    else:
        ops[0] = ops[0].numpy()
    with pytest.raises((ValueError, TypeError)):
        cost_forward(*ops)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_rows", [256, 1000, 8192])
def test_cuda_kernel_matches_plain_on_card(n_rows, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    ops = _pool_operands(n_rows, dtype, "cuda")
    before = (cost_forward.launches, edp_reduce.launches)
    got = cost_forward(*ops)
    torch.cuda.synchronize()
    assert (cost_forward.launches, edp_reduce.launches) == (before[0] + 1,
                                                           before[1])
    want = cost_forward_ref(*ops)
    assert not bool(want["valid"].all())     # padding and invalid rows
    _assert_same(got, want, BARS[dtype])


@pytest.mark.cuda
def test_cuda_forward_device_launches_once_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    rng = np.random.default_rng(2)
    layers = MODEL_LAYERS["resnet"]
    hw = eyeriss_168()
    pools = [tlb.sample_valid_pool(rng, hw, ly, 150) for ly in layers]
    before = (cost_forward.launches, edp_reduce.launches)
    out = ttlb.forward_device_stacked(hw, pools, layers, device="cuda")
    cpu = ttlb.forward_device_stacked(hw, pools, layers, device="cpu")
    assert (cost_forward.launches, edp_reduce.launches) == (before[0] + 1,
                                                           before[1])
    # the host's log1p / log10 are not CUDA's: the ROADMAP's f64 parity bar
    _assert_same(out, cpu, 1e-12)
