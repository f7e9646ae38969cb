"""Kernel K1 of the PyTorch port (`repro_torch.kernels.edp_reduce`) against
the JAX reference (`repro.kernels.edp_reduce`).

The operands come from real packed candidate pools of all four paper
workloads (the port's `batch_torch.reduce_operands`, i.e. exactly what the
cost model hands the kernel), as numpy arrays fed to both packages: one pool
of 150 rows per workload, and the stacked 4 x 256-row batch of all four.
The reference runs its plain `reduce_edp_terms` and its Pallas kernel in
interpret mode, in this process (the kernel module imports cleanly; float64
under `jax.enable_x64(True)`).

Bars: float64 -- ev within 1e-12 relative, trips exact (integer-valued
products); float32 -- within 1e-6 relative.  On the CPU the wrapper takes the
plain version; the CUDA kernel itself is held against it by the card-only
test at the end (and by chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import edp_reduce as ref_kernel
from repro_torch.kernels.edp_reduce import edp_reduce, reduce_edp_terms
from repro_torch.timeloop import MODEL_LAYERS, eyeriss_168
from repro_torch.timeloop import batch as tlb
from repro_torch.timeloop import batch_torch as ttlb

MODELS = ("resnet", "dqn", "mlp", "transformer")
NAMES = ("fo", "relo", "tiles", "sp", "consts")
BARS = {"float64": 1e-12, "float32": 1e-6}


def _operands(case: str, dtype: str) -> list[np.ndarray]:
    hw = eyeriss_168()
    rng = np.random.default_rng(11)
    if case == "stacked":
        layers = [MODEL_LAYERS[m][0] for m in MODELS]
        pools = [tlb.sample_valid_pool(rng, hw, ly, 150) for ly in layers]
        ops = ttlb.reduce_operands(hw, pools, layers, dtype, device="cpu")
        assert ops["fo"].shape[0] == 4 * 256
        return [ops[k].numpy() for k in NAMES]
    layer = MODEL_LAYERS[case][-1]
    pool = tlb.sample_valid_pool(rng, hw, layer, 150)
    ops = ttlb.reduce_operands(hw, [pool], [layer], dtype, device="cpu")
    return [ops[k].numpy()[:150] for k in NAMES]


def _reference(ops, dtype):
    """(plain, interpret) reference outputs as numpy."""
    if dtype == "float64":
        with jax.enable_x64(True):
            args = [jnp.asarray(a) for a in ops]
            plain = ref_kernel.reduce_edp_terms(*args)
            kern = ref_kernel.edp_reduce(*args, interpret=True)
            return ([np.asarray(x) for x in plain], [np.asarray(x) for x in kern])
    args = [jnp.asarray(a) for a in ops]
    plain = ref_kernel.reduce_edp_terms(*args)
    kern = ref_kernel.edp_reduce(*args, interpret=True)
    return [np.asarray(x) for x in plain], [np.asarray(x) for x in kern]


def _assert_close(ev, trips, ev_ref, trips_ref, dtype):
    rel = np.max(np.abs(ev - ev_ref) / np.abs(ev_ref))
    assert rel <= BARS[dtype], rel
    if dtype == "float64":
        np.testing.assert_array_equal(trips, trips_ref)
    else:
        np.testing.assert_allclose(trips, trips_ref, rtol=BARS[dtype])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", [*MODELS, "stacked"])
def test_plain_matches_reference(case, dtype):
    ops = _operands(case, dtype)
    (ev_p, tr_p), (ev_k, tr_k) = _reference(ops, dtype)
    # the reference's own two paths agree before the port is held to them
    _assert_close(ev_k, tr_k, ev_p, tr_p, dtype)
    tensors = [torch.from_numpy(a) for a in ops]
    ev, trips = reduce_edp_terms(*tensors)
    assert ev.dtype == tensors[0].dtype and ev.shape == (len(ops[0]), 3)
    for ev_ref, tr_ref in ((ev_p, tr_p), (ev_k, tr_k)):
        _assert_close(ev.numpy(), trips.numpy(), ev_ref, tr_ref, dtype)


def test_wrapper_on_cpu_is_the_plain_version_and_launches_nothing():
    ops = [torch.from_numpy(a) for a in _operands("dqn", "float64")]
    before = edp_reduce.launches
    ev, trips = edp_reduce(*ops)
    ev_p, tr_p = reduce_edp_terms(*ops)
    assert torch.equal(ev, ev_p) and torch.equal(trips, tr_p)
    assert edp_reduce.launches == before


@pytest.mark.parametrize("bad", ["shape", "dtype", "type"])
def test_wrapper_rejects_bad_operands(bad):
    ops = [torch.from_numpy(a) for a in _operands("mlp", "float64")]
    if bad == "shape":
        ops[1] = ops[1][:, :, :2]
    elif bad == "dtype":
        ops[2] = ops[2].float()
    else:
        ops[3] = ops[3].numpy()
    with pytest.raises((ValueError, TypeError)):
        edp_reduce(*ops)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_cuda_kernel_matches_plain_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    ops = [torch.from_numpy(a).cuda() for a in _operands("stacked", dtype)]
    before = edp_reduce.launches
    ev, trips = edp_reduce(*ops)
    torch.cuda.synchronize()
    assert edp_reduce.launches == before + 1
    ev_p, tr_p = reduce_edp_terms(*ops)
    _assert_close(ev.cpu().numpy(), trips.cpu().numpy(), ev_p.cpu().numpy(),
                  tr_p.cpu().numpy(), dtype)
