"""The cost model's whole forward in one kernel (K1b).

One function, from a packed candidate pool to everything the search reads:
per-mapping validity, energy, delay, EDP, the -log10(EDP) utility and the
14-column feature matrix of the BO surrogate.  It composes the per-mapping
prep (tiles, validity, gathers into loop order: `prep`), K1's reduction
(`edp_reduce.reduce_edp_terms`) and the features, as the reference's one
XLA program does around its Pallas call (`repro.timeloop.batch_jax._forward`).

Two implementations of it:

  * `cost_forward_ref` -- the plain PyTorch version (any device): the CPU
    path and the reference the kernel is held against.  Its `reduce`
    argument takes K1's wrapper instead (`edp_reduce.edp_reduce`) to give the
    unfused forward of earlier versions: prep and features in PyTorch around
    one K1 launch;
  * `cost_forward` -- the wrapper of the hand-written CUDA kernel
    (`csrc/edp_reduce.cu`, `cost_forward_kernel`, built for sm_90a at first
    use): one launch per forward.  It launches the kernel for CUDA tensors
    and takes the plain version only for CPU tensors; a failed build or
    launch raises, it never falls back.  `cost_forward.launches` counts
    kernel launches.

Operands (leading dim N, one row per candidate mapping; the hardware and
layer vectors ride per row, so the rows of one call may belong to different
layers and hardware probes):

  factors     (N, 5, 6)  loop factors, levels [lb, sx, sy, gb, dram] x dims
                         [R, S, P, Q, C, K]; float32 or float64
  order_gb    (N, 6)     int64 loop orders (permutations of 0..5) at gb
  order_dram  (N, 6)     and at dram
  hwv         (N, 15)    `batch_torch.hw_vec`: [lb_w, lb_i, lb_o, gb_entries,
                         mesh_x, mesh_y, df_fw, df_fh, e_mac, e_lb, e_noc,
                         e_gb, e_dram, gb_bw, dram_bw]; factors' dtype
  layv        (N, 8)     `batch_torch.layer_vec`: six extents, stride, macs

Outputs, a dict: `valid` (N,) bool; `energy_pj`, `delay_cycles`, `edp` (N,)
(inf where invalid); `utility` (N,) (-inf where invalid); `features` (N, 14).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels.edp_reduce import reduce_edp_terms
from repro_torch.timeloop.batch import (D_R, D_S, L_DRAM, L_GB, L_LB, L_SX,
                                        L_SY, REL_MASKS, TENSORS)
from repro_torch.timeloop.mapping import LEVELS
from repro_torch.timeloop.workloads import DIMS

N_DIMS = len(DIMS)
N_LEVELS = len(LEVELS)
N_HW, N_LAYER, N_FEATURES = 15, 8, 14
# hw_vec layout: validity bounds first, then energy/bandwidth constants.
(H_LBW, H_LBI, H_LBO, H_GBE, H_MX, H_MY, H_DFW, H_DFH,
 H_EMAC, H_ELB, H_ENOC, H_EGB, H_EDRAM, H_GBBW, H_DRAMBW) = range(N_HW)
# layer_vec layout: the six loop extents (DIMS order), stride, macs.
L_STRIDE, L_MACS = 6, 7

# (3, 6) relevance masks, tensors in TENSORS order (W, I, O), dims in DIMS order.
_REL = np.stack([REL_MASKS[t] for t in TENSORS]).astype(np.float64)

_ENTRY = {torch.float64: "cost_forward_f64", torch.float32: "cost_forward_f32"}
_SHAPES = {"factors": (N_LEVELS, N_DIMS), "order_gb": (N_DIMS,),
           "order_dram": (N_DIMS,), "hwv": (N_HW,), "layv": (N_LAYER,)}


def prep(factors, order_gb, order_dram, hwv, layv):
    """Per-mapping tiles, validity, and gathered reduction operands.

    Takes the operands of the module docstring.  Returns (ok (N,), fo
    (N,2,6), relo (N,2,3,6), tiles (N,2,3), sp (N,6), sx (N,), sy (N,)).  All
    quantities entering the validity comparisons are < 2^24, so they are
    exact in float32 as well as float64 -- masks never depend on the
    dtype."""
    n = factors.shape[0]
    dims = layv[:, :N_DIMS]
    stride = layv[:, L_STRIDE]

    def ext(p, r):  # input halo extent, same formula as ConvLayer.input_extent
        return (p - 1.0) * stride + r

    def tiles(f):
        r, s, p, q, c, k = f.unbind(1)
        return torch.stack([r * s * c * k, ext(p, r) * ext(q, s) * c,
                            p * q * k], dim=1)

    lb = tiles(factors[:, L_LB])
    gbt = tiles(factors[:, : L_GB + 1].prod(dim=1))

    ok = (factors.prod(dim=1) == dims).all(dim=1)
    ok &= (hwv[:, H_DFW] != 2.0) | (factors[:, L_LB, D_S] == dims[:, D_S])
    ok &= (hwv[:, H_DFH] != 2.0) | (factors[:, L_LB, D_R] == dims[:, D_R])
    ok &= ((lb[:, 0] <= hwv[:, H_LBW]) & (lb[:, 1] <= hwv[:, H_LBI])
           & (lb[:, 2] <= hwv[:, H_LBO]))
    ok &= gbt.sum(dim=1) <= hwv[:, H_GBE]
    sx = factors[:, L_SX].prod(dim=1)
    sy = factors[:, L_SY].prod(dim=1)
    ok &= (sx <= hwv[:, H_MX]) & (sy <= hwv[:, H_MY])

    rel = torch.as_tensor(_REL, dtype=factors.dtype, device=factors.device)
    sp = factors[:, L_SX] * factors[:, L_SY]  # (N, 6) per-dim spatial factors
    sp_rel = torch.where(rel[None] > 0.5, sp[:, None, :], 1.0).prod(dim=2)
    fo = torch.stack([factors[:, L_GB].gather(1, order_gb),
                      factors[:, L_DRAM].gather(1, order_dram)], dim=1)
    rel_n = rel.expand(n, len(TENSORS), N_DIMS)
    relo = torch.stack(
        [rel_n.gather(2, o[:, None, :].expand(n, len(TENSORS), N_DIMS))
         for o in (order_gb, order_dram)], dim=1)
    spv = torch.cat(
        [sp_rel, torch.stack([sp.prod(dim=1), sx * sy, layv[:, L_MACS]], dim=1)],
        dim=1)
    return ok, fo, relo, torch.stack([lb, gbt], dim=1), spv, sx, sy


def cost_forward_ref(factors, order_gb, order_dram, hwv, layv,
                     reduce=reduce_edp_terms):
    """The forward in plain PyTorch: `prep`, then `reduce` (K1's function:
    `reduce_edp_terms`, or K1's wrapper `edp_reduce`), then the features and
    the utility.  Returns the dict of the module docstring."""
    ok, fo, relo, tl, spv, sx, sy = prep(factors, order_gb, order_dram, hwv,
                                         layv)
    ev, trips = reduce(fo, relo, tl.contiguous(), spv,
                       hwv[:, H_EMAC:].contiguous())

    energy, delay, edp = ev.unbind(1)
    used = spv[:, 4]
    feats = torch.stack(
        [
            tl[:, 0, 1] / hwv[:, H_LBI],
            tl[:, 0, 0] / hwv[:, H_LBW],
            tl[:, 0, 2] / hwv[:, H_LBO],
            tl[:, 1, :].sum(dim=1) / hwv[:, H_GBE],
            sx / hwv[:, H_MX],
            sy / hwv[:, H_MY],
            *[torch.log1p(trips[:, j]) for j in range(2 * len(TENSORS))],
            torch.log1p(used),
            torch.log1p(layv[:, L_MACS] / used),
        ],
        dim=1,
    )
    inf = torch.full((), torch.inf, dtype=energy.dtype, device=energy.device)
    # Guard the log10 against invalid rows (inf EDP -> nan under where).
    utility = torch.where(ok, -torch.log10(torch.where(ok, edp, 1.0)), -inf)
    return {
        "valid": ok,
        "energy_pj": torch.where(ok, energy, inf),
        "delay_cycles": torch.where(ok, delay, inf),
        "edp": torch.where(ok, edp, inf),
        "utility": utility,
        "features": feats,
    }


def _check(factors, order_gb, order_dram, hwv, layv) -> int:
    ops = {"factors": factors, "order_gb": order_gb, "order_dram": order_dram,
           "hwv": hwv, "layv": layv}
    for name, x in ops.items():
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"cost_forward: {name} must be a torch.Tensor")
    if factors.dtype not in _ENTRY:
        raise ValueError(f"cost_forward: dtype must be float32 or float64, "
                         f"got {factors.dtype}")
    n = factors.shape[0] if factors.dim() else -1
    for name, x in ops.items():
        if x.device != factors.device:
            raise ValueError(f"cost_forward: {name} is on {x.device}, "
                             f"factors on {factors.device}")
        want = torch.int64 if name.startswith("order") else factors.dtype
        if x.dtype != want:
            raise ValueError(f"cost_forward: {name} is {x.dtype}, expected "
                             f"{want}")
        if tuple(x.shape) != (n, *_SHAPES[name]):
            raise ValueError(f"cost_forward: {name} has shape "
                             f"{tuple(x.shape)}, expected "
                             f"{(n, *_SHAPES[name])}")
    return n


def _kernel_lib():
    from repro_torch.kernels import build

    lib = build.load("edp_reduce")
    for entry in _ENTRY.values():
        fn = getattr(lib, entry)
        if fn.argtypes is None:
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_longlong,
                                                   ctypes.c_void_p]
    return lib


def cost_forward(factors, order_gb, order_dram, hwv, layv):
    """`cost_forward_ref` through the CUDA kernel for CUDA tensors, in one
    launch (the plain version for CPU tensors).  Returns the dict of the
    module docstring; on the card its four (N,) float entries are the rows of
    one (4, N) tensor."""
    ops = (factors, order_gb, order_dram, hwv, layv)
    n = _check(*ops)
    if factors.device.type == "cpu":
        return cost_forward_ref(*ops)
    if factors.device.type != "cuda":
        raise ValueError(f"cost_forward: unsupported device {factors.device}")
    for name, x in zip(_SHAPES, ops):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"cost_forward: {name} must be contiguous and "
                             f"start on a 16-byte boundary")
    dev = factors.device
    valid = torch.empty((n,), dtype=torch.bool, device=dev)
    scal = torch.empty((4, n), dtype=factors.dtype, device=dev)
    feats = torch.empty((n, N_FEATURES), dtype=factors.dtype, device=dev)
    if n:
        fn = getattr(_kernel_lib(), _ENTRY[factors.dtype])
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = fn(*(x.data_ptr() for x in ops), valid.data_ptr(),
                    scal.data_ptr(), feats.data_ptr(), n, stream)
        if rc != 0:
            raise RuntimeError(f"cost_forward: CUDA kernel launch failed "
                               f"(cudaError {rc})")
        cost_forward.launches += 1
    energy, delay, edp, utility = scal.unbind(0)
    return {"valid": valid, "energy_pj": energy, "delay_cycles": delay,
            "edp": edp, "utility": utility, "features": feats}


cost_forward.launches = 0
