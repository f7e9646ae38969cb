"""PyTorch device engine for the batched mapping-evaluation protocol.

Twin of `repro_torch.timeloop.batch` (the NumPy host engine) over the same
packed encoding -- `MappingBatch.factors` int (B, 5, 6) plus (B, 6) loop-order
permutations -- with the whole per-trial pipeline as one chain of tensor ops
on the device:

  valid_batch      (B,) bool      validity masks (exact parity with NumPy)
  evaluate_batch   dict of (B,)   energy / delay / EDP / -log10(EDP) utility
  features_batch   (B, 14)        the BO surrogate's feature matrix
  forward_device   dict of torch.Tensor -- everything above, device-resident,
                   for fused GP-acquisition pool scoring (`core.bo` consumes
                   this through `SoftwareSpace.features_batch_device`)

Structure: this module packs pools into rows (`_pack`) and unpacks the
results; the forward itself -- per-mapping tiles, validity and gathers, the
trip-count/energy reduction, the features and the utility -- is
`repro_torch.kernels.cost_forward`: one launch of a hand-written CUDA kernel
on the card, its plain PyTorch version on the CPU.

Hardware and layer parameters enter as tensors (`hw_vec` / `layer_vec`) carried
*per row* -- the rows of one batch may belong to different layers AND
different hardware configs -- which is what lets `forward_device_stacked`
pack candidate pools into a single stacked program: all L layers of one
hardware probe (the layer-batched nested search, (L*B,) rows), or all H*L
(probe, layer) searches of the outer loop's fan-out (`strategy=
"probe_fanout"`, (H*L*B,) rows).  Pools are padded to power-of-two buckets
with all-ones rows, as the reference engine pads them.

Precision: float64 by default on every device (parity with the NumPy engine
at ~1e-12; the card runs FP64 natively); `dtype="float32"` is supported.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import trace
from repro_torch.device import resolve_device
from repro_torch.kernels.cost_forward import (H_DFH, H_DFW, H_EMAC, H_MX,
                                              H_MY, N_DIMS, cost_forward, prep)
from repro_torch.timeloop.arch import HardwareConfig
from repro_torch.timeloop.batch import MappingBatch
from repro_torch.timeloop.mapping import LEVELS
from repro_torch.timeloop.workloads import DIMS, ConvLayer

N_LEVELS = len(LEVELS)
DTYPES = {"float64": torch.float64, "float32": torch.float32}


def hw_vec(hw: HardwareConfig) -> np.ndarray:
    """Hardware constants as a (15,) float vector (the `H_*` columns of
    `kernels.cost_forward`)."""
    e = hw.energy
    return np.array(
        [
            hw.lb_weight, hw.lb_input, hw.lb_output, hw.gb_entries,
            hw.pe_mesh_x, hw.pe_mesh_y, hw.df_fw, hw.df_fh,
            e.mac, e.lb, e.noc, hw.gb_access_energy, e.dram,
            hw.gb_bandwidth, hw.dram_bandwidth,
        ],
        dtype=np.float64,
    )


def layer_vec(layer: ConvLayer) -> np.ndarray:
    """Layer constants as an (8,) float vector: dims, stride, macs."""
    return np.array(
        [*(layer.dim(d) for d in DIMS), layer.stride, layer.macs],
        dtype=np.float64,
    )


def layer_vecs(layers) -> np.ndarray:
    """(L, 8) stacked layer vectors for the layer-batched forward."""
    return np.stack([layer_vec(layer) for layer in layers])


def hw_vecs(hws) -> np.ndarray:
    """(L, 15) stacked hardware vectors for the probe-stacked forward."""
    return np.stack([hw_vec(hw) for hw in hws])


def _bucket(n: int) -> int:
    b = 8
    while b < n:
        b *= 2
    return b


def _pack(hw, pools, layers, dtype: str, device):
    """Pack L per-run pools into one (L*bucket,)-row batch on `device`:
    factors (N, 5, 6), the two loop orders (N, 6) int64, and the per-row
    hardware (N, 15) and layer (N, 8) vectors.  Padding rows (past a pool's
    length, up to the shared power-of-two bucket) are all-ones: invalid under
    the factorization check, finite everywhere (used_pes = 1, trips = 1).
    Returns (tensors, bucket)."""
    L = len(pools)
    if L != len(layers):
        raise ValueError(f"{L} pools for {len(layers)} layers")
    hws = [hw] * L if isinstance(hw, HardwareConfig) else list(hw)
    if L != len(hws):
        raise ValueError(f"{L} pools for {len(hws)} hardware configs")
    b = _bucket(max((len(p) for p in pools), default=0))
    factors = np.ones((L, b, N_LEVELS, N_DIMS), np.int64)
    orders = np.tile(np.arange(N_DIMS, dtype=np.int64), (2, L, b, 1))
    for k, p in enumerate(pools):
        n = len(p)
        if n:
            factors[k, :n] = p.factors
            orders[0, k, :n] = p.order_gb
            orders[1, k, :n] = p.order_dram
    layv = np.repeat(layer_vecs(layers)[:, None, :], b, axis=1)
    hwv = np.repeat(hw_vecs(hws)[:, None, :], b, axis=1)
    dev = resolve_device(device)
    dt = DTYPES[dtype]
    tensors = (
        torch.as_tensor(factors.reshape(L * b, N_LEVELS, N_DIMS)).to(
            device=dev, dtype=dt),
        torch.as_tensor(orders[0].reshape(L * b, N_DIMS)).to(dev),
        torch.as_tensor(orders[1].reshape(L * b, N_DIMS)).to(dev),
        torch.as_tensor(hwv.reshape(L * b, 15)).to(device=dev, dtype=dt),
        torch.as_tensor(layv.reshape(L * b, 8)).to(device=dev, dtype=dt),
    )
    return tensors, b


def forward_operands(hw, pools, layers, dtype: str = "float64",
                     device="cuda") -> dict[str, torch.Tensor]:
    """The five operands `cost_forward` receives when
    `forward_device_stacked` evaluates these pools (same packing): the
    inputs a kernel test or measurement feeds K1b at the main path's
    shapes."""
    tensors, _ = _pack(hw, pools, layers, dtype, device)
    return dict(zip(("factors", "order_gb", "order_dram", "hwv", "layv"),
                    tensors))


def reduce_operands(hw, pools, layers, dtype: str = "float64",
                    device="cuda") -> dict[str, torch.Tensor]:
    """The five operands K1 (`edp_reduce`) takes for these pools: `prep` of
    `forward_operands`, as the plain forward hands them to its reduction."""
    ops = forward_operands(hw, pools, layers, dtype, device)
    _, fo, relo, tl, spv, _, _ = prep(*ops.values())
    return {"fo": fo, "relo": relo, "tiles": tl.contiguous(), "sp": spv,
            "consts": ops["hwv"][:, H_EMAC:].contiguous()}


def forward_device(
    hw: HardwareConfig,
    mb: MappingBatch,
    layer: ConvLayer,
    dtype: str = "float64",
    device="cuda",
) -> dict[str, torch.Tensor]:
    """Run the forward on one pool; returns device-resident tensors
    (no host copy).  `dtype`: "float64" (default; parity with the NumPy
    engine) or "float32"."""
    out = forward_device_stacked(hw, [mb], [layer], dtype=dtype, device=device)
    return {k: v[0] for k, v in out.items()}


def forward_device_stacked(
    hw,
    pools,
    layers,
    dtype: str = "float64",
    device="cuda",
) -> dict[str, torch.Tensor]:
    """Stacked forward: L per-run pools, one device dispatch.

    `pools` is a sequence of L `MappingBatch`es (lengths may differ), `layers`
    the matching `ConvLayer`s, and `hw` either ONE `HardwareConfig` shared by
    every run (the layer-batched nested search) or a sequence of L per-run
    configs (the probe-fanout search, where the runs span H hardware probes).
    All pools are packed into one (L*bucket,)-row batch -- the hardware and
    layer vectors ride per row -- and evaluated by one `cost_forward` call
    (one launch of kernel K1b on the card), so per-row results are identical
    to L separate `forward_device` calls.  Returns device-resident tensors
    with a leading (L, B) shape, B = max pool length (rows past a pool's own
    length are padding: invalid, -inf utility).
    """
    with trace.span("cost_model.forward") as sp:
        tensors, b = _pack(hw, pools, layers, dtype, device)
        L = len(pools)
        if sp:
            sp.set(rows=L * b)
        B = max((len(p) for p in pools), default=0)
        out = cost_forward(*tensors)
        return {k: v.reshape(L, b, *v.shape[1:])[:, :B]
                for k, v in out.items()}


# --- EDP lower bounds (bound-and-prune pass) -------------------------------------

def _lower_bounds(hwv, layb, caps):
    """(n, L) provable EDP lower bounds from (n, 15) hw vectors + (L, 2)
    [macs, traffic_lb] layer constants + (L, 4, A) sorted spatial-cap tables.
    Reuses the `hw_vec` plumbing of the forward: the energy/bandwidth block
    is the same `hwv[:, H_EMAC:]` consts slice K1's reduction consumes,
    and the mesh shape + dataflow pins select each config's best-achievable
    PE count from the cap tables.  Same formulas as `bounds.lower_bound` /
    `batch.edp_lower_bounds_batch` (derivation in `timeloop.bounds`)."""
    consts = hwv[:, H_EMAC:]
    e_mac, e_lb, e_noc, e_gb, e_dram, gb_bw, dram_bw = (
        consts[:, j:j + 1] for j in range(7))
    # dataflow variant per config: v = 2*(df_fh==2) + (df_fw==2)
    v = (2 * (hwv[:, H_DFH] == 2.0).long() + (hwv[:, H_DFW] == 2.0).long())
    capsel = caps.index_select(1, v)  # (L, n, A)
    mx, my = hwv[:, H_MX], hwv[:, H_MY]
    ax = torch.where(capsel <= mx[None, :, None], capsel, 1.0).amax(dim=-1)
    ay = torch.where(capsel <= my[None, :, None], capsel, 1.0).amax(dim=-1)
    used = (ax * ay).T  # (n, L) best-achievable PE count
    macs, traffic = layb[:, 0][None, :], layb[:, 1][None, :]
    energy = (macs * e_mac + (4.0 * macs + traffic) * e_lb
              + traffic * (e_noc + e_gb + e_dram))
    delay = torch.maximum(macs / used,
                          torch.maximum(traffic / gb_bw, traffic / dram_bw))
    return energy * delay


def edp_lower_bounds_device(hws, layers, dtype: str = "float64",
                            device="cuda") -> np.ndarray:
    """(n_hw, L) bound matrix over a hardware pool x layer stack as ONE device
    dispatch -- the torch twin of `bounds.edp_lower_bounds`.  The pool axis is
    padded to the shared power-of-two buckets (all-ones padding rows are
    benign: every bound input is >= 1, and an all-ones row selects variant 0
    with unit mesh caps); results come back to the host, where the prune hook
    filters plain candidate lists."""
    from repro_torch.timeloop.bounds import layer_bound_vecs, layer_caps

    with trace.span("cost_model.bound") as sp:
        dev = resolve_device(device)
        dt = DTYPES[dtype]
        n = len(hws)
        b = _bucket(n)
        if sp:
            sp.set(rows=b)
        hwv = np.ones((b, 15), np.float64)
        if n:
            hwv[:n] = hw_vecs(hws)
        out = _lower_bounds(
            torch.as_tensor(hwv).to(device=dev, dtype=dt),
            torch.as_tensor(layer_bound_vecs(layers)).to(device=dev,
                                                         dtype=dt),
            torch.as_tensor(layer_caps(layers)).to(device=dev, dtype=dt))
        return trace.host(out)[:n]


# --- host-facing twins of the NumPy engine -------------------------------------

def valid_batch(
    mb: MappingBatch, hw: HardwareConfig, layer: ConvLayer, **kw
) -> np.ndarray:
    """(B,) bool -- exact twin of `batch.valid_batch` / `mapping_is_valid`."""
    return trace.host(forward_device(hw, mb, layer, **kw)["valid"])


def evaluate_batch(
    hw: HardwareConfig, mb: MappingBatch, layer: ConvLayer, **kw
) -> dict[str, np.ndarray]:
    """Twin of `batch.evaluate_batch` (plus a precomputed `utility` entry)."""
    out = forward_device(hw, mb, layer, **kw)
    return {k: trace.host(v) for k, v in out.items() if k != "features"}


def features_batch(
    mb: MappingBatch, hw: HardwareConfig, layer: ConvLayer, **kw
) -> np.ndarray:
    """(B, 14) feature matrix -- twin of `batch.features_batch`."""
    return trace.host(forward_device(hw, mb, layer, **kw)["features"])
