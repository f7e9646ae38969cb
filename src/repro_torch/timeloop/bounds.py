"""Provable per-(hardware, layer) EDP lower bounds (the bound-and-prune pass).

The semi-decoupled co-design result (arXiv 2203.13921, PAPERS.md) rests on one
observation: most hardware candidates can be discarded by a cheap best-case
bound *before* any mapping search.  This module derives such a bound against
`model.evaluate` (the scalar ground truth): for EVERY mapping `m` that is
valid on `(hw, layer)`,

    lower_bound(hw, layer) <= evaluate(hw, m, layer).edp

so a candidate whose summed per-layer bound already exceeds the incumbent's
true model EDP provably cannot win the outer search, no matter what the inner
mapping optimizer would find.

Derivation (all level factors are >= 1; per-dim factors across the five levels
multiply exactly to the layer dim -- the mapping-validity factorization check):

  * trips:    `_level_trips` multiplies the level's relevant factors and any
              irrelevant factors ordered outside them, so
              trips >= prod(relevant factors at that level)   (and >= 1).
  * rw:       the output read-modify-write multiplier `2 * passes - 1 >= 1`.
  * spatial:  sp_all >= sp_rel (both products of factors >= 1).
  * tiles:    the W tile (r*s*c*k) and O tile (p*q*k) are plain products, so
              tile * (relevant spatial) * (relevant gb trips) * (relevant dram
              trips) >= product of ALL levels' factors over the tensor's
              relevant dims = weight_size / output_size exactly.  The I tile
              uses the halo extent ext(p, r) = (p - 1) * stride + r, and
              telescoping any per-level split of P (and R) keeps the product
              above touched(P, R) = min((P-1)*stride + R, P*R) -- the
              distinct input positions along that axis (the halo extent when
              strides overlap, P*R disjoint windows when stride > R leaves
              gaps; the full `input_size` = ext(P, R)*ext(Q, S)*C is NOT a
              valid bound in the gapped case).

Summing the three tensors therefore bounds every accumulator of
`model.evaluate` / `batch.evaluate_batch` by

    traffic_lb = weight_size + output_size
                 + C * touched(P, R) * touched(Q, S)

    gb_acc   >= traffic_lb          noc_acc  >= traffic_lb
    dram_acc >= traffic_lb          lb_acc   >= 4 * macs + traffic_lb

The compute roof is *mesh-divisibility aware*.  `used_pes = sp_x * sp_y`
where sp_x is a product of per-dim spatial factors, each dividing its layer
dim (the factorization check), with sp_x <= pe_mesh_x (mesh validity) -- so
sp_x can never exceed

    cap(mesh_x) = max{ prod_d g_d : g_d | dim(d) } <= mesh_x

over the dims available for spatial blocking (a dataflow pin df_fh == 2 /
df_fw == 2 fixes ALL of R / S inside the PE, removing that dim), and likewise
for sp_y.  `used_pes <= cap(mesh_x) * cap(mesh_y)` then bounds utilization by
what the layer's divisor structure lets the mesh shape actually host: a
168 = 24x7 mesh cannot be filled by power-of-two layer dims, and the bound
sees it.  (Bounding each axis separately is sound -- the joint per-dim split
constraint can only shrink the product further.)

The EDP bound follows from the model's own energy/delay formulas with every
accumulator replaced by its bound:

    energy_lb = macs * e_mac + (4 * macs + traffic_lb) * e_lb
                + traffic_lb * (e_noc + gb_access_energy + e_dram)
    delay_lb  = max(macs / (cap(mesh_x) * cap(mesh_y)),
                    traffic_lb / gb_bandwidth, traffic_lb / dram_bandwidth)
    edp_lb    = energy_lb * delay_lb

The bound is a roofline: it assumes perfect reuse (every word moved once),
best-achievable PE utilization, and no read-modify-write amplification, all of
which real mappings violate -- so it is loose in absolute terms but
*ordering-accurate* in the quantities that vary across the hardware pool
(mesh shape x layer divisibility, dataflow pins, gb_bandwidth,
gb_access_energy), which is what pruning needs.

`lower_bound` is the scalar reference; `hw_bound_vecs` / `layer_bound_vecs` /
`layer_caps` pack pools and layer stacks for the vectorized twins --
`batch.edp_lower_bounds_batch` (NumPy) and
`batch_torch.edp_lower_bounds_device` (one device dispatch) -- both
parity-pinned against the scalar here and property-tested against random
valid mappings in tests/test_bounds.py.  This module stays NumPy-only: the
host engine must not pay for the torch import chain.
"""

from __future__ import annotations

import functools

import numpy as np

from repro_torch import trace
from repro_torch.timeloop.arch import HardwareConfig
from repro_torch.timeloop.workloads import DIMS, ConvLayer, divisors

# hw_bound_vecs column layout: the edp_reduce consts block (hw_vec[H_EMAC:] of
# `batch_torch`) with mesh shape and dataflow pins appended.
(B_EMAC, B_ELB, B_ENOC, B_EGB, B_EDRAM, B_GBBW, B_DRAMBW,
 B_MX, B_MY, B_DFW, B_DFH) = range(11)

# Divisor products above any real mesh axis are interchangeable with infinity;
# capping there keeps the per-layer tables tiny.
_CAP_LIMIT = 1 << 20


def _touched(outputs: int, filt: int, stride: int) -> int:
    """Distinct input positions along one axis: the halo extent
    (outputs-1)*stride + filt when strides overlap, outputs*filt disjoint
    windows when stride > filt leaves gaps."""
    return min((outputs - 1) * stride + filt, outputs * filt)


def traffic_lower_bound(layer: ConvLayer) -> float:
    """Minimum words any valid mapping moves through every memory level:
    weights + outputs once each, plus the distinct input words any valid
    mapping touches, C * touched(P,R) * touched(Q,S) -- at least P*Q*C, and
    strictly tighter whenever R or S exceeds 1."""
    input_lb = (_touched(layer.P, layer.R, layer.stride)
                * _touched(layer.Q, layer.S, layer.stride) * layer.C)
    return float(layer.weight_size + layer.output_size + input_lb)


def _divisor_products(dims_vals) -> np.ndarray:
    """Sorted achievable products prod_d g_d with g_d | dim_d (capped): the
    set of values a spatial factor product over these dims can take."""
    prods = {1}
    for dv in dims_vals:
        prods = {p * d for p in prods for d in divisors(dv)
                 if p * d <= _CAP_LIMIT} | prods
    return np.array(sorted(prods), dtype=np.float64)


@functools.lru_cache(maxsize=None)
def _caps_for(dims_key: tuple) -> tuple[np.ndarray, ...]:
    """The four dataflow variants' achievable-product tables for one layer's
    dims (keyed by the dim tuple so equal-shaped layers share).  Variant
    v = 2*(df_fh == 2) + (df_fw == 2): df_fh pins R inside the PE (no spatial
    R), df_fw pins S."""
    dims = dict(zip(DIMS, dims_key))
    out = []
    for pin_r in (False, True):
        for pin_s in (False, True):
            avail = [v for d, v in dims.items()
                     if not (d == "R" and pin_r) and not (d == "S" and pin_s)]
            out.append(_divisor_products(avail))
    # order: v0 (no pin), v1 (S pinned), v2 (R pinned), v3 (both)
    return tuple(out)


def spatial_caps(layer: ConvLayer) -> np.ndarray:
    """(4, A) sorted achievable spatial-product tables, one row per dataflow
    variant, rows padded (by repeating the row max) to a shared width."""
    tables = _caps_for(tuple(layer.dim(d) for d in DIMS))
    width = max(len(t) for t in tables)
    return np.stack([
        np.concatenate([t, np.full(width - len(t), t[-1])]) for t in tables
    ])


def used_pes_cap(hw: HardwareConfig, layer: ConvLayer) -> float:
    """Best-achievable PE count: cap(mesh_x) * cap(mesh_y) over the layer's
    divisor structure (scalar reference for the vectorized bound)."""
    v = 2 * (hw.df_fh == 2) + (hw.df_fw == 2)
    table = _caps_for(tuple(layer.dim(d) for d in DIMS))[v]
    ax = table[np.searchsorted(table, hw.pe_mesh_x, side="right") - 1]
    ay = table[np.searchsorted(table, hw.pe_mesh_y, side="right") - 1]
    return float(ax * ay)


def hw_bound_vec(hw: HardwareConfig) -> np.ndarray:
    """(11,) bound constants for one config (see B_* column layout)."""
    e = hw.energy
    return np.array(
        [e.mac, e.lb, e.noc, hw.gb_access_energy, e.dram,
         hw.gb_bandwidth, hw.dram_bandwidth,
         hw.pe_mesh_x, hw.pe_mesh_y, hw.df_fw, hw.df_fh],
        dtype=np.float64,
    )


def hw_bound_vecs(hws) -> np.ndarray:
    """(n, 11) stacked bound constants for a hardware pool."""
    return np.stack([hw_bound_vec(hw) for hw in hws])


def layer_bound_vec(layer: ConvLayer) -> np.ndarray:
    """(2,) layer constants: [macs, traffic_lb]."""
    return np.array([layer.macs, traffic_lower_bound(layer)], dtype=np.float64)


def layer_bound_vecs(layers) -> np.ndarray:
    """(L, 2) stacked layer constants for the pool x layers bound matrix."""
    return np.stack([layer_bound_vec(layer) for layer in layers])


def layer_caps(layers) -> np.ndarray:
    """(L, 4, A) stacked per-variant spatial-cap tables, layer rows padded (by
    repeating their max) to one shared width -- the vectorized twins select
    rows by each config's dataflow variant and take the largest entry <= each
    mesh axis."""
    tables = [spatial_caps(layer) for layer in layers]
    width = max(t.shape[1] for t in tables)
    return np.stack([
        np.concatenate(
            [t, np.repeat(t[:, -1:], width - t.shape[1], axis=1)], axis=1)
        for t in tables
    ])


def lower_bound(hw: HardwareConfig, layer: ConvLayer) -> float:
    """Scalar reference bound (see module docstring for the derivation)."""
    with trace.span("cost_model.bound"):
        e = hw.energy
        macs = float(layer.macs)
        traffic = traffic_lower_bound(layer)
        energy = (macs * e.mac
                  + (4.0 * macs + traffic) * e.lb
                  + traffic * (e.noc + hw.gb_access_energy + e.dram))
        delay = max(macs / used_pes_cap(hw, layer),
                    traffic / hw.gb_bandwidth,
                    traffic / hw.dram_bandwidth)
        return energy * delay


def edp_lower_bounds(hws, layers) -> np.ndarray:
    """(n_hw, L) bound matrix over a hardware pool x layer stack (NumPy)."""
    from repro_torch.timeloop.batch import edp_lower_bounds_batch

    return edp_lower_bounds_batch(
        hw_bound_vecs(hws), layer_bound_vecs(layers), layer_caps(layers))
