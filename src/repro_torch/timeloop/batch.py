"""Vectorized batch evaluation engine for the co-design hot path.

The nested search (paper §4.1) evaluates `n_hw x n_layers x 250` inner BO
trials, and every trial samples and scores a ~150-candidate mapping pool.  The
scalar path in `model.py` / `mapping.py` walks Python dicts and string-keyed
lookups one mapping at a time, which makes the *analytical model* — not the GP —
the wall-clock bottleneck.  This module packs whole candidate pools into NumPy
arrays and evaluates them in one shot:

  MappingBatch.factors      int64 (B, 5, 6)   blocking factors, indexed
                                              [batch, level, dim] with levels in
                                              `mapping.LEVELS` order
                                              (lb, sx, sy, gb, dram) and dims in
                                              `workloads.DIMS` order (R S P Q C K)
  MappingBatch.order_*      int64 (B, 6)      loop orders as dim-index
                                              permutations, outermost first

On top of that encoding it provides vectorized twins of the scalar reference:

  lb_tiles_batch / gb_tiles_batch   <->  mapping.lb_tiles / gb_tiles
  valid_batch                       <->  mapping.mapping_is_valid
  level_trips_batch / passes_batch  <->  model._level_trips / model._passes
  evaluate_batch                    <->  model.evaluate  (EDP / energy / delay)
  features_batch                    <->  swspace.SoftwareSpace.features

All are bit-for-bit parity-tested against the scalar reference in
`tests/test_batch.py` (to 1e-9 relative error; the only divergence source is
float64 rounding where the scalar path used exact Python ints).

Everything is plain NumPy so it runs fast on CPU with no compile latency; the
encoding is deliberately device-friendly (fixed-shape int arrays, no ragged
structures), so the torch engine (`batch_torch`) reuses it unchanged.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.timeloop.arch import HardwareConfig
from repro_torch.timeloop.mapping import LEVELS, Mapping, sample_constrained_batch
from repro_torch.timeloop.workloads import DIMS, RELEVANCE, ConvLayer

# Level indices into MappingBatch.factors (LEVELS order: lb, sx, sy, gb, dram).
L_LB, L_SX, L_SY, L_GB, L_DRAM = range(len(LEVELS))
# Dim indices (DIMS order: R, S, P, Q, C, K).
D_R, D_S, D_P, D_Q, D_C, D_K = range(len(DIMS))

# Boolean relevance masks in DIMS order, per tensor.
REL_MASKS = {
    t: np.array([d in RELEVANCE[t] for d in DIMS], dtype=bool)
    for t in ("W", "I", "O")
}
TENSORS = ("W", "I", "O")


@dataclasses.dataclass(frozen=True)
class MappingBatch:
    """A pool of B mappings in packed array form (see module docstring)."""

    factors: np.ndarray     # (B, 5, 6) int64
    order_lb: np.ndarray    # (B, 6) int64 dim indices, outermost first
    order_gb: np.ndarray    # (B, 6)
    order_dram: np.ndarray  # (B, 6)

    def __len__(self) -> int:
        return self.factors.shape[0]

    def __getitem__(self, i: int) -> Mapping:
        """Unpack row i into a scalar `Mapping`."""
        return Mapping(
            factors=tuple(tuple(int(x) for x in row) for row in self.factors[i]),
            order_lb=tuple(DIMS[j] for j in self.order_lb[i]),
            order_gb=tuple(DIMS[j] for j in self.order_gb[i]),
            order_dram=tuple(DIMS[j] for j in self.order_dram[i]),
        )

    def take(self, idx) -> "MappingBatch":
        """Row-subset (fancy-index) view of the pool."""
        return MappingBatch(
            factors=self.factors[idx],
            order_lb=self.order_lb[idx],
            order_gb=self.order_gb[idx],
            order_dram=self.order_dram[idx],
        )


def pack(mappings: list[Mapping] | tuple[Mapping, ...]) -> MappingBatch:
    """Pack scalar `Mapping`s into a `MappingBatch`."""
    dim_idx = {d: j for j, d in enumerate(DIMS)}
    factors = np.array([m.factors for m in mappings], dtype=np.int64)
    if factors.size == 0:
        factors = factors.reshape(0, len(LEVELS), len(DIMS))

    def orders(attr):
        return np.array(
            [[dim_idx[d] for d in getattr(m, attr)] for m in mappings],
            dtype=np.int64,
        ).reshape(len(mappings), len(DIMS))

    return MappingBatch(factors, orders("order_lb"), orders("order_gb"),
                        orders("order_dram"))


def concat(batches: list[MappingBatch]) -> MappingBatch:
    return MappingBatch(
        factors=np.concatenate([b.factors for b in batches], axis=0),
        order_lb=np.concatenate([b.order_lb for b in batches], axis=0),
        order_gb=np.concatenate([b.order_gb for b in batches], axis=0),
        order_dram=np.concatenate([b.order_dram for b in batches], axis=0),
    )


# --- tile sizes ----------------------------------------------------------------

def _tiles(f: np.ndarray, layer: ConvLayer) -> np.ndarray:
    """Per-tensor tile sizes (B, 3) [W, I, O] from per-dim factors f (B, 6).

    `ConvLayer.input_extent` is pure arithmetic, so it broadcasts over arrays —
    the halo formula stays defined in exactly one place.
    """
    r, s, p, q, c, k = (f[:, j] for j in range(6))
    return np.stack(
        [
            r * s * c * k,
            layer.input_extent(p, r) * layer.input_extent(q, s) * c,
            p * q * k,
        ],
        axis=1,
    )


def lb_tiles_batch(mb: MappingBatch, layer: ConvLayer) -> np.ndarray:
    """(B, 3) [W, I, O] tile sizes resident in one PE's local buffer."""
    return _tiles(mb.factors[:, L_LB, :], layer)


def gb_tiles_batch(mb: MappingBatch, layer: ConvLayer) -> np.ndarray:
    """(B, 3) [W, I, O] tile sizes resident in the global buffer."""
    cum = mb.factors[:, : L_GB + 1, :].prod(axis=1)
    return _tiles(cum, layer)


# --- validity ------------------------------------------------------------------

def _valid_from_tiles(
    mb: MappingBatch,
    hw: HardwareConfig,
    layer: ConvLayer,
    lb: np.ndarray,
    gb: np.ndarray,
) -> np.ndarray:
    """Validity given precomputed lb/gb tile arrays (lets evaluate_batch reuse
    the tiles it needs anyway instead of recomputing them)."""
    dims = np.array([layer.dim(d) for d in DIMS], dtype=np.int64)
    ok = (mb.factors.prod(axis=1) == dims[None, :]).all(axis=1)
    if hw.df_fw == 2:
        ok &= mb.factors[:, L_LB, D_S] == layer.S
    if hw.df_fh == 2:
        ok &= mb.factors[:, L_LB, D_R] == layer.R
    ok &= lb[:, 0] <= hw.lb_weight
    ok &= lb[:, 1] <= hw.lb_input
    ok &= lb[:, 2] <= hw.lb_output
    ok &= gb.sum(axis=1) <= hw.gb_entries
    ok &= mb.factors[:, L_SX, :].prod(axis=1) <= hw.pe_mesh_x
    ok &= mb.factors[:, L_SY, :].prod(axis=1) <= hw.pe_mesh_y
    return ok


def valid_batch(mb: MappingBatch, hw: HardwareConfig, layer: ConvLayer) -> np.ndarray:
    """(B,) bool — vectorized twin of `mapping_is_valid`."""
    return _valid_from_tiles(
        mb, hw, layer, lb_tiles_batch(mb, layer), gb_tiles_batch(mb, layer)
    )


# --- trip counts ---------------------------------------------------------------

_POS = np.arange(len(DIMS))


def level_trips_batch(order: np.ndarray, f: np.ndarray, rel: np.ndarray) -> np.ndarray:
    """Vectorized `_level_trips`: (B,) refetch-forcing iterations per level.

    order: (B, 6) dim-index permutation, outermost first.
    f:     (B, 6) per-dim factors at this level (DIMS order).
    rel:   (6,) bool relevance mask (DIMS order).

    Filtering to active (factor > 1) loops preserves order, so the scalar
    "position within the active list" comparisons are equivalent to raw
    position comparisons here; inactive loops contribute factor 1 anyway.
    """
    fo = np.take_along_axis(f, order, axis=1)        # factors in loop order
    rel_o = rel[order]                               # relevance in loop order
    rel_active = rel_o & (fo > 1)
    has_rel = rel_active.any(axis=1)
    innermost = np.where(rel_active, _POS[None, :], -1).max(axis=1)
    include = rel_o | (_POS[None, :] < innermost[:, None])
    trips = np.where(include, fo, 1).prod(axis=1)
    return np.where(has_rel, trips, 1)


def passes_batch(order: np.ndarray, f: np.ndarray) -> np.ndarray:
    """Vectorized `_passes` for outputs: (B,) reduction passes at this level."""
    rel = REL_MASKS["O"]
    fo = np.take_along_axis(f, order, axis=1)
    rel_o = rel[order]
    rel_active = rel_o & (fo > 1)
    anchor = np.where(rel_active, _POS[None, :], len(DIMS)).min(axis=1)
    include = (~rel_o) & (_POS[None, :] < anchor[:, None])
    return np.where(include, fo, 1).prod(axis=1)


# --- EDP evaluation ------------------------------------------------------------

def evaluate_batch(
    hw: HardwareConfig, mb: MappingBatch, layer: ConvLayer
) -> dict[str, np.ndarray]:
    """Vectorized `model.evaluate` over the whole pool.

    Returns float64 arrays keyed `energy_pj`, `delay_cycles`, `edp` (inf on
    invalid rows) and a bool array `valid`.
    """
    lb_int = lb_tiles_batch(mb, layer)
    gb_int = gb_tiles_batch(mb, layer)
    valid = _valid_from_tiles(mb, hw, layer, lb_int, gb_int)
    e = hw.energy
    macs = float(layer.macs)
    used_pes = (
        mb.factors[:, L_SX, :].prod(axis=1) * mb.factors[:, L_SY, :].prod(axis=1)
    ).astype(np.float64)

    lb = lb_int.astype(np.float64)
    gb = gb_int.astype(np.float64)

    f_gb = mb.factors[:, L_GB, :]
    f_dram = mb.factors[:, L_DRAM, :]
    sp = mb.factors[:, L_SX, :] * mb.factors[:, L_SY, :]
    sp_all = sp.prod(axis=1).astype(np.float64)

    lb_acc = np.zeros(len(mb))
    noc_acc = np.zeros(len(mb))
    gb_acc = np.zeros(len(mb))
    dram_acc = np.zeros(len(mb))

    for ti, t in enumerate(TENSORS):
        rel = REL_MASKS[t]
        gb_trips = level_trips_batch(mb.order_gb, f_gb, rel).astype(np.float64)
        dram_trips = level_trips_batch(mb.order_dram, f_dram, rel).astype(np.float64)
        sp_rel = np.where(rel[None, :], sp, 1).prod(axis=1).astype(np.float64)

        fills_lb = lb[:, ti] * gb_trips * dram_trips
        if t == "O":
            rw = 2.0 * passes_batch(mb.order_gb, f_gb) - 1.0
        else:
            rw = 1.0
        gb_acc += fills_lb * sp_rel * rw
        noc_acc += fills_lb * sp_all * rw
        lb_acc += fills_lb * sp_all * rw

        fills_gb = gb[:, ti] * dram_trips
        if t == "O":
            rw_d = 2.0 * passes_batch(mb.order_dram, f_dram) - 1.0
        else:
            rw_d = 1.0
        dram_acc += fills_gb * rw_d

    lb_acc += 4.0 * macs

    energy = (
        macs * e.mac
        + lb_acc * e.lb
        + noc_acc * e.noc
        + gb_acc * hw.gb_access_energy
        + dram_acc * e.dram
    )
    with np.errstate(divide="ignore", invalid="ignore"):
        compute_cycles = macs / used_pes
    delay = np.maximum(
        compute_cycles,
        np.maximum(gb_acc / hw.gb_bandwidth, dram_acc / hw.dram_bandwidth),
    )
    edp = energy * delay

    inf = np.float64(np.inf)
    return {
        "energy_pj": np.where(valid, energy, inf),
        "delay_cycles": np.where(valid, delay, inf),
        "edp": np.where(valid, edp, inf),
        "valid": valid,
    }


# --- EDP lower bounds (bound-and-prune pass) -------------------------------------

def edp_lower_bounds_batch(hwb: np.ndarray, layb: np.ndarray,
                           caps: np.ndarray) -> np.ndarray:
    """(n_hw, L) provable EDP lower bounds over a pool x layer stack.

    `hwb` is the (n, 11) matrix of `bounds.hw_bound_vecs` -- the `edp_reduce`
    consts block [e_mac, e_lb, e_noc, e_gb_acc, e_dram, gb_bw, dram_bw] with
    mesh shape + dataflow pins appended -- `layb` the (L, 2)
    [macs, traffic_lb] matrix of `bounds.layer_bound_vecs`, and `caps` the
    (L, 4, A) sorted spatial-cap tables of `bounds.layer_caps` (one row per
    dataflow variant).  Whole-array twin of `bounds.lower_bound` (derivation
    there), parity-pinned in tests/test_bounds.py.
    """
    hwb = np.asarray(hwb, np.float64)
    layb = np.asarray(layb, np.float64)
    caps = np.asarray(caps, np.float64)
    e_mac, e_lb, e_noc, e_gb, e_dram, gb_bw, dram_bw = (
        hwb[:, j:j + 1] for j in range(7))
    mx, my = hwb[:, 7], hwb[:, 8]
    # dataflow variant per config: v = 2*(df_fh==2) + (df_fw==2)
    v = (2 * (hwb[:, 10] == 2.0) + (hwb[:, 9] == 2.0)).astype(np.intp)
    capsel = caps[:, v, :]  # (L, n, A): each config's variant row, per layer
    # largest achievable spatial product <= each mesh axis (tables contain 1)
    ax = np.max(np.where(capsel <= mx[None, :, None], capsel, 1.0), axis=-1)
    ay = np.max(np.where(capsel <= my[None, :, None], capsel, 1.0), axis=-1)
    used = (ax * ay).T  # (n, L) best-achievable PE count
    macs, traffic = layb[:, 0][None, :], layb[:, 1][None, :]
    energy = (macs * e_mac + (4.0 * macs + traffic) * e_lb
              + traffic * (e_noc + e_gb + e_dram))
    delay = np.maximum(macs / used,
                       np.maximum(traffic / gb_bw, traffic / dram_bw))
    return energy * delay


# --- features ------------------------------------------------------------------

def features_batch(
    mb: MappingBatch, hw: HardwareConfig, layer: ConvLayer
) -> np.ndarray:
    """(B, 14) feature matrix — vectorized `SoftwareSpace.features`."""
    lb = lb_tiles_batch(mb, layer).astype(np.float64)
    gb = gb_tiles_batch(mb, layer).astype(np.float64)
    f_gb = mb.factors[:, L_GB, :]
    f_dram = mb.factors[:, L_DRAM, :]
    trips = [
        np.log1p(level_trips_batch(order, f, REL_MASKS[t]).astype(np.float64))
        for f, order in ((f_gb, mb.order_gb), (f_dram, mb.order_dram))
        for t in TENSORS
    ]
    sx = mb.factors[:, L_SX, :].prod(axis=1).astype(np.float64)
    sy = mb.factors[:, L_SY, :].prod(axis=1).astype(np.float64)
    used = sx * sy
    cols = [
        lb[:, 1] / hw.lb_input,
        lb[:, 0] / hw.lb_weight,
        lb[:, 2] / hw.lb_output,
        gb.sum(axis=1) / hw.gb_entries,
        sx / hw.pe_mesh_x,
        sy / hw.pe_mesh_y,
        *trips,
        np.log1p(used),
        np.log1p(layer.macs / used),
    ]
    return np.stack(cols, axis=1)


# --- pool sampling -------------------------------------------------------------

# Pools requested of `sample_valid_pool`, mappings it drew and valid ones it
# returned, since the process started: the `inner.sample` spans carry their
# change (`pool_counts_since`).
_POOL_COUNTS = [0, 0, 0]


def pool_counts() -> tuple[int, int, int]:
    """(pools, drawn, kept) so far."""
    return tuple(_POOL_COUNTS)


def pool_counts_since(before: tuple[int, int, int]) -> dict[str, int]:
    """Pools, drawn and kept since `pool_counts()` returned `before`."""
    return {k: now - then for k, now, then in
            zip(("pools", "drawn", "kept"), _POOL_COUNTS, before)}


def _count_pool(drawn: int, kept: int) -> None:
    _POOL_COUNTS[0] += 1
    _POOL_COUNTS[1] += drawn
    _POOL_COUNTS[2] += kept


def sample_valid_pool(
    rng,
    hw: HardwareConfig,
    layer: ConvLayer,
    n: int,
    max_rounds: int = 64,
) -> MappingBatch | None:
    """Draw n *valid* mappings in vectorized rounds of constrained sampling.

    The constrained sampler enforces LB-capacity and mesh constraints during
    the draw; only GB capacity can still reject, so a couple of oversampled
    rounds normally suffice.  Returns None when the space looks empirically
    empty (the BO layer converts that into `InfeasibleSpace`).
    """
    if n <= 0:
        return pack([])
    kept: list[MappingBatch] = []
    have = 0
    drawn = 0
    for _ in range(max_rounds):
        if drawn == 0:
            draw = n
        else:
            # Oversample by the observed valid rate so one more round usually
            # finishes the pool; the floor keeps pathological rates bounded.
            rate = max(have / drawn, 0.02)
            draw = min(int((n - have) / rate * 1.25) + 1, 64 * n)
        mb = MappingBatch(*sample_constrained_batch(rng, hw, layer, draw))
        drawn += draw
        ok = valid_batch(mb, hw, layer)
        if ok.any():
            kept.append(mb.take(np.flatnonzero(ok)))
            have += int(ok.sum())
        if have >= n:
            _count_pool(drawn, n)
            full = kept[0] if len(kept) == 1 else concat(kept)
            return full.take(np.arange(n))
    _count_pool(drawn, 0)
    return None
