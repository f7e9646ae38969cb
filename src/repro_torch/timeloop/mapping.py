"""Software-mapping parameterization (paper appendix Fig. 8 / Fig. 9).

A mapping factorizes every loop dim across four levels and fixes per-level loop
orders:

  S1-S6  blocking factors: dim = t_dram * t_gb * s_x * s_y * t_lb
         (s_x / s_y are the spatial `parallel_for` factors across the PE array)
  S7-S9  loop order (outermost-first permutation of DIMS) at LB, GB, DRAM

Validity (Fig. 9): per-dim factor products must equal the layer dims (guaranteed
constructively by the sampler), per-tensor LB tiles must fit the local sub-buffers,
the GB tile must fit the global buffer, and spatial factors must fit the PE mesh.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.timeloop.arch import HardwareConfig
from repro_torch.timeloop.workloads import DIMS, ConvLayer, sampler_divisors

LEVELS = ("lb", "sx", "sy", "gb", "dram")


@dataclasses.dataclass(frozen=True)
class Mapping:
    # factors[level][dim] -> int; levels as in LEVELS.
    factors: tuple[tuple[int, ...], ...]  # shape (5, 6), indexed [level][dim]
    order_lb: tuple[str, ...]             # S7: permutation of DIMS, outermost first
    order_gb: tuple[str, ...]             # S8
    order_dram: tuple[str, ...]           # S9

    def f(self, level: str, dim: str) -> int:
        return self.factors[LEVELS.index(level)][DIMS.index(dim)]

    def cum(self, dim: str, upto: str) -> int:
        """Product of factors at `upto` level and all levels below it."""
        out = 1
        for lvl in LEVELS[: LEVELS.index(upto) + 1]:
            out *= self.f(lvl, dim)
        return out

    @property
    def spatial_x(self) -> int:
        return _prod(self.factors[LEVELS.index("sx")])

    @property
    def spatial_y(self) -> int:
        return _prod(self.factors[LEVELS.index("sy")])

    @property
    def used_pes(self) -> int:
        return self.spatial_x * self.spatial_y


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


# --- tile sizes ----------------------------------------------------------------

def lb_tiles(m: Mapping, layer: ConvLayer) -> dict[str, int]:
    """Per-tensor tile sizes resident in one PE's local buffer."""
    r, s = m.f("lb", "R"), m.f("lb", "S")
    p, q = m.f("lb", "P"), m.f("lb", "Q")
    c, k = m.f("lb", "C"), m.f("lb", "K")
    return {
        "W": r * s * c * k,
        "I": layer.input_extent(p, r) * layer.input_extent(q, s) * c,
        "O": p * q * k,
    }


def gb_tiles(m: Mapping, layer: ConvLayer) -> dict[str, int]:
    """Per-tensor tile sizes resident in the global buffer (covers the PE array)."""
    r, s = m.cum("R", "gb"), m.cum("S", "gb")
    p, q = m.cum("P", "gb"), m.cum("Q", "gb")
    c, k = m.cum("C", "gb"), m.cum("K", "gb")
    return {
        "W": r * s * c * k,
        "I": layer.input_extent(p, r) * layer.input_extent(q, s) * c,
        "O": p * q * k,
    }


# --- validity -------------------------------------------------------------------

def mapping_is_valid(m: Mapping, hw: HardwareConfig, layer: ConvLayer) -> tuple[bool, str]:
    for di, d in enumerate(DIMS):
        prod = _prod(tuple(m.factors[li][di] for li in range(len(LEVELS))))
        if prod != layer.dim(d):
            return False, f"factorization:{d}"
    # Dataflow options pin filter dims entirely inside the PE (H11/H12).
    if hw.df_fw == 2 and m.f("lb", "S") != layer.S:
        return False, "dataflow_fw"
    if hw.df_fh == 2 and m.f("lb", "R") != layer.R:
        return False, "dataflow_fh"
    lb = lb_tiles(m, layer)
    if lb["I"] > hw.lb_input:
        return False, "lb_input"
    if lb["W"] > hw.lb_weight:
        return False, "lb_weight"
    if lb["O"] > hw.lb_output:
        return False, "lb_output"
    gb = gb_tiles(m, layer)
    if gb["I"] + gb["W"] + gb["O"] > hw.gb_entries:
        return False, "gb_capacity"
    if m.spatial_x > hw.pe_mesh_x:
        return False, "spatial_x"
    if m.spatial_y > hw.pe_mesh_y:
        return False, "spatial_y"
    return True, "ok"


# --- sampling --------------------------------------------------------------------

def _random_split(rng, n: int, parts: int) -> list[int]:
    """Random factorization of n into `parts` ordered factors (uniform over chains)."""
    out = []
    rem = n
    for i in range(parts - 1):
        d = sampler_divisors(rem)
        f = int(d[rng.integers(len(d))])
        out.append(f)
        rem //= f
    out.append(rem)
    return out


def random_mapping(rng, hw: HardwareConfig, layer: ConvLayer) -> Mapping:
    """Draw a structurally consistent mapping (factor products match the layer);
    capacity/spatial validity is NOT guaranteed -- callers rejection-sample."""
    per_level = {lvl: [1] * len(DIMS) for lvl in LEVELS}
    for di, d in enumerate(DIMS):
        n = layer.dim(d)
        if d == "S" and hw.df_fw == 2:
            lb, rest = n, 1
        elif d == "R" and hw.df_fh == 2:
            lb, rest = n, 1
        else:
            lb = int(sampler_divisors(n)[rng.integers(len(sampler_divisors(n)))])
            rest = n // lb
        sx, rest = _pick(rng, rest)
        sy, rest = _pick(rng, rest)
        gb, dram = _pick(rng, rest)
        per_level["lb"][di] = lb
        per_level["sx"][di] = sx
        per_level["sy"][di] = sy
        per_level["gb"][di] = gb
        per_level["dram"][di] = dram
    factors = tuple(tuple(per_level[lvl]) for lvl in LEVELS)
    return Mapping(
        factors=factors,
        order_lb=tuple(rng.permutation(DIMS)),
        order_gb=tuple(rng.permutation(DIMS)),
        order_dram=tuple(rng.permutation(DIMS)),
    )


def sample_constrained_batch(
    rng, hw: HardwareConfig, layer: ConvLayer, n: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized twin of `constrained_random_mapping`: draw a whole candidate
    pool in one shot.

    Returns packed arrays `(factors, order_lb, order_gb, order_dram)` with
    `factors` of shape (n, 5, 6) — levels in LEVELS order, dims in DIMS order —
    and each order an (n, 6) dim-index permutation, outermost first (the
    encoding consumed by `repro_torch.timeloop.batch.MappingBatch`).

    Semantics match the scalar sampler: dataflow pins are honored, LB-capacity
    and PE-mesh constraints are enforced *during* the draw (per-dim uniform
    choice over the feasible divisors of the remaining extent), and the GB/DRAM
    split is a uniform divisor pick — so only GB capacity can still reject.
    The one divergence is that the dim processing order is one random
    permutation shared across the batch rather than per-row (per-row orders
    would serialize the draw again); pool statistics are indistinguishable.
    """
    B = int(n)
    n_dims = len(DIMS)
    # LEVELS order: lb, sx, sy, gb, dram
    i_lb, i_sx, i_sy, i_gb, i_dram = range(len(LEVELS))
    factors = np.ones((B, len(LEVELS), n_dims), dtype=np.int64)
    rem = np.tile(
        np.array([layer.dim(d) for d in DIMS], dtype=np.int64), (B, 1)
    )
    divs = [np.array(sampler_divisors(layer.dim(d)), dtype=np.int64)
            for d in DIMS]

    pinned = [False] * n_dims
    if hw.df_fw == 2:
        si = DIMS.index("S")
        factors[:, i_lb, si] = layer.S
        rem[:, si] //= layer.S
        pinned[si] = True
    if hw.df_fh == 2:
        ri = DIMS.index("R")
        factors[:, i_lb, ri] = layer.R
        rem[:, ri] //= layer.R
        pinned[ri] = True

    def choose(D: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """Per-row uniform choice among masked candidates; 1 where none."""
        counts = mask.sum(axis=1)
        idx = np.minimum(
            (rng.random(B) * counts).astype(np.int64),
            np.maximum(counts - 1, 0),
        )
        cum = np.cumsum(mask, axis=1)
        sel = (cum > idx[:, None]).argmax(axis=1)
        return np.where(counts > 0, D[sel], 1)

    # --- LB factors: capacity-feasible divisor choice per dim.
    for di in rng.permutation(n_dims):
        if pinned[di]:
            continue
        D = divs[di]
        cand = (rem[:, di : di + 1] % D[None, :]) == 0
        cols = [factors[:, i_lb, j : j + 1] for j in range(n_dims)]
        cols[di] = np.broadcast_to(D[None, :], (B, len(D)))
        r, s, p, q, c, k = cols
        # layer.input_extent is pure arithmetic -> broadcasts over the
        # (rows, candidates) grid; same formula as the scalar validity check.
        ok = (
            (r * s * c * k <= hw.lb_weight)
            & (layer.input_extent(p, r) * layer.input_extent(q, s) * c
               <= hw.lb_input)
            & (p * q * k <= hw.lb_output)
        )
        f = choose(D, cand & ok)
        factors[:, i_lb, di] = f
        rem[:, di] //= f

    # --- Spatial factors: running-product bound by the PE mesh.
    for lvl, cap in ((i_sx, hw.pe_mesh_x), (i_sy, hw.pe_mesh_y)):
        for di in rng.permutation(n_dims):
            D = divs[di]
            budget = cap // factors[:, lvl, :].prod(axis=1)
            mask = ((rem[:, di : di + 1] % D[None, :]) == 0) & (
                D[None, :] <= budget[:, None]
            )
            f = choose(D, mask)
            factors[:, lvl, di] = f
            rem[:, di] //= f

    # --- GB / DRAM split of the remainder.
    for di in range(n_dims):
        D = divs[di]
        gb = choose(D, (rem[:, di : di + 1] % D[None, :]) == 0)
        factors[:, i_gb, di] = gb
        factors[:, i_dram, di] = rem[:, di] // gb

    def rand_orders() -> np.ndarray:
        return np.argsort(rng.random((B, n_dims)), axis=1).astype(np.int64)

    return factors, rand_orders(), rand_orders(), rand_orders()


def _pick(rng, n: int) -> tuple[int, int]:
    d = sampler_divisors(n)
    f = int(d[rng.integers(len(d))])
    return f, n // f


def constrained_random_mapping(rng, hw: HardwareConfig, layer: ConvLayer) -> Mapping:
    """Constraint-aware sampler implementing the paper's *input constraints*: the
    LB-capacity and spatial-mesh constraints are enforced during sampling (the
    paper's "valid ranges" depend on the hardware), so only the GB-capacity
    constraint can still reject.  This is the sampler used to build the
    150-candidate feasible pools for acquisition optimization."""
    per_level = {lvl: [1] * len(DIMS) for lvl in LEVELS}
    rem = {d: layer.dim(d) for d in DIMS}

    # --- LB factors: respect dataflow pins, then greedily bound by capacity.
    if hw.df_fw == 2:
        per_level["lb"][DIMS.index("S")] = layer.S
        rem["S"] //= layer.S
    if hw.df_fh == 2:
        per_level["lb"][DIMS.index("R")] = layer.R
        rem["R"] //= layer.R

    def tiles_ok(fl: list[int]) -> bool:
        r, s, p, q, c, k = fl
        if r * s * c * k > hw.lb_weight:
            return False
        if layer.input_extent(p, r) * layer.input_extent(q, s) * c > hw.lb_input:
            return False
        return p * q * k <= hw.lb_output

    dim_order = list(rng.permutation(len(DIMS)))
    for di in dim_order:
        d = DIMS[di]
        if (d == "S" and hw.df_fw == 2) or (d == "R" and hw.df_fh == 2):
            continue
        cands = []
        for f in sampler_divisors(rem[d]):
            trial = list(per_level["lb"])
            trial[di] = f
            if tiles_ok(trial):
                cands.append(f)
        f = int(cands[rng.integers(len(cands))]) if cands else 1
        per_level["lb"][di] = f
        rem[d] //= f

    # --- Spatial factors: running-product bound by the PE mesh.
    for axis, cap in (("sx", hw.pe_mesh_x), ("sy", hw.pe_mesh_y)):
        for di in rng.permutation(len(DIMS)):
            d = DIMS[di]
            budget = cap // _prod(per_level[axis])
            cands = [f for f in sampler_divisors(rem[d]) if f <= budget]
            f = int(cands[rng.integers(len(cands))])
            per_level[axis][di] = f
            rem[d] //= f

    # --- GB / DRAM split of the remainder.
    for di, d in enumerate(DIMS):
        gb, dram = _pick(rng, rem[d])
        per_level["gb"][di] = gb
        per_level["dram"][di] = dram

    factors = tuple(tuple(per_level[lvl]) for lvl in LEVELS)
    return Mapping(
        factors=factors,
        order_lb=tuple(rng.permutation(DIMS)),
        order_gb=tuple(rng.permutation(DIMS)),
        order_dram=tuple(rng.permutation(DIMS)),
    )
