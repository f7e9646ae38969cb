"""Hardware parameterization (paper appendix Fig. 6 / Fig. 7).

A design point fixes:
  H1/H2   PE mesh-X / mesh-Y            (H1 * H2 == num_pes)
  H3-H5   local-buffer partition        (input/weight/output entries, sum <= budget)
  H6-H8   global-buffer instances/mesh  (H7 * H8 == H6, H7 | H1, H8 | H2)
  H9/H10  global-buffer block / cluster (factors of 16)
  H11/H12 dataflow options              (1 = free, 2 = filter dim pinned in PE)

The compute (num_pes) and total storage budgets are fixed to the Eyeriss baseline,
matching the paper's "same compute and storage resource constraints" setup.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.timeloop.workloads import divisors


@dataclasses.dataclass(frozen=True)
class EnergyTable:
    """Energy per access (pJ), Eyeriss-relative (Chen et al. 2016, Table II)."""

    mac: float = 1.0
    lb: float = 1.0       # per-PE register-file/scratchpad access
    noc: float = 2.0      # global buffer -> PE network hop
    gb: float = 6.0       # global buffer access
    dram: float = 200.0   # off-chip DRAM access


@dataclasses.dataclass(frozen=True)
class HardwareConfig:
    # Fixed resource budgets (Eyeriss-equivalent).
    num_pes: int = 168
    lb_budget: int = 512          # local-buffer entries per PE (H3+H4+H5 <= this)
    gb_entries: int = 55296       # global-buffer capacity in words (108KB / 2B)
    dram_bandwidth: float = 16.0  # words / cycle

    # H1-H12 searchable parameters.
    pe_mesh_x: int = 12           # H1
    pe_mesh_y: int = 14           # H2
    lb_input: int = 192           # H3
    lb_weight: int = 224          # H4
    lb_output: int = 96           # H5
    gb_instances: int = 1         # H6
    gb_mesh_x: int = 1            # H7
    gb_mesh_y: int = 1            # H8
    gb_block: int = 4             # H9 (words per GB entry row -> read width)
    gb_cluster: int = 1           # H10 (entries ganged into wider structures)
    df_fw: int = 1                # H11 (2 => filter width pinned in PE: S_lb == S)
    df_fh: int = 1                # H12 (2 => filter height pinned in PE: R_lb == R)

    energy: EnergyTable = dataclasses.field(default_factory=EnergyTable)

    @property
    def gb_bandwidth(self) -> float:
        """Words/cycle deliverable by the global buffer to the PE array."""
        return float(self.gb_block * self.gb_cluster * self.gb_instances)

    @property
    def gb_access_energy(self) -> float:
        """Per-word GB energy; wider/ganged reads amortize the access cost."""
        width = self.gb_block * self.gb_cluster
        # Access energy grows ~sqrt(width) for the wider row, amortized over width.
        return self.energy.gb * (width ** 0.5) / width


def hw_from_tuple(t) -> HardwareConfig:
    """Rebuild a `HardwareConfig` from its `dataclasses.astuple` image (the
    wire form persisted by `repro.service.store`).  The last field is the
    nested `EnergyTable`, which `astuple` recurses into -- a naive
    `HardwareConfig(*t)` would hand the energy slot a plain tuple."""
    return HardwareConfig(*t[:-1], energy=EnergyTable(*t[-1]))


def hw_is_valid(hw: HardwareConfig) -> tuple[bool, str]:
    """Known (input) hardware constraints from appendix Fig. 7."""
    if hw.pe_mesh_x * hw.pe_mesh_y != hw.num_pes:
        return False, "pe_mesh"
    if hw.lb_input + hw.lb_weight + hw.lb_output > hw.lb_budget:
        return False, "lb_budget"
    if min(hw.lb_input, hw.lb_weight, hw.lb_output) < 1:
        return False, "lb_partition"
    if hw.gb_mesh_x * hw.gb_mesh_y != hw.gb_instances:
        return False, "gb_mesh"
    if hw.pe_mesh_x % hw.gb_mesh_x or hw.pe_mesh_y % hw.gb_mesh_y:
        return False, "gb_mesh_divides_pe_mesh"
    if 16 % hw.gb_block or 16 % hw.gb_cluster:
        return False, "gb_block_cluster"
    if hw.df_fw not in (1, 2) or hw.df_fh not in (1, 2):
        return False, "dataflow_option"
    return True, "ok"


def sample_hardware_pool(
    rng, n: int, num_pes: int = 168, base: HardwareConfig | None = None
) -> list[HardwareConfig]:
    """Draw n structurally-valid hardware points with array-vectorized
    parameter sampling (the batched-protocol pool path of `HardwareSpace`):
    every random draw is a whole-(n,) array op, so building the outer BO
    loop's 150-candidate pools stops paying per-candidate RNG/python cost.

    Every draw satisfies `hw_is_valid` by construction (mesh products and the
    LB composition are exact, block/cluster come from divisors of 16), like
    the scalar `sample_hardware` -- no rejection round is needed."""
    base = base or HardwareConfig(num_pes=num_pes)
    if base.lb_budget < 3:
        # Cannot compose the budget into 3 positive parts; fail loudly like
        # the scalar sampler (whose no-replacement choice raises) instead of
        # spinning in the distinct-cut redraw below.
        raise ValueError(
            f"lb_budget must be >= 3 to split into I/W/O, got {base.lb_budget}")
    mesh_divs = np.asarray(divisors(num_pes), dtype=np.int64)
    mx = rng.choice(mesh_divs, size=n)
    my = num_pes // mx
    # LB partition: random composition of the budget into 3 positive parts
    # (two distinct cut points; equal pairs are redrawn, which matches
    # choice-without-replacement in distribution).
    a = rng.integers(1, base.lb_budget, size=n)
    b = rng.integers(1, base.lb_budget, size=n)
    clash = a == b
    while clash.any():
        b[clash] = rng.integers(1, base.lb_budget, size=int(clash.sum()))
        clash = a == b
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    # GB mesh divisor picks are ragged per row (divisors of mx/my), so draw a
    # uniform variate per row and index each row's divisor list with it.
    u_gx, u_gy = rng.random(n), rng.random(n)
    gx = np.empty(n, dtype=np.int64)
    gy = np.empty(n, dtype=np.int64)
    for i in range(n):
        dx = divisors(int(mx[i]))
        dy = divisors(int(my[i]))
        gx[i] = dx[int(u_gx[i] * len(dx))]
        gy[i] = dy[int(u_gy[i] * len(dy))]
    blocks = np.asarray([1, 2, 4, 8, 16], dtype=np.int64)
    gb_block = rng.choice(blocks, size=n)
    gb_cluster = rng.choice(blocks, size=n)
    df_fw = rng.choice(np.asarray([1, 2]), size=n)
    df_fh = rng.choice(np.asarray([1, 2]), size=n)
    return [
        dataclasses.replace(
            base,
            num_pes=num_pes,
            pe_mesh_x=int(mx[i]),
            pe_mesh_y=int(my[i]),
            lb_input=int(lo[i]),
            lb_weight=int(hi[i] - lo[i]),
            lb_output=int(base.lb_budget - hi[i]),
            gb_instances=int(gx[i] * gy[i]),
            gb_mesh_x=int(gx[i]),
            gb_mesh_y=int(gy[i]),
            gb_block=int(gb_block[i]),
            gb_cluster=int(gb_cluster[i]),
            df_fw=int(df_fw[i]),
            df_fh=int(df_fh[i]),
        )
        for i in range(n)
    ]


def sample_hardware(rng, num_pes: int = 168, base: HardwareConfig | None = None) -> HardwareConfig:
    """Draw a uniform random hardware point satisfying the *structural* constraints
    (mesh products); the capacity constraint is checked by hw_is_valid afterwards."""
    base = base or HardwareConfig(num_pes=num_pes)
    mesh_divs = divisors(num_pes)
    mx = int(rng.choice(mesh_divs))
    my = num_pes // mx
    # LB partition: random composition of the budget into 3 positive parts.
    cut = sorted(rng.choice(range(1, base.lb_budget), size=2, replace=False))
    li, lw, lo = cut[0], cut[1] - cut[0], base.lb_budget - cut[1]
    gx = int(rng.choice(divisors(mx)))
    gy = int(rng.choice(divisors(my)))
    return dataclasses.replace(
        base,
        num_pes=num_pes,
        pe_mesh_x=mx,
        pe_mesh_y=my,
        lb_input=int(li),
        lb_weight=int(lw),
        lb_output=int(lo),
        gb_instances=gx * gy,
        gb_mesh_x=gx,
        gb_mesh_y=gy,
        gb_block=int(rng.choice([1, 2, 4, 8, 16])),
        gb_cluster=int(rng.choice([1, 2, 4, 8, 16])),
        df_fw=int(rng.choice([1, 2])),
        df_fh=int(rng.choice([1, 2])),
    )
