"""EDP evaluation of a (hardware, mapping, layer) triple.

Access counting follows the Timeloop temporal-reuse rule: a tensor tile resident
at level L is refetched from its parent once per iteration of every *relevant*
loop at the parent level, and once per iteration of every irrelevant loop that is
ordered OUTSIDE at least one relevant loop (irrelevant loops nested inside all
relevant loops reuse the tile).  Outputs are read-modify-write: when reduction
loops re-visit an output tile, traffic counts 2*passes - 1 (the first pass only
writes).

Energy  = macs*e_mac + lb*e_lb + noc*e_noc + gb*e_gb + dram*e_dram   [pJ]
Delay   = max(compute, gb_traffic/gb_bw, dram_traffic/dram_bw)       [cycles]
EDP     = energy * delay                                             [pJ*cycles]
"""

from __future__ import annotations

import dataclasses

from repro_torch import trace
from repro_torch.timeloop.arch import HardwareConfig
from repro_torch.timeloop.mapping import Mapping, gb_tiles, lb_tiles, mapping_is_valid
from repro_torch.timeloop.workloads import DIMS, RELEVANCE, ConvLayer


@dataclasses.dataclass(frozen=True)
class Evaluation:
    energy_pj: float
    delay_cycles: float
    edp: float
    valid: bool
    reason: str
    breakdown: dict


def _level_trips(order: tuple[str, ...], factors: dict[str, int], relevant: frozenset) -> int:
    """Iterations at one temporal level that force a refetch of the child tile."""
    active = [d for d in order if factors.get(d, 1) > 1]
    if not any(d in relevant for d in active):
        return 1
    innermost_rel = max(i for i, d in enumerate(active) if d in relevant)
    trips = 1
    for i, d in enumerate(active):
        if d in relevant or i < innermost_rel:
            trips *= factors[d]
    return trips


def _passes(order: tuple[str, ...], factors: dict[str, int], tensor: str) -> int:
    """For outputs: number of reduction passes forced at this level (loops over
    reduction dims ordered outside the output-relevant loops)."""
    if tensor != "O":
        return 1
    rel = RELEVANCE["O"]
    active = [d for d in order if factors.get(d, 1) > 1]
    rel_positions = [i for i, d in enumerate(active) if d in rel]
    anchor = min(rel_positions) if rel_positions else len(active)
    passes = 1
    for i, d in enumerate(active):
        if d not in rel and i < anchor:
            passes *= factors[d]
    return passes


def evaluate(hw: HardwareConfig, m: Mapping, layer: ConvLayer) -> Evaluation:
    """The mapping's energy, delay and EDP on `hw`, in a
    `cost_model.scalar` span."""
    with trace.span("cost_model.scalar"):
        return _evaluate(hw, m, layer)


def _evaluate(hw: HardwareConfig, m: Mapping, layer: ConvLayer) -> Evaluation:
    ok, reason = mapping_is_valid(m, hw, layer)
    if not ok:
        return Evaluation(float("inf"), float("inf"), float("inf"), False, reason, {})

    e = hw.energy
    macs = layer.macs
    used_pes = m.used_pes

    lb = lb_tiles(m, layer)
    gb = gb_tiles(m, layer)

    f_gb = {d: m.f("gb", d) for d in DIMS}
    f_dram = {d: m.f("dram", d) for d in DIMS}
    sp = {d: m.f("sx", d) * m.f("sy", d) for d in DIMS}

    lb_acc = 0.0
    noc_acc = 0.0
    gb_acc = 0.0
    dram_acc = 0.0

    for t in ("W", "I", "O"):
        rel = RELEVANCE[t]
        # Refetches of the per-PE LB tile from the GB, per GB-tile residency.
        gb_trips = _level_trips(m.order_gb, f_gb, rel)
        # Refetches of the GB tile from DRAM.
        dram_trips = _level_trips(m.order_dram, f_dram, rel)
        # Spatial multicast: PEs along spatially-unrolled *irrelevant* dims share
        # the same data -> one GB read feeds them all; relevant spatial dims need
        # distinct data per PE.
        sp_rel = 1
        sp_all = 1
        for d in DIMS:
            sp_all *= sp[d]
            if d in rel:
                sp_rel *= sp[d]

        fills_lb = lb[t] * gb_trips * dram_trips  # per spatial instance group
        rw = 1.0
        if t == "O":
            gb_passes = _passes(m.order_gb, f_gb, t)
            rw = 2.0 * gb_passes - 1.0
        gb_acc += fills_lb * sp_rel * rw
        noc_acc += fills_lb * sp_all * rw
        lb_acc += fills_lb * sp_all * rw  # writes into LB on fill / drain

        fills_gb = gb[t] * dram_trips
        rw_d = 1.0
        if t == "O":
            dram_passes = _passes(m.order_dram, f_dram, t)
            rw_d = 2.0 * dram_passes - 1.0
        dram_acc += fills_gb * rw_d

    # Per-MAC operand traffic inside the PE (read W, read I, RMW O).
    lb_acc += 4.0 * macs

    energy = (
        macs * e.mac
        + lb_acc * e.lb
        + noc_acc * e.noc
        + gb_acc * hw.gb_access_energy
        + dram_acc * e.dram
    )

    compute_cycles = macs / used_pes
    gb_cycles = gb_acc / hw.gb_bandwidth
    dram_cycles = dram_acc / hw.dram_bandwidth
    delay = max(compute_cycles, gb_cycles, dram_cycles)
    edp = energy * delay

    return Evaluation(
        energy_pj=energy,
        delay_cycles=delay,
        edp=edp,
        valid=True,
        reason="ok",
        breakdown={
            "macs": macs,
            "used_pes": used_pes,
            "lb_accesses": lb_acc,
            "noc_accesses": noc_acc,
            "gb_accesses": gb_acc,
            "dram_accesses": dram_acc,
            "compute_cycles": compute_cycles,
            "gb_cycles": gb_cycles,
            "dram_cycles": dram_cycles,
        },
    )
