"""The plain reference of the analytical cost model: a frozen copy, in plain
Python and NumPy, of the Timeloop-style EDP model the co-design search
scores mappings with (arXiv 2010.02075, Fig. 8-9 of the appendix), and of
the provable EDP lower bound the prune gate uses (arXiv 2203.13921).

It imports nothing of the program.  Hardware points and mappings arrive as
plain data: a hardware point is a dict of its searched fields, a mapping a
tuple `(factors, order_gb, order_dram)` with `factors[level][dim]` in
`LEVELS` x `DIMS` order and each order a tuple of dim letters, outermost
first.  The budgets and the energy table come from the configuration file,
never from the program's objects.

Energy = macs*e_mac + lb*e_lb + noc*e_noc + gb*e_gb + dram*e_dram   [pJ]
Delay  = max(compute, gb_traffic/gb_bw, dram_traffic/dram_bw)       [cycles]
EDP    = energy * delay                                             [pJ*cycles]
"""

from __future__ import annotations

import math

DIMS = ("R", "S", "P", "Q", "C", "K")
LEVELS = ("lb", "sx", "sy", "gb", "dram")
RELEVANCE = {
    "W": frozenset({"R", "S", "C", "K"}),
    "I": frozenset({"R", "S", "P", "Q", "C"}),
    "O": frozenset({"P", "Q", "K"}),
}
# The searched hardware fields (appendix Fig. 6); the rest is the budget.
SEARCHED = ("pe_mesh_x", "pe_mesh_y", "lb_input", "lb_weight", "lb_output",
            "gb_instances", "gb_mesh_x", "gb_mesh_y", "gb_block",
            "gb_cluster", "df_fw", "df_fh")


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


def divisors(n: int) -> list[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def macs(layer: dict) -> int:
    return _prod(layer[d] for d in DIMS)


def _ext(layer: dict, p: int, r: int) -> int:
    return (p - 1) * layer["stride"] + r


def _f(factors, level: str, dim: str) -> int:
    return int(factors[LEVELS.index(level)][DIMS.index(dim)])


def _tiles(layer: dict, f: dict) -> dict:
    return {"W": f["R"] * f["S"] * f["C"] * f["K"],
            "I": _ext(layer, f["P"], f["R"]) * _ext(layer, f["Q"], f["S"])
            * f["C"],
            "O": f["P"] * f["Q"] * f["K"]}


def hw_is_valid(hw: dict, budget: dict) -> bool:
    """The hardware point's known constraints (appendix Fig. 7) under the
    configuration's budget."""
    return (hw["pe_mesh_x"] * hw["pe_mesh_y"] == budget["num_pes"]
            and hw["lb_input"] + hw["lb_weight"] + hw["lb_output"]
            <= budget["lb_budget"]
            and min(hw["lb_input"], hw["lb_weight"], hw["lb_output"]) >= 1
            and hw["gb_mesh_x"] * hw["gb_mesh_y"] == hw["gb_instances"]
            and hw["pe_mesh_x"] % hw["gb_mesh_x"] == 0
            and hw["pe_mesh_y"] % hw["gb_mesh_y"] == 0
            and 16 % hw["gb_block"] == 0 and 16 % hw["gb_cluster"] == 0
            and hw["df_fw"] in (1, 2) and hw["df_fh"] in (1, 2))


def mapping_is_valid(hw: dict, budget: dict, mapping, layer: dict) -> bool:
    factors = mapping[0]
    for di, d in enumerate(DIMS):
        if _prod(factors[li][di] for li in range(len(LEVELS))) != layer[d]:
            return False
    if hw["df_fw"] == 2 and _f(factors, "lb", "S") != layer["S"]:
        return False
    if hw["df_fh"] == 2 and _f(factors, "lb", "R") != layer["R"]:
        return False
    lb = _tiles(layer, {d: _f(factors, "lb", d) for d in DIMS})
    if (lb["I"] > hw["lb_input"] or lb["W"] > hw["lb_weight"]
            or lb["O"] > hw["lb_output"]):
        return False
    gb = _tiles(layer, {d: _prod(_f(factors, lvl, d)
                                 for lvl in LEVELS[:LEVELS.index("gb") + 1])
                        for d in DIMS})
    if gb["I"] + gb["W"] + gb["O"] > budget["gb_entries"]:
        return False
    sx = _prod(factors[LEVELS.index("sx")])
    sy = _prod(factors[LEVELS.index("sy")])
    return sx <= hw["pe_mesh_x"] and sy <= hw["pe_mesh_y"]


def _level_trips(order, factors: dict, relevant) -> int:
    """Iterations at one temporal level that force a refetch of the child
    tile: every relevant loop, and every irrelevant loop ordered outside the
    innermost relevant one."""
    active = [d for d in order if factors[d] > 1]
    if not any(d in relevant for d in active):
        return 1
    inner = max(i for i, d in enumerate(active) if d in relevant)
    trips = 1
    for i, d in enumerate(active):
        if d in relevant or i < inner:
            trips *= factors[d]
    return trips


def _passes(order, factors: dict) -> int:
    """Output reduction passes at one level: reduction loops ordered outside
    every output-relevant loop."""
    rel = RELEVANCE["O"]
    active = [d for d in order if factors[d] > 1]
    anchor = min((i for i, d in enumerate(active) if d in rel),
                 default=len(active))
    passes = 1
    for i, d in enumerate(active):
        if d not in rel and i < anchor:
            passes *= factors[d]
    return passes


def gb_bandwidth(hw: dict) -> float:
    return float(hw["gb_block"] * hw["gb_cluster"] * hw["gb_instances"])


def gb_access_energy(hw: dict, energy: dict) -> float:
    width = hw["gb_block"] * hw["gb_cluster"]
    return energy["gb"] * (width ** 0.5) / width


def evaluate(hw: dict, budget: dict, mapping, layer: dict) -> float:
    """The mapping's EDP in pJ x cycles; inf where it is invalid."""
    if not mapping_is_valid(hw, budget, mapping, layer):
        return math.inf
    factors, order_gb, order_dram = mapping
    e = budget["energy"]
    n_macs = macs(layer)
    used = (_prod(factors[LEVELS.index("sx")])
            * _prod(factors[LEVELS.index("sy")]))
    lb = _tiles(layer, {d: _f(factors, "lb", d) for d in DIMS})
    gb = _tiles(layer, {d: _prod(_f(factors, lvl, d)
                                 for lvl in LEVELS[:LEVELS.index("gb") + 1])
                        for d in DIMS})
    f_gb = {d: _f(factors, "gb", d) for d in DIMS}
    f_dram = {d: _f(factors, "dram", d) for d in DIMS}
    sp = {d: _f(factors, "sx", d) * _f(factors, "sy", d) for d in DIMS}
    lb_acc = noc_acc = gb_acc = dram_acc = 0.0
    for t in ("W", "I", "O"):
        rel = RELEVANCE[t]
        gb_trips = _level_trips(order_gb, f_gb, rel)
        dram_trips = _level_trips(order_dram, f_dram, rel)
        sp_rel = sp_all = 1
        for d in DIMS:
            sp_all *= sp[d]
            if d in rel:
                sp_rel *= sp[d]
        fills_lb = lb[t] * gb_trips * dram_trips
        rw = 2.0 * _passes(order_gb, f_gb) - 1.0 if t == "O" else 1.0
        gb_acc += fills_lb * sp_rel * rw
        noc_acc += fills_lb * sp_all * rw
        lb_acc += fills_lb * sp_all * rw
        fills_gb = gb[t] * dram_trips
        rw_d = 2.0 * _passes(order_dram, f_dram) - 1.0 if t == "O" else 1.0
        dram_acc += fills_gb * rw_d
    lb_acc += 4.0 * n_macs
    energy = (n_macs * e["mac"] + lb_acc * e["lb"] + noc_acc * e["noc"]
              + gb_acc * gb_access_energy(hw, e) + dram_acc * e["dram"])
    delay = max(n_macs / used, gb_acc / gb_bandwidth(hw),
                dram_acc / budget["dram_bandwidth"])
    return energy * delay


def utility(edp: float) -> float:
    """The search's objective, -log10(EDP); -inf for an invalid mapping."""
    return -math.log10(edp) if math.isfinite(edp) else -math.inf


# --- the EDP lower bound of the prune gate -----------------------------------

def _touched(outputs: int, filt: int, stride: int) -> int:
    return min((outputs - 1) * stride + filt, outputs * filt)


def traffic_lower_bound(layer: dict) -> float:
    s = layer["stride"]
    weights = layer["R"] * layer["S"] * layer["C"] * layer["K"]
    outputs = layer["P"] * layer["Q"] * layer["K"]
    inputs = (_touched(layer["P"], layer["R"], s)
              * _touched(layer["Q"], layer["S"], s) * layer["C"])
    return float(weights + outputs + inputs)


def _spatial_cap(layer: dict, mesh: int, pin_r: bool, pin_s: bool) -> int:
    """The largest product of per-dim divisors (R left out when pinned by
    df_fh, S by df_fw) that fits one mesh axis."""
    prods = {1}
    for d in DIMS:
        if (d == "R" and pin_r) or (d == "S" and pin_s):
            continue
        prods |= {p * g for p in prods for g in divisors(layer[d])
                  if p * g <= mesh}
    return max(prods)


def lower_bound(hw: dict, budget: dict, layer: dict) -> float:
    """A bound below the EDP of every valid mapping of `layer` on `hw`:
    every word moved once, the best PE count the layer's divisors allow."""
    e = budget["energy"]
    n_macs = float(macs(layer))
    traffic = traffic_lower_bound(layer)
    pin_r, pin_s = hw["df_fh"] == 2, hw["df_fw"] == 2
    used = (_spatial_cap(layer, hw["pe_mesh_x"], pin_r, pin_s)
            * _spatial_cap(layer, hw["pe_mesh_y"], pin_r, pin_s))
    energy = (n_macs * e["mac"] + (4.0 * n_macs + traffic) * e["lb"]
              + traffic * (e["noc"] + gb_access_energy(hw, e) + e["dram"]))
    delay = max(n_macs / used, traffic / gb_bandwidth(hw),
                traffic / budget["dram_bandwidth"])
    return energy * delay
