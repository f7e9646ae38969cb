"""Eyeriss baseline configurations and the heuristic baseline mapper.

The paper's baseline is the hand-designed Eyeriss accelerator (168 PEs; 256 for
the Transformer) with software mappings found by Timeloop's heuristic random
mapper.  We reproduce that: the canonical Eyeriss hardware point plus a
seeded constrained random search with a generous sample budget standing in for
the hand-tuned mapping.
"""

from __future__ import annotations

import numpy as np

from repro_torch.timeloop.arch import HardwareConfig
from repro_torch.timeloop.mapping import (Mapping, constrained_random_mapping,
                                    mapping_is_valid, random_mapping)
from repro_torch.timeloop.model import Evaluation, evaluate
from repro_torch.timeloop.workloads import ConvLayer


def eyeriss_168() -> HardwareConfig:
    """Eyeriss v1: 12x14 PE array, 108KB global buffer, RF split I/W/O."""
    return HardwareConfig(
        num_pes=168,
        pe_mesh_x=12,
        pe_mesh_y=14,
        lb_input=192,
        lb_weight=224,
        lb_output=96,
        gb_entries=55296,
        gb_instances=1,
        gb_mesh_x=1,
        gb_mesh_y=1,
        gb_block=4,
        gb_cluster=1,
        df_fw=1,
        df_fh=1,
    )


def eyeriss_256() -> HardwareConfig:
    """The larger Eyeriss configuration used for the Transformer (Parashar 2019)."""
    return HardwareConfig(
        num_pes=256,
        pe_mesh_x=16,
        pe_mesh_y=16,
        lb_input=192,
        lb_weight=224,
        lb_output=96,
        gb_entries=65536,
        gb_instances=1,
        gb_mesh_x=1,
        gb_mesh_y=1,
        gb_block=4,
        gb_cluster=1,
        df_fw=1,
        df_fh=1,
    )


def baseline_mapper(
    hw: HardwareConfig,
    layer: ConvLayer,
    budget: int = 2000,
    seed: int = 0,
) -> tuple[Mapping | None, Evaluation | None]:
    """Timeloop-style heuristic random mapper: constraint-pruned random search
    (Timeloop's mapper prunes capacity-invalid tilings before evaluation),
    keeping the best feasible mapping found within `budget` samples."""
    rng = np.random.default_rng(seed)
    best_m, best_e = None, None
    for _ in range(budget):
        m = constrained_random_mapping(rng, hw, layer)
        ok, _ = mapping_is_valid(m, hw, layer)
        if not ok:
            continue
        ev = evaluate(hw, m, layer)
        if best_e is None or ev.edp < best_e.edp:
            best_m, best_e = m, ev
    return best_m, best_e


def eyeriss_baseline_edp(
    layers: list[ConvLayer],
    num_pes: int = 168,
    budget: int = 2000,
    seed: int = 0,
) -> dict[str, float]:
    """Per-layer baseline EDP for a model's layers on the Eyeriss config."""
    hw = eyeriss_168() if num_pes == 168 else eyeriss_256()
    out = {}
    for layer in layers:
        _, ev = baseline_mapper(hw, layer, budget=budget, seed=seed)
        out[layer.name] = ev.edp if ev is not None else float("inf")
    return out
