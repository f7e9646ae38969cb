"""Analytical accelerator cost model (Timeloop-style), reimplemented from scratch.

The model follows the abstractions of Parashar et al. (ISPASS 2019) as used by the
paper: a 7-level conv loop nest is mapped onto a 3-level storage hierarchy
(DRAM -> global buffer -> per-PE local buffers) with a 2D spatial PE array in
between.  Energy is per-level access counts times a per-level energy table; delay
is the max of compute and per-level bandwidth bottlenecks; the objective is the
energy-delay product (EDP).
"""

from repro_torch.timeloop.workloads import (ConvLayer, PAPER_WORKLOADS,
                                      MODEL_LAYERS, SAMPLER_DIVISOR_CAP,
                                      divisors, sampler_divisors)
from repro_torch.timeloop.arch import HardwareConfig, EnergyTable, hw_is_valid
from repro_torch.timeloop.mapping import (Mapping, mapping_is_valid, random_mapping,
                                    sample_constrained_batch)
from repro_torch.timeloop.model import evaluate, Evaluation
from repro_torch.timeloop.batch import (MappingBatch, evaluate_batch, features_batch,
                                  pack, sample_valid_pool, valid_batch)
from repro_torch.timeloop.eyeriss import (
    eyeriss_168,
    eyeriss_256,
    eyeriss_baseline_edp,
    baseline_mapper,
)

__all__ = [
    "ConvLayer",
    "PAPER_WORKLOADS",
    "MODEL_LAYERS",
    "SAMPLER_DIVISOR_CAP",
    "divisors",
    "sampler_divisors",
    "HardwareConfig",
    "EnergyTable",
    "hw_is_valid",
    "Mapping",
    "mapping_is_valid",
    "random_mapping",
    "sample_constrained_batch",
    "evaluate",
    "Evaluation",
    "MappingBatch",
    "evaluate_batch",
    "features_batch",
    "pack",
    "sample_valid_pool",
    "valid_batch",
    "eyeriss_168",
    "eyeriss_256",
    "eyeriss_baseline_edp",
    "baseline_mapper",
]
