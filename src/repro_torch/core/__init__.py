"""The paper's contribution on PyTorch: nested constrained Bayesian
optimization for hardware/software co-design.

The search surface is the typed config API (`repro_torch.core.config`):
`CodesignConfig` (sw/hw/engine sections, JSON round-trip) run by a
`CodesignEngine`.
"""

from repro_torch.core.config import (ACQUISITIONS, BACKENDS, EXECUTOR_KINDS,
                                     PRUNE_MODES, STRATEGIES, SURROGATES,
                                     CodesignConfig, EngineConfig,
                                     ExecutorConfig, HWSearchConfig,
                                     SearchConfig, SWSearchConfig)
from repro_torch.core.cache import LRUCache, SlotCache, counters_snapshot
from repro_torch.core.gp import GP, GPClassifier, GPClassifierStack, GPStack
from repro_torch.core.acquisition import (expected_improvement, lcb,
                                          make_acquisition,
                                          make_acquisition_device)
from repro_torch.core.bo import (BOLoop, BOResult, bo_maximize,
                                 bo_maximize_many, score_topk)
from repro_torch.core.swspace import (LayerStackSpace, SoftwareSpace,
                                      fanout_spaces)
from repro_torch.core.hwspace import HardwareSpace
from repro_torch.core.nested import (PROBE_STRATEGIES, CoDesignResult,
                                     CodesignEngine, LayerBatchedProbes,
                                     ProbeFanoutProbes, ProbeStrategy,
                                     SearchSession, SequentialProbes,
                                     SpeculativeProbes, optimize_software,
                                     optimize_software_fanout,
                                     optimize_software_many)
from repro_torch.core.trees import GradientBoostedTrees, RandomForestSurrogate

__all__ = [
    "ACQUISITIONS",
    "BACKENDS",
    "EXECUTOR_KINDS",
    "PRUNE_MODES",
    "STRATEGIES",
    "SURROGATES",
    "CodesignConfig",
    "EngineConfig",
    "ExecutorConfig",
    "HWSearchConfig",
    "SearchConfig",
    "SWSearchConfig",
    "LRUCache",
    "SlotCache",
    "counters_snapshot",
    "GP",
    "GPClassifier",
    "GPClassifierStack",
    "GPStack",
    "expected_improvement",
    "lcb",
    "make_acquisition",
    "make_acquisition_device",
    "BOLoop",
    "BOResult",
    "bo_maximize",
    "bo_maximize_many",
    "score_topk",
    "LayerStackSpace",
    "SoftwareSpace",
    "fanout_spaces",
    "HardwareSpace",
    "PROBE_STRATEGIES",
    "CoDesignResult",
    "CodesignEngine",
    "SearchSession",
    "LayerBatchedProbes",
    "ProbeFanoutProbes",
    "ProbeStrategy",
    "SequentialProbes",
    "SpeculativeProbes",
    "optimize_software",
    "optimize_software_fanout",
    "optimize_software_many",
    "GradientBoostedTrees",
    "RandomForestSurrogate",
]
