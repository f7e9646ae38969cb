"""The paper's contribution on PyTorch: nested constrained Bayesian
optimization for hardware/software co-design.

The search surface is the typed config API (`repro_torch.core.config`):
`CodesignConfig` (sw/hw/engine sections, JSON round-trip) run by a
`CodesignEngine`; `codesign(**legacy_kwargs)` remains as a deprecation shim.
The paper's baselines (`random_search`, `tvm_style_search`,
`relax_round_bo`) run on the same spaces.
"""

from repro_torch.core.config import (ACQUISITIONS, BACKENDS, EXECUTOR_KINDS,
                                     PRUNE_MODES, STRATEGIES, SURROGATES,
                                     CodesignConfig, EngineConfig,
                                     ExecutorConfig, HWSearchConfig,
                                     SearchConfig, ServiceConfig,
                                     SWSearchConfig,
                                     config_from_legacy_kwargs)
from repro_torch.core.cache import LRUCache, SlotCache, counters_snapshot
from repro_torch.core.gp import GP, GPClassifier, GPClassifierStack, GPStack
from repro_torch.core.acquisition import (expected_improvement, lcb,
                                          make_acquisition,
                                          make_acquisition_device)
from repro_torch.core.bo import (BOLoop, BOResult, FanoutSearchSpec,
                                 bo_maximize, bo_maximize_many, score_topk)
from repro_torch.core.swspace import (LayerStackSpace, SoftwareSpace,
                                      fanout_spaces)
from repro_torch.core.hwspace import HardwareSpace
from repro_torch.core.nested import (PROBE_STRATEGIES, CoDesignResult,
                                     CodesignEngine, LayerBatchedProbes,
                                     ProbeFanoutProbes, ProbeStrategy,
                                     SearchSession, SequentialProbes,
                                     SpeculativeProbes, codesign,
                                     optimize_software,
                                     optimize_software_fanout,
                                     optimize_software_many)
from repro_torch.core.baselines import (random_search, relax_round_bo,
                                        tvm_style_search)
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
    "ServiceConfig",
    "SWSearchConfig",
    "config_from_legacy_kwargs",
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
    "FanoutSearchSpec",
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
    "codesign",
    "optimize_software",
    "optimize_software_fanout",
    "optimize_software_many",
    "random_search",
    "relax_round_bo",
    "tvm_style_search",
    "GradientBoostedTrees",
    "RandomForestSurrogate",
]
