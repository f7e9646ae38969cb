"""Workload zoo + portfolio co-design.

Two halves, layered on the search core (`repro_torch.core`):

- `zoo`: converts any `ModelConfig` in `repro_torch.configs` into a named
  `ConvLayer` workload set (attention projections, MoE expert FFNs, recurrent
  gate matmuls, the rglru temporal conv) via a per-block-kind extractor
  registry, MACs-cross-checked against `repro_torch.models.flops.forward_flops`.
- `portfolio`: one hardware config scored against a weighted mix of workload
  sets -- each outer trial fans the union of all members' layers into ONE
  stacked inner dispatch, scored by weighted-sum log-EDP, Pareto front in
  `CoDesignResult.stats`.
"""

from repro_torch.workloads.portfolio import (PortfolioConfig, PortfolioSession,
                                       make_portfolio_engine,
                                       portfolio_codesign, portfolio_session)
from repro_torch.workloads.zoo import (MACS_RTOL, ZOO_NAMES, ZooWorkload,
                                 known_workloads, resolve_workload,
                                 workload_set, zoo_workload)

__all__ = [
    "MACS_RTOL",
    "ZOO_NAMES",
    "ZooWorkload",
    "known_workloads",
    "resolve_workload",
    "workload_set",
    "zoo_workload",
    "PortfolioConfig",
    "PortfolioSession",
    "make_portfolio_engine",
    "portfolio_codesign",
    "portfolio_session",
]
