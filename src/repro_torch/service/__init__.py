"""Co-design as a service (paper workloads, many tenants, one device).

`CodesignService` admits co-design requests (layers + `CodesignConfig`, as
objects or JSON) into concurrent `SearchSession` slots, fuses their pending
inner software searches into one cross-request stacked dispatch per tick, and
persists every finished (hw, layer) search in a content-addressed
`DesignStore` so overlapping or repeated workloads skip re-searching.
Per-request results are bit-identical to standalone `CodesignEngine.run`
(see `repro_torch.service.scheduler` for the two scope notes).
"""

from repro_torch.core.config import ExecutorConfig, ServiceConfig
from repro_torch.parallel.executor import (InlineExecutor, ProcessExecutor,
                                     make_executor)
from repro_torch.service.scheduler import (CodesignService, ServiceRequest,
                                     ServiceResponse)
from repro_torch.service.store import (DesignStore, TrialHistory, design_key,
                                 history_key)
from repro_torch.workloads.portfolio import PortfolioConfig

__all__ = [
    "CodesignService",
    "DesignStore",
    "PortfolioConfig",
    "ExecutorConfig",
    "InlineExecutor",
    "ProcessExecutor",
    "ServiceConfig",
    "ServiceRequest",
    "ServiceResponse",
    "TrialHistory",
    "design_key",
    "history_key",
    "make_executor",
]
