"""Where the co-design search's stacked inner searches run: the learner's own
process (`InlineExecutor`) or a pool of spawn-started worker processes
(`ProcessExecutor`, `workers.worker_main`)."""

from repro_torch.parallel.executor import (Executor, InlineExecutor,
                                           ProcessExecutor, make_executor)

__all__ = ["Executor", "InlineExecutor", "ProcessExecutor", "make_executor"]
