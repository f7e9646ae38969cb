"""Worker-process side of the learner/worker executor (`repro_torch.parallel`).

One `worker_main` loop runs in each spawn-started process of a
`ProcessExecutor` pool: pull a task from the shared queue, execute it, push
`(job_id, chunk_idx, status, payload)` back.  Tasks are whole stacked
k*L-run inner searches (`FanoutSearchSpec`, see `repro_torch.core.bo`) --
exactly the items a `SearchSession.pending()` emits, with their
content-derived seeds -- so the learner process keeps every outer
GP/acquisition/session state machine and workers only ever run
embarrassingly-parallel inner work.

Module contract: **stdlib-only at import time**.  Workers start from a clean
interpreter, and two invariants hold when a worker boots, before its first
search:

  * no `jax` module and no module of the reference package `repro` is
    loaded (the port imports neither; a worker is a port process);
  * no CUDA context is inherited: `torch.cuda.is_initialized()` is False.
    A fork-started child would copy the parent's CUDA state, which CUDA
    does not support in a child; a spawned worker opens its own context on
    the engine's device at its first search.

`ProcessExecutor` always uses the spawn start method, and `worker_main`
refuses to run searches in a fork-started child -- one where this module was
imported by a *different* process (the PID sentinel below).  The "probe"
task returns the boot-time snapshot of both invariants, the state now, and
the worker's launches of kernel K1b (`cost_forward.launches`), which the
learner cannot count itself.
"""

from __future__ import annotations

import os
import sys
import time
import traceback

# Fork-detection sentinel: a spawn-started worker re-imports this module in
# its own process (PID matches at `worker_main` time); a fork-started child
# inherits the parent's import (PID mismatch) -- and with it the parent's
# CUDA state.
_IMPORT_PID = os.getpid()


def _modules(root: str) -> list[str]:
    return sorted(m for m in sys.modules
                  if m == root or m.startswith(root + "."))


def _cuda_initialized() -> bool:
    torch = sys.modules.get("torch")
    return bool(torch is not None and torch.cuda.is_initialized())


def _boot_state(forked: bool) -> dict:
    """The invariants as the worker found them at start."""
    return {"forked": forked, "jax_modules": _modules("jax"),
            "repro_modules": _modules("repro"),
            "cuda_initialized": _cuda_initialized()}


def _probe_report(boot: dict) -> dict:
    """Boot-time and current state, for the hygiene checks and the learner's
    launch accounting."""
    forward = sys.modules.get("repro_torch.kernels.cost_forward")
    torch = sys.modules.get("torch")
    cuda_now = _cuda_initialized()
    return {
        "pid": os.getpid(),
        "boot": dict(boot),
        "jax_modules": _modules("jax"),
        "repro_modules": _modules("repro"),
        "cuda_initialized": cuda_now,
        "cost_forward_launches": (forward.cost_forward.launches
                                  if forward is not None else 0),
        "cuda_reserved_bytes": (torch.cuda.memory_reserved()
                                if cuda_now else 0),
    }


def _run_search(spec, boot: dict) -> list:
    if boot["forked"]:
        raise RuntimeError(
            "fork-started worker: ProcessExecutor workers must be spawn-"
            "started so that no CUDA context or module state of the parent "
            "is inherited")
    return spec.run()


def worker_main(task_q, result_q, n_threads: int = 1) -> None:
    """Persistent worker loop: runs until a `None` sentinel arrives.  The
    worker's torch takes `n_threads` intra-op threads (its share of the
    learner's, so that a pool does not oversubscribe the host's cores).

    Tasks are `(kind, job_id, chunk_idx, payload)` tuples:
      ("search", jid, idx, FanoutSearchSpec) -> list of (mapping, EDP) entries
      ("probe",  jid, idx, hold)             -> `_probe_report`, then a
                                                pause of `hold` seconds (so
                                                that probes sent together
                                                reach distinct workers)
    Results are `(job_id, chunk_idx, "ok", payload)` or
    `(job_id, chunk_idx, "error", (repr, traceback_text))` -- the learner
    re-raises errors with the worker traceback attached.
    """
    import torch  # importing torch opens no CUDA context

    torch.set_num_threads(max(1, n_threads))
    boot = _boot_state(forked=os.getpid() != _IMPORT_PID)
    while True:
        task = task_q.get()
        if task is None:
            return
        kind, jid, idx, payload = task
        try:
            if kind == "probe":
                out = _probe_report(boot)
                time.sleep(payload or 0.0)
            elif kind == "search":
                out = _run_search(payload, boot)
            else:
                raise ValueError(f"unknown worker task kind {kind!r}")
            result_q.put((jid, idx, "ok", out))
        except Exception as e:  # noqa: BLE001 -- report, keep serving
            result_q.put((jid, idx, "error",
                          (repr(e), traceback.format_exc())))
