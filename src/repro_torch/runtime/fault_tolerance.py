"""Fault tolerance for the training loop (the port of
`repro.runtime.fault_tolerance`).

Three mechanisms:

* `ResilientLoop` -- wraps the step function; on failure (device error,
  preemption signal, injected fault) it restores the latest checkpoint and
  replays from there.  Because the data pipeline is a pure function of step
  and the step itself is deterministic (K3 and K3-bwd use no atomics),
  replay is bit-deterministic.
* `StragglerMonitor` -- per-step wall-time EMA + z-score; flags outlier steps
  (on real clusters this feeds the scheduler to hot-swap slow hosts; here it
  logs and counts).

* `elastic_remesh` -- re-plans the mesh for a changed device count and
  re-traces the step function; the state is laid out replicated on the new
  mesh (elastic scale-up/down between checkpoint boundaries).

Like the reference, the loop retries on any `RuntimeError`; PyTorch raises
CUDA errors as `RuntimeError`s, so a fault that persists is retried
`max_retries` times and then raised.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np

from repro_torch.checkpoint import checkpoint as ckpt


class InjectedFault(RuntimeError):
    """Stand-in for a device failure / preemption in tests and examples."""


@dataclasses.dataclass
class StragglerMonitor:
    alpha: float = 0.1
    z_threshold: float = 4.0
    mean: float = 0.0
    var: float = 0.0
    n: int = 0
    flagged: int = 0

    def observe(self, dt: float) -> bool:
        self.n += 1
        if self.n == 1:
            self.mean, self.var = dt, 0.0
            return False
        z = (dt - self.mean) / (np.sqrt(self.var) + 1e-9)
        is_straggler = self.n > 5 and z > self.z_threshold
        if is_straggler:
            self.flagged += 1
        else:  # don't poison the EMA with outliers
            d = dt - self.mean
            self.mean += self.alpha * d
            self.var = (1 - self.alpha) * (self.var + self.alpha * d * d)
        return is_straggler


@dataclasses.dataclass
class ResilientLoop:
    """Checkpoint/restart training loop.  After `run`, `saver` is the
    run's `AsyncCheckpointer` (its `save_seconds` time each save)."""

    step_fn: Callable          # (state, batch) -> (state, metrics); may raise
    source: object             # .batch(step) -> host batch
    ckpt_dir: str
    save_every: int = 50
    max_retries: int = 5
    saver: ckpt.AsyncCheckpointer | None = dataclasses.field(
        default=None, init=False, repr=False)

    def run(self, state, start_step: int, num_steps: int,
            fault_schedule: set | None = None, log: Callable | None = None):
        """Runs steps [start_step, start_step+num_steps); `fault_schedule` is a
        set of step indices at which an InjectedFault fires once (tests)."""
        saver = self.saver = ckpt.AsyncCheckpointer(self.ckpt_dir)
        monitor = StragglerMonitor()
        initial_state = state
        fired: set = set()
        step = start_step
        retries = 0
        metrics_log = []
        while step < start_step + num_steps:
            try:
                if fault_schedule and step in fault_schedule and step not in fired:
                    fired.add(step)
                    raise InjectedFault(f"injected fault at step {step}")
                t0 = time.perf_counter()
                batch = self.source.batch(step)
                state, metrics = self.step_fn(state, batch)
                dt = time.perf_counter() - t0
                straggler = monitor.observe(dt)
                metrics = dict(metrics, step=step, dt=dt, straggler=straggler)
                metrics_log.append(metrics)
                if log:
                    log(metrics)
                step += 1
                retries = 0
                if step % self.save_every == 0:
                    saver.save(step, state)
            except (InjectedFault, RuntimeError) as e:
                retries += 1
                if retries > self.max_retries:
                    raise
                saver.wait()  # an in-flight save may land the newest checkpoint
                restored = ckpt.latest_step(self.ckpt_dir)
                if restored is not None:
                    state, rstep = ckpt.restore(self.ckpt_dir, state)
                    step = rstep
                else:
                    state, step = initial_state, start_step  # replay from scratch
                if log:
                    log({"event": "restart", "from_step": step, "error": str(e)})
        saver.save(step, state)
        saver.wait()
        return state, step, metrics_log, monitor


def elastic_remesh(make_mesh: Callable, lower_fn: Callable, state,
                   new_device_count: int):
    """Re-plan for a changed device count: build the new mesh
    (`make_mesh(n)`, e.g. `launch.mesh.make_mesh_for`), re-trace the step
    function (`lower_fn(mesh)`), and lay the state out replicated on it
    (each DTensor gathered whole on its old mesh first; plain tensors as
    they are).  Returns (mesh, lowered, state)."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

    mesh = make_mesh(new_device_count)
    lowered = lower_fn(mesh)

    def put(t):
        if isinstance(t, dict):
            return {k: put(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(put(v) for v in t)
        if not isinstance(t, torch.Tensor):
            return t
        full = t.full_tensor() if isinstance(t, DTensor) else t
        return distribute_tensor(full, mesh, [Replicate()] * mesh.ndim)

    return mesh, lowered, put(state)
