"""Learner-side executors for stacked inner-search dispatch.

The actor/learner split of the co-design stack: the *learner* process owns
every outer GP, acquisition, and session state machine; *executors* decide
where the embarrassingly-parallel inner work -- whole stacked k*L-run
software searches, packaged as pickle-safe `FanoutSearchSpec`s -- actually
runs.  Content-derived probe seeds (`CodesignEngine.probe_seed`) make
evaluation order and placement free variables, so moving a spec between
processes cannot change results; worker-count invariance against the
goldens is pinned in `tests/test_torch_executor.py`.

Two implementations share one small interface (`submit`/`ready`/`run`/
`close`, see `Executor`):

  `InlineExecutor`   runs every spec synchronously in the learner process.
                     Zero overhead, zero processes -- the default.
  `ProcessExecutor`  a pool of persistent spawn-started worker processes
                     (`repro_torch.parallel.workers.worker_main`) pulling
                     specs from a task queue.  Each submitted spec is split
                     into per-worker chunks (`ExecutorConfig.chunk_items`)
                     and reassembled in item order.  Every worker runs its
                     searches on the spec's `engine.device`, in a CUDA
                     context of its own.

Spawn, never fork: a forked child would inherit the parent's CUDA state
(see `workers.py`, which checks the invariant).  Before the pool starts on a
CUDA torch-engine spec, the learner builds (or finds built) the cost-model
kernel's library, so the workers load it and none runs nvcc.
"""

from __future__ import annotations

import dataclasses
import multiprocessing as mp
import queue as _queue
from typing import Any

from repro_torch.core.config import ExecutorConfig
from repro_torch.parallel import workers as _workers


class Executor:
    """Interface: where a `FanoutSearchSpec` runs.

    submit(job_id, spec)   enqueue one spec; results surface via `ready`
    ready(block=False)     completed jobs as `[(job_id, entries), ...]`,
                           oldest first; block=True waits until at least one
                           job completes (no-op when nothing is in flight)
    run(spec)              synchronous convenience: submit + wait, returning
                           the entries directly (other in-flight jobs keep
                           their results queued for `ready`)
    close()                stop workers, if any; idempotent
    """

    kind = "base"

    def submit(self, job_id, spec) -> None:
        raise NotImplementedError

    def ready(self, block: bool = False) -> list[tuple[Any, list]]:
        raise NotImplementedError

    def run(self, spec) -> list:
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError


class InlineExecutor(Executor):
    """Run every spec synchronously in the calling (learner) process."""

    kind = "inline"

    def __init__(self) -> None:
        self._finished: list[tuple[Any, list]] = []

    def submit(self, job_id, spec) -> None:
        self._finished.append((job_id, spec.run()))

    def ready(self, block: bool = False) -> list[tuple[Any, list]]:
        out, self._finished = self._finished, []
        return out

    def run(self, spec) -> list:
        return spec.run()

    def close(self) -> None:
        pass


def _chunk_spec(spec, n_workers: int, chunk_items: int) -> list:
    """Split one spec into item-contiguous chunks (order-preserving).

    chunk_items <= 0 splits evenly across the pool.  An unsplit spec keeps
    its `pad_to` (the bucketed width only matters for a whole stack); chunks
    drop it -- padding replays run 0 and is sliced off, so presence or
    absence never changes returned entries.
    """
    n = len(spec.items)
    if chunk_items <= 0:
        chunk_items = max(1, -(-n // max(1, n_workers)))
    if chunk_items >= n:
        return [spec]
    return [dataclasses.replace(spec, items=spec.items[i:i + chunk_items],
                                seeds=spec.seeds[i:i + chunk_items],
                                pad_to=None)
            for i in range(0, n, chunk_items)]


def _prebuild_kernels(spec) -> None:
    """Build the cost-model kernel's library in the learner before a pool
    that will run `spec` on a CUDA device starts, so that every worker loads
    the built library instead of running nvcc itself."""
    engine = spec.engine
    if engine is None or engine.backend != "torch" \
            or not str(engine.device).startswith("cuda"):
        return
    from repro_torch.kernels import build

    build.build_all(("edp_reduce",))


class ProcessExecutor(Executor):
    """Persistent spawn-started worker pool behind two mp queues.

    Workers start lazily on first use and survive across jobs (one-time
    interpreter + import cost per worker, amortized over the pool's life),
    each with an equal share of the learner's torch intra-op threads.
    Chunk results are reassembled by (job_id, chunk_idx) in item order, so a
    job's entries come back exactly as an inline run would return them.
    Worker exceptions re-raise in the learner with the worker traceback.
    """

    kind = "process"

    def __init__(self, n_workers: int = 0, chunk_items: int = 0) -> None:
        self.n_workers = n_workers or ExecutorConfig().resolve_workers()
        self.chunk_items = chunk_items
        self._ctx = mp.get_context("spawn")
        self._procs: list = []
        self._tq = self._rq = None
        self._njobs = 0
        # job_id -> {"n": chunk count, "parts": {chunk_idx: payload}}
        self._pending: dict[Any, dict] = {}
        self._finished: list[tuple[Any, list]] = []

    # --- pool lifecycle ---------------------------------------------------------

    def _ensure_started(self) -> None:
        if self._procs:
            return
        import torch

        self._tq = self._ctx.Queue()
        self._rq = self._ctx.Queue()
        # Each worker takes an equal share of the learner's intra-op threads.
        n_threads = max(1, torch.get_num_threads() // self.n_workers)
        for _ in range(self.n_workers):
            p = self._ctx.Process(target=_workers.worker_main,
                                  args=(self._tq, self._rq, n_threads),
                                  daemon=True)
            p.start()
            self._procs.append(p)

    def close(self) -> None:
        if not self._procs:
            return
        for _ in self._procs:
            self._tq.put(None)
        for p in self._procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
        self._procs = []
        for q in (self._tq, self._rq):
            q.close()
            q.cancel_join_thread()
        self._tq = self._rq = None
        self._pending.clear()

    def _check_alive(self) -> None:
        dead = [p for p in self._procs if not p.is_alive()]
        if dead and self._pending:
            codes = [p.exitcode for p in dead]
            raise RuntimeError(
                f"{len(dead)} executor worker(s) died (exit codes {codes}) "
                "with work in flight")

    # --- result plumbing --------------------------------------------------------

    def _accept(self, msg) -> None:
        jid, idx, status, payload = msg
        if status == "error":
            err, tb = payload
            self._pending.pop(jid, None)
            raise RuntimeError(
                f"executor worker task failed: {err}\n--- worker traceback "
                f"---\n{tb}")
        job = self._pending.get(jid)
        if job is None:  # a chunk of a job that already failed
            return
        job["parts"][idx] = payload
        if len(job["parts"]) == job["n"]:
            del self._pending[jid]
            if job.get("raw"):  # single-part non-list payload (probe)
                self._finished.append((jid, job["parts"][0]))
            else:
                self._finished.append(
                    (jid,
                     [e for i in range(job["n"]) for e in job["parts"][i]]))

    def _drain(self) -> None:
        while True:
            try:
                msg = self._rq.get(False)
            except _queue.Empty:
                return
            self._accept(msg)

    def _pump_until(self, pred) -> None:
        self._drain()
        while not pred():
            if not self._pending:
                raise RuntimeError(
                    "executor wait condition cannot be satisfied: no work "
                    "in flight")
            try:
                msg = self._rq.get(True, 1.0)
            except _queue.Empty:
                self._check_alive()
                continue
            self._accept(msg)

    # --- Executor interface -----------------------------------------------------

    def submit(self, job_id, spec) -> None:
        if job_id in self._pending:
            raise ValueError(f"job id {job_id!r} already in flight")
        if not self._procs:
            _prebuild_kernels(spec)
        self._ensure_started()
        chunks = _chunk_spec(spec, self.n_workers, self.chunk_items)
        self._pending[job_id] = {"n": len(chunks), "parts": {}}
        for idx, chunk in enumerate(chunks):
            self._tq.put(("search", job_id, idx, chunk))

    def ready(self, block: bool = False) -> list[tuple[Any, list]]:
        if block and not self._finished and self._pending:
            self._pump_until(lambda: bool(self._finished))
        else:
            self._drain()
        out, self._finished = self._finished, []
        return out

    def _wait(self, jid) -> Any:
        while True:
            for i, (j, payload) in enumerate(self._finished):
                if j == jid:
                    del self._finished[i]
                    return payload
            self._pump_until(
                lambda: any(j == jid for j, _ in self._finished))

    def run(self, spec) -> list:
        jid = ("_run", self._njobs)
        self._njobs += 1
        self.submit(jid, spec)
        return self._wait(jid)

    def _send_probe(self, hold: float):
        jid = ("_probe", self._njobs)
        self._njobs += 1
        self._pending[jid] = {"n": 1, "parts": {}, "raw": True}
        self._tq.put(("probe", jid, 0, hold))
        return jid

    def probe(self) -> dict:
        """State snapshot from one worker (the hygiene surface: boot-time
        modules and CUDA state, and its K1b launches so far)."""
        self._ensure_started()
        return self._wait(self._send_probe(0.0))

    def probe_all(self) -> list[dict]:
        """One snapshot per worker, by PID.  Probes go out one per worker
        and each worker pauses half a second after answering, so the next
        probe finds another worker idle; rounds repeat (at most 8) until
        every worker has answered."""
        self._ensure_started()
        seen: dict[int, dict] = {}
        for _ in range(8):
            jids = [self._send_probe(0.5) for _ in range(self.n_workers)]
            for jid in jids:
                report = self._wait(jid)
                seen.setdefault(report["pid"], report)
            if len(seen) == self.n_workers:
                break
        return [seen[pid] for pid in sorted(seen)]


def make_executor(cfg: ExecutorConfig | None = None) -> Executor:
    """Build the executor an `ExecutorConfig` describes."""
    cfg = cfg if cfg is not None else ExecutorConfig()
    if cfg.kind == "inline":
        return InlineExecutor()
    return ProcessExecutor(n_workers=cfg.resolve_workers(),
                           chunk_items=cfg.chunk_items)
