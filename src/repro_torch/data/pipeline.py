"""Deterministic synthetic token pipeline with per-host sharding and
double-buffered prefetch (a copy of `repro.data.pipeline`: NumPy only, so the
batches are bit-equal to the reference's for every (seed, step, host)).

Real deployments swap `SyntheticSource` for a file-backed source; the iterator
contract (`next() -> {tokens, labels, ...}` numpy dict) and the prefetch/shard
machinery stay the same.  Data order is a pure function of (seed, step), which
is what makes checkpoint-restart exactly reproducible: resuming at step k
replays the same batch k.
"""

from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    num_hosts: int = 1
    host_id: int = 0


class SyntheticSource:
    """Markov-chain token stream: deterministic, seeded, non-trivial statistics
    (so losses actually decrease during the examples' training runs)."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, data: DataConfig):
        self.cfg, self.shape, self.data = cfg, shape, data
        self.V = cfg.vocab_size
        rng = np.random.default_rng(data.seed)
        k = 97  # latent states
        self._emit = rng.integers(0, self.V, size=(k,), dtype=np.int32)
        self._trans = rng.integers(0, k, size=(k, 7), dtype=np.int32)

    def batch(self, step: int) -> dict:
        cfg, shape, data = self.cfg, self.shape, self.data
        B = shape.global_batch // data.num_hosts
        S = shape.seq_len
        rng = np.random.default_rng(
            (data.seed * 1_000_003 + step) * 131 + data.host_id)
        state = rng.integers(0, self._trans.shape[0], size=(B,))
        toks = np.empty((B, S + 1), np.int32)
        for t in range(S + 1):
            toks[:, t] = self._emit[state]
            state = self._trans[state, rng.integers(0, 7, size=(B,))]
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.input_mode == "embeddings":
            emb_rng = np.random.default_rng(data.seed * 7 + step)
            batch["embeddings"] = emb_rng.standard_normal(
                (B, S, cfg.d_model), dtype=np.float32)
            del batch["tokens"]
        if cfg.family == "encdec":
            emb_rng = np.random.default_rng(data.seed * 13 + step)
            batch["src_embeddings"] = emb_rng.standard_normal(
                (B, max(S // 8, 16), cfg.d_model), dtype=np.float32)
            batch["tokens"] = toks[:, :-1]
        return batch


class Prefetcher:
    """Background-thread double buffering over any `batch(step)` source."""

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self.source = source
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.source.batch(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __next__(self):
        step, batch = self._q.get()
        return step, batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
