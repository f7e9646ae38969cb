"""Checkpointing of the training state: per-leaf .npy files + JSON manifest,
step-tagged directories, atomic latest-pointer, optional async writer
thread (the port of `repro.checkpoint.checkpoint`, with its on-disk layout).

Layout:
    <dir>/step_00000123/manifest.json
    <dir>/step_00000123/leaf_00000.npy ...
    <dir>/LATEST                      (atomic rename -> crash-safe pointer)

A state is a nest of dicts (and lists or tuples) of tensors, such as the
trainer's {"params": {name: tensor}, "opt": {"mu": ..., "nu": ...,
"step": ...}}.  A leaf's path joins its keys with "/" in sorted-key order,
as the reference flattens its pytrees ("params/blocks.0.attn.wq",
"opt/step").  NumPy has no bfloat16, so a bf16 leaf is written as its bits
(int16) and the manifest names its dtype "bfloat16".  `restore` gives back
tensors on the devices and in the dtypes of `like`'s leaves.

Concurrent saves into one directory are safe: each save stages into a unique
temp directory (never a shared `<step>.tmp` name two writers would collide
on), publishes the step directory and the LATEST pointer with `os.replace`
under a per-directory lock, and LATEST only ever moves forward -- a slow
writer finishing an old step cannot point LATEST at it after a newer step
landed.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import time

import numpy as np
import torch

# Serializes the publish step (step-dir + LATEST rename) across threads of
# this process; cross-process writers are already safe through os.replace,
# the lock additionally keeps LATEST monotone among our own threads.
_publish_lock = threading.Lock()


def _flatten(tree, prefix=()):
    """[(path keys, leaf)] in sorted-key order (list and tuple items by
    index)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], prefix + (k,))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten(v, prefix + (i,))
        return out
    return [(prefix, tree)]


def _leaf_paths(tree):
    return [("/".join(str(k) for k in keys), leaf)
            for keys, leaf in _flatten(tree)]


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """A leaf as a host array to write and the dtype name for the
    manifest."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _host_copy(leaf):
    """A copy of a leaf on the host that later steps cannot change."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def save(directory: str, step: int, state) -> str:
    """Synchronous checkpoint save; returns the step directory."""
    os.makedirs(directory, exist_ok=True)
    step_dir = os.path.join(directory, f"step_{step:08d}")
    # Unique staging dir per save call: concurrent saves of the SAME step
    # (async writer + a late sync save, or two engines sharing a directory)
    # must not interleave writes into one tmp dir.
    tmp_dir = tempfile.mkdtemp(prefix=f"step_{step:08d}.tmp.", dir=directory)
    try:
        manifest = {"step": step, "leaves": []}
        for i, (path, leaf) in enumerate(_leaf_paths(state)):
            arr, dtype = _to_numpy(leaf)
            fname = f"leaf_{i:05d}.npy"
            np.save(os.path.join(tmp_dir, fname), arr)
            manifest["leaves"].append(
                {"path": path, "file": fname, "shape": list(arr.shape),
                 "dtype": dtype})
        with open(os.path.join(tmp_dir, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        with _publish_lock:
            if os.path.exists(step_dir):
                shutil.rmtree(step_dir)
            os.rename(tmp_dir, step_dir)
            current = latest_step(directory)
            if current is None or step >= current:  # LATEST is monotone
                fd, latest_tmp = tempfile.mkstemp(
                    prefix="LATEST.tmp.", dir=directory)
                with os.fdopen(fd, "w") as f:
                    f.write(os.path.basename(step_dir))
                os.replace(latest_tmp, os.path.join(directory, "LATEST"))
    except BaseException:
        shutil.rmtree(tmp_dir, ignore_errors=True)
        raise
    return step_dir


def latest_step(directory: str) -> int | None:
    pointer = os.path.join(directory, "LATEST")
    if not os.path.exists(pointer):
        return None
    with open(pointer) as f:
        name = f.read().strip()
    if not os.path.isdir(os.path.join(directory, name)):
        return None
    return int(name.split("_")[-1])


def restore(directory: str, like, step: int | None = None):
    """Restore into the structure of `like` (a nest of tensors, or of
    anything with `.shape`, `.dtype` and `.device`).  Each leaf comes back as
    a tensor on `like`'s device in `like`'s dtype.  Returns (state, step)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    step_dir = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {e["path"]: e for e in manifest["leaves"]}
    loaded = {}
    for path, leaf in _leaf_paths(like):
        entry = by_path[path]
        arr = np.load(os.path.join(step_dir, entry["file"]))
        assert tuple(arr.shape) == tuple(leaf.shape), (path, arr.shape,
                                                       leaf.shape)
        t = torch.from_numpy(arr)
        if entry["dtype"] == "bfloat16":
            t = t.view(torch.bfloat16)
        loaded[path] = t.to(device=leaf.device, dtype=leaf.dtype)

    def rebuild(tree, prefix=()):
        if isinstance(tree, dict):
            return {k: rebuild(v, prefix + (k,)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(rebuild(v, prefix + (i,))
                              for i, v in enumerate(tree))
        return loaded["/".join(str(k) for k in prefix)]

    return rebuild(like), step


class AsyncCheckpointer:
    """Fire-and-forget saves on a writer thread; at most one in flight
    (training never blocks on I/O unless a save is already running).

    Use as a context manager (or call `close()`): the writer thread is
    non-daemon work in flight, and `close()` joins it so process exit never
    truncates a checkpoint mid-write.  A save that raised on the thread
    re-raises from the next `save()`/`wait()`/`close()` call instead of
    vanishing.  `save_seconds` lists, for each finished save, (step, the
    seconds of its host copy, the seconds of its write)."""

    def __init__(self, directory: str):
        self.directory = directory
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self.last_saved: int | None = None
        self.save_seconds: list[tuple[int, float, float]] = []

    def save(self, step: int, state):
        self.wait()
        t0 = time.perf_counter()
        host_state = _map(_host_copy, state)
        copied = time.perf_counter() - t0

        def work():
            try:
                t1 = time.perf_counter()
                save(self.directory, step, host_state)
                self.last_saved = step
                self.save_seconds.append((step, copied,
                                          time.perf_counter() - t1))
            except BaseException as e:  # surfaced by the next wait()
                self._error = e

        self._thread = threading.Thread(target=work)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def close(self):
        """Join any in-flight save; the checkpointer stays usable after."""
        self.wait()

    def __enter__(self) -> "AsyncCheckpointer":
        return self

    def __exit__(self, *exc) -> None:
        # Don't mask an exception already unwinding with a writer error.
        if exc[0] is None:
            self.close()
        else:
            if self._thread is not None:
                self._thread.join()
                self._thread = None
