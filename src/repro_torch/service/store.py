"""Persistent design store: content-addressed (hw, layer) inner-search results.

The store is the cross-run sibling of `CodesignEngine`'s in-memory cache: an
entry records the outcome of ONE inner software-mapping search -- the best
mapping found (or infeasibility) and its true model EDP -- under a key that
hashes everything that determines that search bit-for-bit:

    design_key(hw, layer, sw_cfg, engine_cfg, probe_seed)

Probe seeds are already content-derived (`CodesignEngine.probe_seed`), so two
requests that probe the same hardware point under the same search config and
run seed share a key -- and a store hit is an *exact replay* of the search the
engine would run, not an approximation.  The scheduler prefills session
caches from the store before dispatching searches, so repeated or
overlapping workloads skip re-searching entirely.

Layout (one JSON file per entry, fanned out by key prefix):

    <dir>/ab/abcdef...1234.json

Writes are atomic -- serialize to a
temporary file in the destination directory, then `os.replace` -- so readers
never observe a torn entry and concurrent writers of the same key are safe
(last writer wins with identical bytes; keys are content-addressed).

Two cross-run *transfer* surfaces live alongside the exact store:

  `DesignStore.nearest`   approximate hits -- when an exact key misses, the
                          closest stored hardware point's mapping (same
                          layer, feature-space distance) can seed the new
                          search as a warm-start incumbent.  Never a replay:
                          callers re-evaluate the mapping on the target
                          hardware, so served EDPs stay exact.
  `TrialHistory`          per-workload-set append-only log of finished outer
                          trials (`history_key`), replayed as prior
                          observations into a warm-started outer GP.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
from typing import Sequence

import numpy as np

from repro_torch.core.config import (EngineConfig, HWSearchConfig, SWSearchConfig)
from repro_torch.timeloop.arch import HardwareConfig, hw_from_tuple
from repro_torch.timeloop.mapping import Mapping
from repro_torch.timeloop.workloads import ConvLayer

# Lazily built throwaway HardwareSpace for `DesignStore.nearest`'s feature
# distance (features() is a pure function of the config; the space instance
# only exists to reuse the one featurization definition).
_FEAT_SPACE = None


def _hw_features(hw: HardwareConfig) -> np.ndarray:
    from repro_torch.core.hwspace import HardwareSpace

    global _FEAT_SPACE
    if _FEAT_SPACE is None:
        _FEAT_SPACE = HardwareSpace()
    return _FEAT_SPACE.features(hw)


def _engine_fields(engine_cfg: EngineConfig) -> tuple:
    """The engine fields an inner search's result depends on, as both keys
    hash them: the evaluation backend, the GP refit stride and the batched
    protocol (not the device, see `design_key`)."""
    return (engine_cfg.backend, engine_cfg.gp_refit_every, engine_cfg.batched)


def design_key(hw: HardwareConfig, layer: ConvLayer,
               sw_cfg: SWSearchConfig, engine_cfg: EngineConfig,
               probe_seed: int) -> str:
    """Stable content hash identifying one (hw, layer) inner search.

    Includes every field that can change the search's result: the hardware
    point, the layer, the full software search config, the engine fields the
    inner `bo_maximize` consumes (`_engine_fields`: backend, refit stride,
    batched protocol), and the probe's content-derived seed.  Engine fields
    that only move work around (strategy, use_cache, hw_*, executor) are
    excluded -- strategies are pinned bit-identical to sequential.  So is
    `device`: the card's decisions equal the CPU's exactly (the main path's
    design, outer history and EDP), so an entry written by a run on the card
    serves a run on the CPU, and the reverse."""
    eng = _engine_fields(engine_cfg)
    data = repr((dataclasses.astuple(hw), dataclasses.astuple(layer),
                 dataclasses.astuple(sw_cfg), eng, int(probe_seed))).encode()
    return hashlib.blake2s(data, digest_size=16).hexdigest()


def _encode_entry(entry: tuple[Mapping | None, float]) -> dict:
    mapping, edp = entry
    if mapping is None:
        return {"feasible": False}
    return {
        "feasible": True,
        # float(edp) JSON round-trips exactly (repr serialization), so a
        # warm entry is bit-identical to the search that produced it.
        "edp": float(edp),
        "mapping": {
            "factors": [list(level) for level in mapping.factors],
            "order_lb": list(mapping.order_lb),
            "order_gb": list(mapping.order_gb),
            "order_dram": list(mapping.order_dram),
        },
    }


def _decode_entry(doc: dict) -> tuple[Mapping | None, float]:
    if not doc["feasible"]:
        return (None, float("inf"))
    m = doc["mapping"]
    mapping = Mapping(
        factors=tuple(tuple(int(f) for f in level) for level in m["factors"]),
        order_lb=tuple(m["order_lb"]),
        order_gb=tuple(m["order_gb"]),
        order_dram=tuple(m["order_dram"]),
    )
    return (mapping, float(doc["edp"]))


class DesignStore:
    """Content-addressed persistent store of inner-search results.

    `get`/`put` speak the engine's cache-entry type directly:
    `(Mapping | None, edp)` -- None marks a probed-and-infeasible layer
    (storing infeasibility matters: re-discovering it costs a full search).
    Tallies `hits`/`misses` for `CoDesignResult.stats`.
    """

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self.hits = 0
        self.misses = 0
        # (layer astuple) -> [(features, hw astuple, mapping, edp), ...]:
        # the approximate-hit index over stored *feasible* entries carrying
        # hw/layer metadata.  Built lazily on the first `nearest()` call and
        # kept current by `put`; None until then.
        self._nn: dict[tuple, list] | None = None

    def _path(self, key: str) -> str:
        return os.path.join(self.directory, key[:2], key + ".json")

    def get(self, key: str) -> tuple[Mapping | None, float] | None:
        path = self._path(key)
        try:
            with open(path) as f:
                doc = json.load(f)
            entry = _decode_entry(doc)
        except FileNotFoundError:
            self.misses += 1
            return None
        except (json.JSONDecodeError, KeyError, TypeError, ValueError):
            # Corrupt or schema-invalid entry (torn write survived a crash,
            # foreign file, old incompatible layout): a miss, and the file is
            # removed so it does not cost a failed parse on every future get
            # -- evicting is result-preserving (the search re-runs exactly).
            self.misses += 1
            try:
                os.unlink(path)
            except OSError:
                pass
            return None
        self.hits += 1
        return entry

    def put(self, key: str, entry: tuple[Mapping | None, float], *,
            hw: HardwareConfig | None = None,
            layer: ConvLayer | None = None) -> None:
        path = self._path(key)
        directory = os.path.dirname(path)
        os.makedirs(directory, exist_ok=True)
        doc = _encode_entry(entry)
        if hw is not None and layer is not None:
            # Optional provenance metadata: which (hw, layer) produced this
            # entry.  `_decode_entry` ignores it (exact gets are unchanged);
            # `nearest` indexes on it for approximate warm-start hits.
            doc["hw"] = list(dataclasses.astuple(hw))
            doc["layer"] = list(dataclasses.astuple(layer))
        # Atomic publish: write a unique temp file in
        # the destination directory, then rename over the final name --
        # readers never see a torn entry, concurrent same-key writers race
        # benignly (identical content-addressed bytes).
        fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        if self._nn is not None and hw is not None and layer is not None \
                and entry[0] is not None:
            self._nn.setdefault(dataclasses.astuple(layer), []).append(
                (_hw_features(hw), dataclasses.astuple(hw),
                 entry[0], float(entry[1])))

    # --- approximate (near-identical hardware) lookup ----------------------------

    def _build_nn_index(self, max_scan: int) -> None:
        self._nn = {}
        scanned = 0
        paths = []
        for root, _, files in os.walk(self.directory):
            paths.extend(os.path.join(root, name) for name in files
                         if name.endswith(".json"))
        # Deterministic index regardless of directory-walk order; the scan
        # bound keeps index construction O(max_scan) on huge stores.
        for path in sorted(paths):
            if scanned >= max_scan:
                break
            scanned += 1
            try:
                with open(path) as f:
                    doc = json.load(f)
                if "hw" not in doc or "layer" not in doc:
                    continue  # pre-metadata entry: exact-only
                mapping, edp = _decode_entry(doc)
                if mapping is None:
                    continue  # infeasible entries never serve as warm starts
                hw_t = tuple(tuple(v) if isinstance(v, list) else v
                             for v in doc["hw"])
                layer_t = tuple(doc["layer"])
                feats = _hw_features(hw_from_tuple(hw_t))
            except (OSError, json.JSONDecodeError, KeyError, TypeError,
                    ValueError):
                continue
            self._nn.setdefault(layer_t, []).append(
                (feats, hw_t, mapping, float(edp)))

    def nearest(self, hw: HardwareConfig, layer: ConvLayer, *,
                max_scan: int = 4096
                ) -> tuple[HardwareConfig, Mapping, float] | None:
        """Closest stored feasible entry for this exact layer, by Euclidean
        distance in the hardware feature space (`HardwareSpace.features`):
        `(neighbor hw, its best mapping, its edp ON THE NEIGHBOR)` or None.

        This is the approximate sibling of `get`: the caller must treat the
        mapping as a warm-start *candidate* and re-evaluate it on the target
        hardware (the returned edp belongs to the neighbor's hardware, never
        the target's) -- results stay exact, only the search gets a head
        start.  The index scans at most `max_scan` entry files once, then
        stays current incrementally through `put`."""
        if self._nn is None:
            self._build_nn_index(max_scan)
        rows = self._nn.get(dataclasses.astuple(layer))
        if not rows:
            return None
        target = _hw_features(hw)
        d2 = np.array([float(np.sum((feats - target) ** 2))
                       for feats, _, _, _ in rows])
        feats, hw_t, mapping, edp = rows[int(np.argmin(d2))]
        return hw_from_tuple(hw_t), mapping, edp

    def __len__(self) -> int:
        n = 0
        for _, _, files in os.walk(self.directory):
            n += sum(1 for f in files if f.endswith(".json"))
        return n

    def _entries(self) -> list[tuple[float, int, str]]:
        """Every stored entry as (mtime, size_bytes, path)."""
        out = []
        for root, _, files in os.walk(self.directory):
            for name in files:
                if not name.endswith(".json"):
                    continue
                path = os.path.join(root, name)
                try:
                    st = os.stat(path)
                except FileNotFoundError:  # concurrent pruner won the race
                    continue
                out.append((st.st_mtime, st.st_size, path))
        return out

    def stats(self) -> dict:
        """Entry count and byte footprint, total and per shard directory
        (the two-hex-char key-prefix fan-out)."""
        shards: dict[str, dict] = {}
        entries = bytes_total = 0
        for mtime, size, path in self._entries():
            shard = os.path.basename(os.path.dirname(path))
            s = shards.setdefault(shard, {"entries": 0, "bytes": 0})
            s["entries"] += 1
            s["bytes"] += size
            entries += 1
            bytes_total += size
        return {"entries": entries, "bytes": bytes_total,
                "shards": dict(sorted(shards.items()))}

    def prune(self, max_entries: int) -> int:
        """Evict oldest-first (by mtime, path-tiebroken) until at most
        `max_entries` entries remain; returns the number removed.

        Per-entry removal is a single `os.unlink`, atomic against the
        store's atomic-rename writers: a concurrent reader either sees a
        whole entry or a miss, never a torn one, and evicting is always
        result-preserving -- a missed key just re-runs its exact-replay
        search.  Concurrent pruners race benignly (unlink of an
        already-removed path is ignored)."""
        if not isinstance(max_entries, int) or isinstance(max_entries, bool) \
                or max_entries < 0:
            raise ValueError(
                f"max_entries must be an int >= 0, got {max_entries!r}")
        # Sort on (mtime, path) exactly as documented: a plain sort of the
        # (mtime, size, path) triples would tiebreak equal mtimes on SIZE
        # before path, making eviction order depend on entry byte counts.
        entries = sorted(self._entries(), key=lambda e: (e[0], e[2]))
        removed = 0
        for _, _, path in entries[:max(0, len(entries) - max_entries)]:
            try:
                os.unlink(path)
                removed += 1
            except FileNotFoundError:
                pass
        self._nn = None  # pruned entries must leave the approximate index
        return removed


# --- cross-run trial history (outer-GP warm starts) ------------------------------


def history_key(layers: Sequence[ConvLayer], hw_cfg: HWSearchConfig,
                sw_cfg: SWSearchConfig, engine_cfg: EngineConfig) -> str:
    """Stable content hash identifying one *workload set's* outer-search
    problem: the layers, the hardware-space parameterization (num_pes), the
    inner-search config, and the engine fields that determine inner results
    (same set `design_key` hashes).

    Deliberately EXCLUDED: the run seed, the outer budget/acquisition knobs,
    prune/spec_k/elite_k/strategy, and every `warm_start*` field -- those
    change which hardware points get probed, not what a probe's
    `(features, utility, feasible)` row means, so cold runs under any of
    them write history that warm runs under any of them can consume."""
    eng = _engine_fields(engine_cfg)
    data = repr((tuple(dataclasses.astuple(layer) for layer in layers),
                 int(hw_cfg.num_pes), dataclasses.astuple(sw_cfg),
                 eng)).encode()
    return hashlib.blake2s(data, digest_size=16).hexdigest()


class TrialHistory:
    """Append-only per-workload-set log of finished outer trials.

    One JSONL file per `history_key`, fanned out like the store
    (`<dir>/ab/ab...90.jsonl`); each line is one TRUE outer evaluation:

        {"hw": [astuple], "features": [11 floats],
         "utility": float | null, "feasible": bool}

    (bound-gate-censored trials are never logged -- their utilities are
    certificates, not measurements).  `append` publishes each row as ONE
    `os.write` on an `O_APPEND` descriptor, which POSIX keeps atomic for
    concurrent writers -- many service processes may log into one history
    directory; `load` skips any torn or foreign line instead of failing."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self.appended = 0

    def _path(self, hkey: str) -> str:
        return os.path.join(self.directory, hkey[:2], hkey + ".jsonl")

    def append(self, hkey: str, row: dict) -> None:
        path = self._path(hkey)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        line = (json.dumps(row, sort_keys=True) + "\n").encode()
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        try:
            os.write(fd, line)
        finally:
            os.close(fd)
        self.appended += 1

    def load(self, hkey: str, max_rows: int = 0) -> list[dict]:
        """Rows for one history key, oldest first; `max_rows` > 0 keeps only
        the most recent.  Schema-invalid or torn lines are skipped (a
        concurrent writer's partial line must not poison every reader)."""
        try:
            with open(self._path(hkey), "rb") as f:
                data = f.read()
        except FileNotFoundError:
            return []
        rows: list[dict] = []
        for line in data.splitlines():
            if not line.strip():
                continue
            try:
                doc = json.loads(line)
                util = doc["utility"]
                rows.append({
                    "hw": tuple(tuple(v) if isinstance(v, list) else v
                                for v in doc["hw"]),
                    "features": [float(v) for v in doc["features"]],
                    "utility": None if util is None else float(util),
                    "feasible": bool(doc["feasible"]),
                })
            except (json.JSONDecodeError, KeyError, TypeError, ValueError):
                continue
        if max_rows and len(rows) > max_rows:
            rows = rows[-max_rows:]
        return rows

    def __len__(self) -> int:
        n = 0
        for _, _, files in os.walk(self.directory):
            n += sum(1 for f in files if f.endswith(".jsonl"))
        return n
