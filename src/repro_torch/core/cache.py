"""Bounded caches for long-lived engine/service processes.

A one-shot `codesign()` run can afford unbounded memoization, but the
co-design service (`repro.service`) keeps engines and spaces alive across
many requests, so every cache in the hot path is bounded here and counts its
traffic:

  `LRUCache`    the `CodesignEngine` (hw, layer) -> (mapping, EDP) cache: a
                dict-compatible mapping with optional LRU eviction
                (`maxsize=0` keeps the historical unbounded behavior) and
                hit/miss/eviction counters that `CoDesignResult.stats`
                surfaces per run.
  `SlotCache`   the identity-keyed packed-array memos of
                `HardwareSpace.features_batch` / `SoftwareSpace`'s forward
                and feature caches: a tiny LRU over `is`-compared pool
                objects (the historical one-slot tuples, generalized and
                counted).  Traffic tallies into the module-level `COUNTERS`
                so per-probe spaces -- created and dropped inside one outer
                trial -- still aggregate into the run's stats.

Eviction never changes search results when `prune="off"`: cache keys are
content-addressed and inner-search seeds are content-derived
(`CodesignEngine.probe_seed`), so a re-search after eviction reproduces the
evicted entry bit-for-bit.  With the bound gate on (`prune != "off"`), the
gate consults cache membership ("search already paid for"), so a bound tight
enough to evict live entries can change *when* probes are censored -- the
engine's default therefore stays unbounded and the service applies its bound
only where it owns the semantics.
"""

from __future__ import annotations

import collections
from typing import Any, Iterator, MutableMapping

# Global hit/miss tallies for the short-lived SlotCaches, keyed
# "<name>_hits" / "<name>_misses".  Snapshot + diff around a run to get
# per-run numbers (see `counters_snapshot`).
COUNTERS: collections.Counter = collections.Counter()


def counters_snapshot() -> dict[str, int]:
    """Copy of the global SlotCache tallies (diff two snapshots for a
    per-run reading)."""
    return dict(COUNTERS)


# `LRUCache._primed` sentinel: "no membership probe pending".  A distinct
# object (not None) so priming is unambiguous even for None keys.
_NO_KEY = object()


class LRUCache(MutableMapping):
    """Dict-compatible mapping with optional LRU eviction and traffic
    counters.  `maxsize=0` (default) disables eviction -- the mapping then
    behaves exactly like the plain dict it replaces, counters aside.

    Lookups (`[]`, `.get`, `in`) refresh recency and tally `hits`/`misses`;
    insertion beyond `maxsize` evicts the least-recently-used entry and
    tallies `evictions`.

    One logical lookup counts once: the engine's idiomatic
    `if key in cache: use(cache[key])` probe is a single lookup, so the
    membership test *primes* the key and the immediately following `[]` read
    of that same key skips its tally (any other operation in between clears
    the prime).  Without this, `__contains__` and `__getitem__` each tallied
    and the `cache_*` stats in `CoDesignResult` double-counted every
    in-then-read access."""

    def __init__(self, maxsize: int = 0):
        if maxsize < 0:
            raise ValueError(f"maxsize must be >= 0, got {maxsize!r}")
        self.maxsize = int(maxsize)
        self._data: collections.OrderedDict = collections.OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self._primed: Any = _NO_KEY

    def __getitem__(self, key) -> Any:
        primed, self._primed = self._primed, _NO_KEY
        counted = primed is _NO_KEY or primed != key
        try:
            value = self._data[key]
        except KeyError:
            if counted:
                self.misses += 1
            raise
        self._data.move_to_end(key)
        if counted:
            self.hits += 1
        return value

    def __contains__(self, key) -> bool:
        self._primed = key
        if key in self._data:
            self._data.move_to_end(key)
            self.hits += 1
            return True
        self.misses += 1
        return False

    def __setitem__(self, key, value) -> None:
        self._primed = _NO_KEY
        self._data[key] = value
        self._data.move_to_end(key)
        if self.maxsize and len(self._data) > self.maxsize:
            self._data.popitem(last=False)
            self.evictions += 1

    def __delitem__(self, key) -> None:
        self._primed = _NO_KEY
        del self._data[key]

    def __iter__(self) -> Iterator:
        return iter(self._data)

    def items(self):
        """Uncounted point-in-time (key, value) list, LRU order.  The default
        `MutableMapping.items()` view reads through `__getitem__`, whose
        recency refresh would mutate the dict mid-iteration (and skew the
        traffic counters); snapshots use this instead."""
        return [(k, self._data[k]) for k in list(self._data)]

    def __len__(self) -> int:
        return len(self._data)

    def __repr__(self) -> str:
        return (f"LRUCache(maxsize={self.maxsize}, len={len(self._data)}, "
                f"hits={self.hits}, misses={self.misses}, "
                f"evictions={self.evictions})")


class SlotCache:
    """Tiny identity-keyed LRU for per-pool derived arrays (the generalized
    one-slot `(pool, value)` memo).  Keys compare by `is`: a pool object
    re-presented across frozen-window trials or back-to-back protocol calls
    hits; equal-valued but distinct pools do not (identity is the memo's
    correctness contract -- pools are never mutated in place).

    `name` routes hit/miss tallies into the module `COUNTERS`
    ("<name>_hits" / "<name>_misses") so short-lived space instances still
    aggregate into run-level stats.
    """

    def __init__(self, name: str, capacity: int = 2):
        assert capacity >= 1
        self.name = name
        self.capacity = capacity
        self._slots: list[tuple[object, Any]] = []

    def get(self, key) -> Any | None:
        for i, (k, v) in enumerate(self._slots):
            if k is key:
                if i != len(self._slots) - 1:
                    self._slots.append(self._slots.pop(i))
                COUNTERS[self.name + "_hits"] += 1
                return v
        COUNTERS[self.name + "_misses"] += 1
        return None

    def put(self, key, value) -> None:
        # Replace in place on a re-put of an already-present key (and refresh
        # its recency): appending a duplicate slot would make `get` serve the
        # stale older slot and could push a *distinct* live entry out of the
        # memo.
        for i, (k, _) in enumerate(self._slots):
            if k is key:
                self._slots[i] = (key, value)
                if i != len(self._slots) - 1:
                    self._slots.append(self._slots.pop(i))
                return
        self._slots.append((key, value))
        if len(self._slots) > self.capacity:
            self._slots.pop(0)
