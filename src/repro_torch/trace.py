"""Spans of the search's own layers, recorded while a profiler session is open.

    with trace.span("gp.fit") as sp:
        ...
        if sp:
            sp.set(runs=L, rows=b)

A span is `(name, start_ns, end_ns, parent, attrs)`: start and end on
`time.perf_counter_ns()`, `parent` the index in `spans()` of the span it
opened inside (None at the top), `attrs` a dict of counts and labels.  It
records only while a `torch.profiler` session is open: every session sets
`torch.autograd.profiler._is_profiler_enabled` at its start, whatever its
activities, and that flag is the one switch (a torch without it records
nothing).  Outside a session `span` returns a shared handle that is false,
records nothing and builds nothing, so a site costs one check; attributes
that take work to compute are set behind `if sp:`.  A span never
synchronises the device and never reads a tensor, so the search computes
the same bits with spans on or off.

Spans are kept in memory, at most `CAPACITY` of them; later ones are
dropped and counted (`dropped()`).  The first span recorded after a span
found no session open empties the buffer, so it holds one session's spans
(give or take sessions with no span between them); `clear()` empties it
too.  Spans nest in the order they open, so they are opened from one
thread: the search's.

`host(x)` is the search's one device-to-host readback; its span `host.wait`
is the time the host waits for the device to reach the tensor and copy it.
The module imports nothing of the package, so every layer can use it.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.autograd import profiler as _profiler

CAPACITY = 1_000_000

_buffer: list = []   # [name, start_ns, end_ns, parent, attrs]
_stack: list = []    # (index, entry) of each open span, innermost last
_dropped = 0
_between = True      # a span has found no session open since the last record


class _Off:
    """The handle of a span that records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def __bool__(self) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


class _Span:
    __slots__ = ("_entry",)

    def __init__(self, name: str, attrs: dict):
        self._entry = [name, 0, None, None, attrs]

    def __enter__(self):
        global _dropped
        entry = self._entry
        if len(_buffer) >= CAPACITY:
            _dropped += 1
        else:
            entry[3] = _stack[-1][0] if _stack else None
            _stack.append((len(_buffer), entry))
            _buffer.append(entry)
        entry[1] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        entry = self._entry
        entry[2] = time.perf_counter_ns()
        if _stack and _stack[-1][1] is entry:
            _stack.pop()
        return None

    def set(self, **attrs) -> None:
        """Adds attributes known only inside the span."""
        self._entry[4].update(attrs)


def span(name: str, **attrs):
    """A context manager that records the block as span `name` while a
    profiler session is open; a false no-op handle otherwise."""
    global _between
    if not getattr(_profiler, "_is_profiler_enabled", False):
        _between = True
        return _OFF
    if _between:
        _between = False
        clear()
    return _Span(name, attrs)


def spans() -> list[tuple]:
    """A snapshot of the recorded spans, in the order they opened; a span
    still open has an end of None."""
    return [(n, t0, t1, p, dict(a)) for n, t0, t1, p, a in _buffer]


def dropped() -> int:
    """Spans not recorded because the buffer was full."""
    return _dropped


def clear() -> None:
    global _dropped
    _buffer.clear()
    _stack.clear()
    _dropped = 0


def host(x) -> np.ndarray:
    """A NumPy view of `x`: a device tensor comes back with an explicit copy,
    inside a `host.wait` span."""
    if isinstance(x, torch.Tensor):
        with span("host.wait"):
            return x.detach().cpu().numpy()
    return np.asarray(x)
