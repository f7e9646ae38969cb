"""The traced run's summary of the device's timeline: its busy seconds, the
device operations that took most time, and the longest idle gaps labelled
by what the host was doing (the innermost layer's span around the gap)."""

from __future__ import annotations

import collections

import intervals

# Innermost first: the label of a gap is the most specific span around it.
LAYERS = ("cost_model", "gp", "inner", "outer")


def busy_s(events) -> float:
    return intervals.length(intervals.union(events))


def _host_at(spans: dict, t: float) -> str:
    for kind in LAYERS:
        for name, a, b in spans.get(kind, ()):
            if a <= t <= b:
                return f"{kind}:{name}"
    return "harness"


def breakdown(record: dict, top: int = 10) -> dict:
    events = record["device"]
    by_name: collections.Counter = collections.Counter()
    for name, a, b in events:
        by_name[name[:120]] += b - a
    busy = intervals.union(events)
    edges = [0.0] + [x for ab in busy for x in ab] + [record["window_s"]]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                   for i in range(0, len(edges), 2)), reverse=True)[:top]
    return {"device_ops": [[n, s] for n, s in by_name.most_common(top)],
            "idle_gaps": [[_host_at(record["spans"], t + g / 2), g]
                          for g, t in gaps]}
