"""The program's own spans (`repro_torch.trace`) on the traced record's time
base, for the metrics that read them.

The program records its spans on `time.perf_counter_ns()` while the traced
run's profiler is open, which is the window; the record's hook spans count
seconds from the window's start on the same clock.  Each program
`search.step` span is matched, in order, to the record's hook span around the
same `SearchSession.step` call (`record["spans"]["outer"]`).  The hook opens
before the program's span, so the least difference of their starts is the
offset, and the widest departure from it is the residual.  A count that
differs, or a residual above `MAX_RESIDUAL_S`, gives None, so that a metric
reads None rather than a misaligned value.  So does a program without
`repro_torch.trace`.

The device's events in the record are on the same base already (the harness
maps them at the window's start), so program spans and the device's
timeline share one clock.

`report(record)` reads what the metrics leave out: each span kind's self
time, time by span and attributes (a fit's stack shape, a forward's rows),
probes searched or answered without a search, trials a probe, the program's
GP and cost-model unions beside the hooks', the device's idle share inside
each kind, the longest idle gaps labelled by the innermost program span,
and how long after the device's last operation each readback ends.  Run
from the root of a checkout, on a card, it makes `bench/run.py`'s traced
run of a cell, with its output, and then prints a line with the report:

    python3 bench/program_spans.py --workload resnet.table --seed 7 \
        --seconds 40
"""

from __future__ import annotations

import bisect
import collections
import statistics
import time

import intervals

MAX_RESIDUAL_S = 1e-3
# The kinds whose device idle share the report gives.
IDLE_KINDS = ("gp.fit", "gp.score", "cost_model.forward", "inner.sample",
              "host.wait")


def alignment(spans, hooks) -> tuple[float, float] | None:
    """(offset, residual) in seconds that map the program's `search.step`
    starts (ns on the program's clock) onto the hook spans' starts (seconds
    from the window's start); None where the counts differ or the residual
    is too wide."""
    steps = sorted(s[1] / 1e9 for s in spans if s[0] == "search.step")
    starts = sorted(h[-2] for h in hooks)
    if not steps or len(steps) != len(starts):
        return None
    diffs = [p - h for p, h in zip(steps, starts)]
    offset = min(diffs)
    residual = max(diffs) - offset
    if residual > MAX_RESIDUAL_S:
        return None
    return offset, residual


def recorded() -> list | None:
    """The program's spans as it recorded them; None for a program without
    `repro_torch.trace`."""
    try:
        from repro_torch import trace
    except ImportError:
        return None
    return trace.spans()


def load(record) -> list | None:
    """`(name, start_s, end_s, parent, attrs)` of every program span, in
    seconds from the window's start (`end_s` None for a span left open), or
    None where the program recorded none or they do not align."""
    spans = recorded()
    align = alignment(spans or [], record["spans"].get("outer", []))
    if align is None:
        return None
    offset = align[0]
    return [(n, t0 / 1e9 - offset, None if t1 is None else t1 / 1e9 - offset,
             p, a) for n, t0, t1, p, a in spans]


def outermost(spans, name: str) -> list:
    """The closed spans named `name` with no enclosing span of that name."""
    if not spans:
        return []
    out = []
    for s in spans:
        if s[0] != name or s[2] is None:
            continue
        p = s[3]
        while p is not None and spans[p][0] != name:
            p = spans[p][3]
        if p is None:
            out.append(s)
    return out


def idle_inside(events, within) -> float:
    """Seconds of the merged intervals `within` in which no device event
    runs: one pass over `events` (`(name, start, end)`, sorted by start),
    whose busy intervals are merged as they come.  A traced window holds
    millions of events, so the common case, a busy interval inside the
    current interval of `within`, takes one comparison."""
    n = len(within)
    if not n or not events:
        return sum(b - a for a, b in within)
    busy = 0.0
    j = 0
    s_j, e_j = within[0]

    def overlap(a: float, b: float) -> float:
        nonlocal j
        while j < n and within[j][1] <= a:
            j += 1
        total, k = 0.0, j
        while k < n and within[k][0] < b:
            total += min(b, within[k][1]) - max(a, within[k][0])
            k += 1
        return total

    it = iter(events)
    _, cur_a, cur_b = next(it)
    for _, a, b in it:
        if a <= cur_b:
            if b > cur_b:
                cur_b = b
            continue
        if cur_b > s_j:
            if cur_a >= s_j and cur_b <= e_j:
                busy += cur_b - cur_a
            else:
                busy += overlap(cur_a, cur_b)
                if j == n:
                    break
                s_j, e_j = within[j]
        cur_a, cur_b = a, b
    else:
        busy += overlap(cur_a, cur_b)
    return sum(b - a for a, b in within) - busy


def self_time(spans) -> dict:
    """Seconds in each span kind outside the spans it encloses."""
    inside = collections.defaultdict(float)
    for s in spans:
        if s[2] is not None and s[3] is not None:
            inside[s[3]] += s[2] - s[1]
    out = collections.defaultdict(float)
    for i, s in enumerate(spans):
        if s[2] is not None:
            out[s[0]] += s[2] - s[1] - inside[i]
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def by_shape(spans) -> dict:
    """(count, seconds) of each span kind by its attributes other than
    `trials`: a fit by its stack's runs, rows, width, steps and kernel, a
    scoring call by its runs and pool, a forward or a bound by its rows, a
    step by its session's seed."""
    out: dict = collections.defaultdict(
        lambda: collections.defaultdict(lambda: [0, 0.0]))
    for name, t0, t1, _, attrs in spans:
        if t1 is None or not attrs:
            continue
        key = " ".join(f"{k}={v}" for k, v in sorted(attrs.items())
                       if k != "trials")
        entry = out[name][key]
        entry[0] += 1
        entry[1] += t1 - t0
    return {name: dict(shapes) for name, shapes in out.items()}


def probes(spans) -> dict:
    """Probes that ran an inner search, and those answered without one: from
    the cache, from searches that ran ahead of them in their step (the
    warm-up fan-out, speculation), or by the bound gate."""
    searched = set()
    for s in spans:
        if s[0] != "inner.search":
            continue
        p = s[3]
        while p is not None and spans[p][0] != "probe":
            p = spans[p][3]
        if p is not None:
            searched.add(p)
    n = sum(1 for s in spans if s[0] == "probe")
    return {"searched": len(searched), "answered": n - len(searched)}


def union_share(spans, prefix: str, window_s: float) -> float:
    """The window's share inside the union of spans whose name starts with
    `prefix`."""
    u = intervals.union([(s[1], s[2]) for s in spans
                         if s[0].startswith(prefix) and s[2] is not None])
    return 100.0 * intervals.length(u) / window_s


def innermost(spans, t: float) -> str:
    """The chain of program spans open at `t`, innermost first."""
    best = None
    for i, s in enumerate(spans):
        if s[1] > t:
            break
        if s[2] is not None and t <= s[2]:
            best = i
    chain = []
    while best is not None:
        chain.append(spans[best][0])
        best = spans[best][3]
    return " < ".join(chain) or "harness"


def idle_gaps(events, spans, window_s: float, top: int = 10) -> list:
    """The `top` longest gaps between the device's operations, each with the
    program spans open at its middle."""
    busy = intervals.union(events)
    edges = [0.0] + [x for ab in busy for x in ab] + [window_s]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                   for i in range(0, len(edges), 2)), reverse=True)[:top]
    return [[innermost(spans, t + g / 2), g] for g, t in gaps]


def wait_lags(events, spans) -> dict | None:
    """How long after the end of the device's last operation before it each
    `host.wait` span ends: never below nought on a shared clock."""
    starts = [e[1] for e in events]
    last, m = [], float("-inf")
    for e in events:
        m = max(m, e[2])
        last.append(m)
    lags = []
    for s in spans:
        if s[0] == "host.wait" and s[2] is not None:
            i = bisect.bisect_left(starts, s[2]) - 1
            if i >= 0:
                lags.append(s[2] - last[i])
    if not lags:
        return None
    return {"n": len(lags), "median_s": statistics.median(lags),
            "min_s": min(lags), "below_zero": sum(1 for x in lags if x < 0)}


def report(record) -> dict | None:
    """What the program's spans say beyond the metrics; None where they do
    not align."""
    spans = load(record)
    if spans is None:
        return None
    window_s = record["window_s"]
    searches = outermost(spans, "inner.search")
    out = {
        "alignment_s": alignment(recorded(),
                                 record["spans"].get("outer", [])),
        "spans": len(spans), "self_s": self_time(spans),
        "by_shape": by_shape(spans), "probes": probes(spans),
        "trials_per_probe": (sum(s[4].get("trials", 0) for s in searches)
                             / record["probes"] if record["probes"]
                             else None),
        "program_gp_share": union_share(spans, "gp.", window_s),
        "hooks_gp_share": 100.0 * intervals.length(intervals.union(
            record["spans"].get("gp", []))) / window_s,
        "program_cost_model_share": union_share(spans, "cost_model.",
                                                window_s),
        "hooks_cost_model_share": 100.0 * intervals.length(intervals.union(
            record["spans"].get("cost_model", []))) / window_s,
    }
    events = record["device"]
    if events:
        idle = {}
        for kind in IDLE_KINDS:
            u = intervals.union([(s[1], s[2]) for s in outermost(spans, kind)])
            if u:
                idle[kind] = (100.0 * idle_inside(events, u)
                              / intervals.length(u))
        out.update(idle_share_inside=idle,
                   idle_gaps=idle_gaps(events, spans, window_s),
                   wait_lags=wait_lags(events, spans))
    return out


def main() -> int:
    """`bench/run.py`'s run with `--trace 1`, then a line with the report."""
    import json
    import os
    import sys

    import run

    # The host's thread pools take their size when NumPy loads, with the
    # harness, before `run.main` would set it.
    for var in run.THREAD_VARS:
        os.environ[var] = "1"
    import harness

    # The record is the metrics' argument: keep it from the first reader.
    kept = {}
    load_reader = harness.load_reader

    def keeping(name):
        reader = load_reader(name)

        def read(record):
            kept["record"] = record
            return reader(record)
        return read

    harness.load_reader = keeping
    sys.argv += ["--trace", "1"]
    rc = run.main()
    if rc or "record" not in kept:
        return rc or 1
    run_s = harness.process_age_s()
    t = time.perf_counter()
    rep = report(kept["record"])
    print(json.dumps({"run_s": run_s, "report_s": time.perf_counter() - t,
                      "report": rep}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
