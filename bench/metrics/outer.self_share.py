"""The window's share spent in `SearchSession.step` outside the inner
searches, the GP surrogates and the cost model: the outer BO's own host work
(hardware pools, acquisition, the prune gate's bookkeeping, the probe
strategies)."""

import intervals

NEEDS = ("outer", "inner", "gp", "cost_model")


def read(record):
    if any(record["missing"].get(k) for k in NEEDS):
        return None
    spans = record["spans"]
    outer = intervals.union(spans.get("outer", []))
    if not outer:
        return None
    children = intervals.union(
        [s for k in NEEDS[1:] for s in spans.get(k, [])])
    return 100.0 * intervals.minus(outer, children) / record["window_s"]
