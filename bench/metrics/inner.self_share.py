"""The window's share spent in the inner lockstep searches outside the GP
surrogates and the cost model: the host's own pool sampling, packing and
bookkeeping of `bo_maximize_many`."""

import intervals

NEEDS = ("inner", "gp", "cost_model")


def read(record):
    if any(record["missing"].get(k) for k in NEEDS):
        return None
    spans = record["spans"]
    inner = intervals.union(spans.get("inner", []))
    if not inner:
        return None
    children = intervals.union(
        [s for k in NEEDS[1:] for s in spans.get(k, [])])
    return 100.0 * intervals.minus(inner, children) / record["window_s"]
