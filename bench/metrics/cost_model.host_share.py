"""The window's share spent inside the cost model: device forwards (K1b
behind `forward_device_stacked`), the lower-bound calls of the prune gate and
the outer prior mean, and the host's scalar model."""

import intervals


def read(record):
    if record["missing"].get("cost_model"):
        return None
    cost = intervals.union(record["spans"].get("cost_model", []))
    if not cost:
        return None
    return 100.0 * intervals.length(cost) / record["window_s"]
