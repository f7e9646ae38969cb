"""The window's share spent inside GP fits and scoring calls, outer and
inner together."""

import intervals


def read(record):
    if record["missing"].get("gp"):
        return None
    gp = intervals.union(record["spans"].get("gp", []))
    if not gp:
        return None
    return 100.0 * intervals.length(gp) / record["window_s"]
