"""The device's idle share while the GP fits: the time inside the union of
the program's outermost `gp.fit` spans in which no device operation runs,
over that union.  High where the fit is bound by its launches, not by the
device's work."""

import intervals
import program_spans


def read(record):
    if not record["device"]:
        return None
    fits = program_spans.outermost(program_spans.load(record), "gp.fit")
    if not fits:
        return None
    union = intervals.union([(s[1], s[2]) for s in fits])
    total = intervals.length(union)
    if total <= 0.0:
        return None
    return 100.0 * program_spans.idle_inside(record["device"], union) / total
