"""The traced window's share with no operation running on the device, from
the profiler's timeline."""

import intervals


def read(record):
    if not record["device"]:
        return None
    busy = intervals.length(intervals.union(record["device"]))
    return 100.0 * (1.0 - busy / record["window_s"])
