"""The traced window's share in which the host waits on a device-to-host
readback: the union of the program's `host.wait` spans (`trace.host`, the
search's one readback helper) over the window."""

import intervals
import program_spans


def read(record):
    waits = [(s[1], s[2]) for s in program_spans.load(record) or ()
             if s[0] == "host.wait" and s[2] is not None]
    if not waits:
        return None
    return (100.0 * intervals.length(intervals.union(waits))
            / record["window_s"])
