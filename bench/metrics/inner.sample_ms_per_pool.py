"""Milliseconds of the inner searches' pool sampling (pool draws and their
host featurising) per pool requested: the window's outermost `inner.sample`
spans less the cost-model spans inside them (the warm-up pools' stacked
forward, a scalar evaluation), over the sum of their `pools` counters.
None where no span carries the counter (a program that records none)."""

import intervals
import program_spans


def read(record):
    spans = program_spans.load(record)
    sampled = [s for s in program_spans.outermost(spans, "inner.sample")
               if "pools" in s[4]]
    pools = sum(s[4]["pools"] for s in sampled)
    if not pools:
        return None
    model = [(s[1], s[2]) for s in spans
             if s[0].startswith("cost_model.") and s[2] is not None]
    sampling = intervals.minus(intervals.union((s[1], s[2]) for s in sampled),
                               intervals.union(model))
    return 1e3 * sampling / pools
