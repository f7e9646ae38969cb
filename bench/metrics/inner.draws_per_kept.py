"""Mappings the inner searches' pool sampler drew for each valid one it
kept: the sums of the `drawn` and `kept` counters over the window's
outermost `inner.sample` spans.  None where no span carries the counters
(a program that records none) or none was kept."""

import program_spans


def read(record):
    spans = program_spans.outermost(program_spans.load(record),
                                    "inner.sample")
    counted = [s[4] for s in spans if "drawn" in s[4]]
    kept = sum(a["kept"] for a in counted)
    if not kept:
        return None
    return sum(a["drawn"] for a in counted) / kept
