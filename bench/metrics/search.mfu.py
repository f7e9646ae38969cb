"""The operations the search needs in the window (K1b's rows by its per-row
count, the GP fits and posteriors by their shapes) over the window's seconds
at the H100's FP64 tensor-core peak.  It bounds a claim on `probe_s` after a
later change takes K1b or the GP's launches off the path."""

import work


def read(record):
    if (record["missing"].get("k1b") or record["missing"].get("gp_work")
            or record["device"] is None):
        return None
    flops = sum(x["flops"] for x in record["k1b"]) + record["gp_flops"]
    if flops <= 0.0:
        return None
    return 100.0 * flops / (record["window_s"] * work.PEAK_FLOPS_F64_TENSOR)
