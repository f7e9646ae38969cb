"""Kernel K1b's share of its roofline over the window: the sum over its
launches of the least time the card could take (bytes at HBM bandwidth or
operations at the FP64 peak, from the rows of each launch), over the sum of
`cost_forward_kernel`'s device time in the profiler."""


def read(record):
    launches, events = record["k1b"], record["device"]
    if record["missing"].get("k1b") or not launches or not events:
        return None
    device_s = sum(b - a for name, a, b in events
                   if record["k1b_kernel"] in name)
    if device_s <= 0.0:
        return None
    return 100.0 * sum(x["bound_s"] for x in launches) / device_s
