"""Device kernels in the traced window over the probes it evaluated."""

from tracing import is_kernel


def read(record):
    if not record["device"] or not record["probes"]:
        return None
    kernels = sum(1 for name, _, _ in record["device"] if is_kernel(name))
    return kernels / record["probes"]
