"""What the traced run (`--trace 1`) records: host spans around the calls
into each layer of the search, the work handed to kernel K1b and to the GP
surrogates, and the device's timeline from `torch.profiler`.

The spans come from hooks (`patch.Patches`) added for the traced window
only, around the program's public entry points, on the same installed
wrappers as the check's recorder; only the outermost span of a kind counts,
so no time is counted twice.  A name that is missing is
reported (`Tracer.missing`) and the metrics that need it are left out.
"""

from __future__ import annotations

import collections
import functools
import time

import numpy as np

import work

# (kind, module, owner, attribute): the entry points of each layer.  An
# owner of None wraps the module's own attribute.
SPANS = (
    ("outer", "repro_torch.core.nested", "SearchSession", "step"),
    ("inner", "repro_torch.core.nested", None, "optimize_software"),
    ("inner", "repro_torch.core.nested", None, "optimize_software_many"),
    ("inner", "repro_torch.core.nested", None, "optimize_software_fanout"),
    *(("gp", "repro_torch.core.gp", cls, attr)
      for cls, attrs in (("GP", ("fit", "posterior", "posterior_device",
                                 "append_observation")),
                         ("GPStack", ("fit", "posterior", "posterior_device",
                                      "score_device")),
                         ("GPClassifier", ("fit", "prob_feasible",
                                           "prob_feasible_device")),
                         ("GPClassifierStack", ("fit", "prob_feasible",
                                                "prob_feasible_device")))
      for attr in attrs),
    ("cost_model", "repro_torch.timeloop.batch_torch", None,
     "forward_device_stacked"),
    ("cost_model", "repro_torch.timeloop.batch_torch", None,
     "edp_lower_bounds_device"),
    ("cost_model", "repro_torch.timeloop.bounds", None, "lower_bound"),
    ("cost_model", "repro_torch.core.nested", None, "evaluate"),
    ("cost_model", "repro_torch.core.swspace", None, "evaluate"),
)
# Where the work is counted: K1b's operands, and the GP calls' shapes.
K1B_ENTRY = ("repro_torch.timeloop.batch_torch", None, "cost_forward")
K1B_KERNEL = "cost_forward_kernel"
GP_FITS = (("GP", "fit"), ("GPStack", "fit"))
GP_POSTERIORS = (("GP", "posterior_device"), ("GPStack", "posterior"),
                 ("GPStack", "posterior_device"), ("GPStack", "score_device"))


class Tracer:
    """Adds the traced run's hooks (`install`) and keeps what they see."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.spans: dict[str, list] = collections.defaultdict(list)
        self.missing: dict[str, list] = collections.defaultdict(list)
        self.k1b_calls: list = []     # (factors, order_gb, order_dram)
        self.gp_work: list = []       # ("fit" | "posterior", ns, d, n, kind)
        self._gp_rows: dict = {}      # id(model) -> (model, ns)
        self._depth = collections.Counter()

    def _outermost(self, kind: str, name: str):
        def hook(call, *args, **kwargs):
            self._depth[kind] += 1
            t = time.perf_counter()
            try:
                return call(*args, **kwargs)
            finally:
                self._depth[kind] -= 1
                if not self._depth[kind]:
                    self.spans[kind].append(
                        (name, t - self.t0, time.perf_counter() - self.t0))
        return hook

    def install(self, patches) -> None:
        for kind, module, owner, attr in SPANS:
            name = f"{owner}.{attr}" if owner else attr
            if not patches.hook(module, owner, attr,
                                self._outermost(kind, name)):
                self.missing[kind].append(f"{owner or module}.{attr}")
        if not patches.hook(*K1B_ENTRY, self._k1b):
            self.missing["k1b"].append(f"{K1B_ENTRY[0]}.{K1B_ENTRY[2]}")
        for owner, attr in GP_FITS + GP_POSTERIORS:
            if not patches.hook("repro_torch.core.gp", owner, attr,
                                functools.partial(self._gp, attr)):
                self.missing["gp_work"].append(f"{owner}.{attr}")

    def start(self) -> None:
        """Spans are timed from here: the window's start."""
        self.t0 = time.perf_counter()

    def _k1b(self, call, factors, order_gb, order_dram, *rest, **kwargs):
        # References only: the operands are read after the window.
        self.k1b_calls.append((factors, order_gb, order_dram))
        return call(factors, order_gb, order_dram, *rest, **kwargs)

    def _gp(self, attr: str, call, model, *args, **kwargs):
        self._depth["gp_work"] += 1
        try:
            return call(model, *args, **kwargs)
        finally:
            self._depth["gp_work"] -= 1
            if not self._depth["gp_work"]:
                self._count_gp(attr, model, args)

    def _count_gp(self, attr: str, model, args) -> None:
        if attr == "fit":
            X = args[0]
            runs = [X] if isinstance(X, np.ndarray) and X.ndim == 2 else X
            ns = [len(x) for x in runs]
            d = int(np.asarray(runs[0]).shape[-1]) if runs else 0
            self._gp_rows[id(model)] = (model, ns)
            self.gp_work.append(("fit", ns, d, model.steps, model.kind))
            return
        _, ns = self._gp_rows.get(id(model), (None, None))
        if ns is None:
            return   # fitted before the window: not the window's work
        shape = tuple(args[0].shape)
        self.gp_work.append(("posterior", ns, shape[-1], shape[-2],
                             model.kind))

    # --- after the window -------------------------------------------------

    def k1b_launches(self) -> list[dict]:
        """Rows, bytes, operations and bound of every K1b call, from the
        operands it was handed."""
        out = []
        for factors, order_gb, order_dram in self.k1b_calls:
            dtype = str(factors.dtype).removeprefix("torch.")
            f = factors.detach().cpu().numpy()
            rows = f.shape[0]
            n_bytes = work.k1b_bytes(rows, dtype)
            flops = work.k1b_flops(f, order_gb.cpu().numpy(),
                                   order_dram.cpu().numpy())
            out.append({"rows": rows, "dtype": dtype, "bytes": n_bytes,
                        "flops": flops,
                        "bound_s": work.k1b_bound_s(n_bytes, flops, dtype)})
        self.k1b_calls.clear()
        return out

    def gp_flops(self) -> float:
        total = 0.0
        for what, ns, d, n, kind in self.gp_work:
            total += (work.gp_fit_flops(ns, d, n, kind) if what == "fit"
                      else work.gp_posterior_flops(ns, n, d, kind))
        return total


def start_profiler():
    """A device-only profiler session: the host's op events would cost the
    window most of its time at these launch counts."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


def device_events(prof, window_wall_ns: int) -> list:
    """(name, start, end) of every device operation, in seconds from the
    window's start (`window_wall_ns`, the wall clock the profiler stamps
    its events with), sorted by start.  Read from the profiler's raw
    results: building its Python event tree costs minutes at millions of
    launches."""
    import torch

    prof.__exit__(None, None, None)
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            t = (e.start_ns() - window_wall_ns) / 1e9
            out.append((e.name(), t, t + e.duration_ns() / 1e9))
    out.sort(key=lambda e: e[1])
    return out


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))
