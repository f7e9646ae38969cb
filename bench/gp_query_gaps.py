"""Every GP scoring query of a window, each run held against the check's
reference: how often the program's own posterior, and the eager fit's,
part from the reference's refit by more than the check's limit.

The check (`reference/check.py`) keeps a sample of 8 scoring queries
(`GPStack.score_device`) and the last, refits each run of each with
`reference/gp.py` from its own data, and fails the run where a posterior
mean or standard deviation parts from the reference's by more than
`gp_posterior_gap`'s limit, in units of the spread of the run's data.  Here
every scoring query of the window is kept, and each run is compared three
ways:

  * program   the posterior the program gave (on the card, K4's fit where
              `kernels.gp_fit.fit_path` routes there; on the CPU the eager
              fit) against the reference's;
  * eager     the same data refit by the program's eager autograd fit
              (`core.gp._fit`, the path the program took before K4), on the
              same device, against the reference's;
  * program_vs_eager  the two posteriors against each other.

A share q of queries past the limit fails a run's 9 kept queries with
probability about 1 - (1 - q)^9, so the shares say whether a program's
fit, or the reference's refit, is what trips the check.  The reference's
fit forms K^-1 for its gradient; on the pinned-noise linear fits above the
kernel's rank (cond K ~1e12) any two float64 fits part by ~1e-6 in their
hyperparameters, and some posteriors move by whole data spreads for that.

    python3 bench/gp_query_gaps.py --workload resnet.table \
        --seed 3141592602 --seconds 1 [--device cpu]

Runs the cell's set-up and a window of `--seconds` (the window ends with
the search step that crosses it, so 1 s is the first step) and prints one
JSON line: for each comparison, the runs and queries compared, the shares
and counts past the limit, the largest gap, the median, and the counts by
the run's rows; and the fit paths the window's `gp.fit` calls took.  The
benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import sys
from pathlib import Path

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def gap(mu, var, mu_ref, var_ref, scale: float) -> float:
    """`check.check_gp`'s posterior gap of one run: the widest difference
    of a mean or a standard deviation, over `scale`; inf where not a
    number."""
    gaps = np.concatenate([
        np.abs(np.asarray(mu) - mu_ref),
        np.abs(np.sqrt(np.maximum(np.asarray(var), 0.0))
               - np.sqrt(np.maximum(var_ref, 0.0)))])
    return (float(np.max(gaps)) / scale if np.all(np.isfinite(gaps))
            else math.inf)


def summarise(rows: list[tuple[int, int, float]], limit: float) -> dict:
    """`rows`: (query, the run's rows, gap) of each run.  The runs and
    queries past `limit`, the largest and median gap, and by 8-row bucket
    (runs, runs past)."""
    if not rows:
        return {"runs": 0, "queries": 0}
    gaps = [g for _, _, g in rows]
    worst: dict[int, float] = {}
    buckets: dict[int, list[int]] = {}
    for q, n, g in rows:
        worst[q] = max(worst.get(q, 0.0), g)
        b = buckets.setdefault(n // 8 * 8, [0, 0])
        b[0] += 1
        b[1] += g > limit
    past = sum(g > limit for g in gaps)
    q_past = sum(g > limit for g in worst.values())
    return {"runs": len(gaps), "runs_past": past,
            "runs_past_share": past / len(gaps),
            "queries": len(worst), "queries_past": q_past,
            "queries_past_share": q_past / len(worst),
            "max": max(gaps), "median": statistics.median(gaps),
            "by_rows": {str(k): v for k, v in sorted(buckets.items())}}


def compare(records: list[dict], eager_posterior) -> dict:
    """The three comparisons over the scoring records (`harness.Recorder.
    gp_records`); `eager_posterior(rec)` gives the eager refit's (mu, var),
    each (runs, pool)."""
    from reference import check
    from reference import gp as ref_gp

    limit = check.LIMITS["gp_posterior_gap"]
    rows: dict[str, list] = {"program": [], "eager": [],
                             "program_vs_eager": []}
    for q, rec in enumerate(records):
        mu_e, var_e = eager_posterior(rec)
        for r, (X, y) in enumerate(zip(rec["X"], rec["y"])):
            if r >= len(rec["pool"]):
                break
            p = ref_gp.fit(rec["kernel"], rec["noisy"], X, y)
            mu, var = ref_gp.posterior(rec["kernel"], p, X, y,
                                       rec["pool"][r])
            scale = max(float(np.std(y)), 1e-3)
            n = len(y)
            rows["program"].append(
                (q, n, gap(rec["mu"][r], rec["var"][r], mu, var, scale)))
            rows["eager"].append((q, n, gap(mu_e[r], var_e[r], mu, var,
                                            scale)))
            rows["program_vs_eager"].append(
                (q, n, gap(rec["mu"][r], rec["var"][r], mu_e[r],
                           np.maximum(var_e[r], 0.0), scale)))
    return {"limit": limit,
            **{k: summarise(v, limit) for k, v in rows.items()}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"

    import harness
    import torch

    from reference import check
    from repro_torch.core import gp
    from repro_torch.kernels import gp_fit as k4

    torch.set_num_threads(1)
    _, config, traffic = harness.load_cell(args.workload)
    # Keep every query of the window, not the check's sample.
    harness.GP_SAMPLE = 1 << 20
    paths: dict[str, int] = {}
    fit_path = k4.fit_path

    def counted(*a):
        path = fit_path(*a)
        paths[path] = paths.get(path, 0) + 1
        return path

    def eager_posterior(rec):
        stack = gp.GPStack(kind=rec["kernel"], noisy=rec["noisy"],
                           device=args.device)
        k4.fit_path = lambda *a: "eager"
        try:
            stack.fit(rec["X"], rec["y"])
        finally:
            k4.fit_path = counted
        mu, var = stack.posterior(rec["pool"])
        return np.asarray(mu), np.asarray(var)

    out = {}
    check_gp = check.check_gp

    def kept(records):
        scoring = [r for r in records if r["kind"] == "GPStack.score"]
        out.update(compare(scoring, eager_posterior))
        return check_gp(records)

    k4.fit_path = counted
    check.check_gp = kept
    try:
        res = harness.run_cell(args.workload, config, traffic, args.seed,
                               args.seconds, False, device=args.device)
    finally:
        check.check_gp = check_gp
        k4.fit_path = fit_path
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "device": args.device,
                      "probes": res["info"]["probes"],
                      "check": res["line"]["check"],
                      "fit_paths": paths, **out}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
