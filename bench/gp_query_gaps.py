"""Every GP query of a window judged as `reference/check.py` judges its
sample: the posterior at the program's own hyperparameters and, for the
inner searches' scoring, the likelihood its fit reaches and the candidate it
chose.

The check keeps a sample of 8 queries of each kind and the last.  Here
every query of the window is kept and handed to `check.check_gp` on its
own, so a reading past a limit names its query.

    python3 bench/gp_query_gaps.py --workload resnet.table \
        --seed 3141592602 --seconds 1 [--device cpu]

Runs the cell's set-up and a window of `--seconds` (the window ends with
the search step that crosses it, so 1 s is the first step) and prints one
JSON line: for each of the check's GP numbers, the queries judged, the
count and share past its limit, the largest reading and the median; and
each query's kind and readings.  The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
NUMBERS = ("gp_posterior_gap", "gp_choice_regret", "gp_fit_shortfall")


def judge(records: list[dict]) -> dict:
    """Each record (`harness.Recorder.gp_records`) judged by
    `check.check_gp` alone, and per number the queries past its limit."""
    from reference import check

    readings = [check.check_gp([rec]) for rec in records]
    out: dict = {"queries": len(readings)}
    for i, name in enumerate(NUMBERS):
        values = [r[i] for r in readings]
        past = sum(v > check.LIMITS[name] for v in values)
        out[name] = {"limit": check.LIMITS[name], "past": past,
                     "past_share": past / len(values) if values else 0.0,
                     "max": max(values, default=0.0),
                     "median": statistics.median(values) if values else 0.0}
    out["readings"] = [[rec["kind"], *r] for rec, r in zip(records, readings)]
    return out


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

    torch.set_num_threads(1)
    _, config, traffic = harness.load_cell(args.workload)
    # Keep every query of the window, not the check's sample.
    harness.GP_SAMPLE = 1 << 20
    out = {}
    check_gp = check.check_gp

    def kept(records):
        check.check_gp = check_gp
        out.update(judge(records))
        return check_gp(records)

    check.check_gp = kept
    try:
        res = harness.run_cell(args.workload, config, traffic, args.seed,
                               args.seconds, False, device=args.device)
    finally:
        check.check_gp = check_gp
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "device": args.device,
                      "probes": res["info"]["probes"],
                      "check": res["line"]["check"], **out}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
