"""Run one cell of the port's benchmark once, on one NVIDIA card.

    python3 bench/run.py --workload resnet.table --seed 7 --seconds 10 \
        --trace 0

Prints an earlier JSON line with what the result may not hold (the card and
its power limit, the build, each search's statistics, best log10 EDP and
design hash, the steps and probes of the window), then the numbers the
check compared, each beside its limit, as the last lines on standard error,
and the result as the last line on standard output.  Exits 1, printing no
result, without a card, with fewer cards than the cell asks for, or where
JAX or the JAX package `repro` was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    sys.path[:0] = [str(BENCH), str(ROOT / "src")]
    # Kernel caches of any library the program loads stay at fixed paths
    # inside the checkout; K1b builds into build/repro_torch/ by itself.
    cache = ROOT / "build" / "bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    # One process with one host thread: the search's host work is a single
    # Python loop, and idle worker threads of the BLAS and PyTorch pools
    # only contend with it for the machine's shared cores.
    for var in THREAD_VARS:
        os.environ[var] = "1"

    import harness

    cell, config, traffic = harness.load_cell(args.workload)
    import torch

    torch.set_num_threads(1)

    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the port on an NVIDIA "
              "card", file=sys.stderr)
        return 1
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} cards; "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 1
    out = harness.run_cell(args.workload, config, traffic, args.seed,
                           args.seconds, bool(args.trace))
    found = harness.forbidden_modules()
    if found:
        print(f"the run loaded JAX or the JAX package: {found}",
              file=sys.stderr)
        return 1
    print(json.dumps({"info": out["info"]}), flush=True)
    for name, n in out["line"]["check"].items():
        print(f"check {name} {n['value']!r} limit {n['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out["line"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
