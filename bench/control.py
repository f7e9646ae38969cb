"""The readings that the limits of `reference/check.py` are set from: the
program's own runs, its lower-precision control, and planted faults, each at
a cell's own size, several seeds in one process.  The benchmark's runs never
run this.

    python3 bench/control.py --workload resnet.table --mode float32 \
        --seeds 11 12 13 [--seconds 40]

Modes:
  program   the program as the cell runs it (the lower readings)
  float32   the control: the program's own float32 path of the cost model
            (K1b's float32 instance, the bounds in float32) in place of the
            float64 the configuration states
  gp32      the control of the GP surrogates: their fits, posteriors and
            scoring in float32 (the program's one dtype constant) in place
            of the float64 the configuration states
  gp_halfsteps
            a fault: every GP fit of the program (the surrogates' stacks,
            the outer GP, the classifiers) stopped at half of its 80 Adam
            steps
  gp_tail   a fault: every posterior mean of the GP surrogates raised by
            half of its data's spread on the last 15% of each pool, as a
            fused scoring that goes wrong past a tile's edge would
  altered   a fault: K1b's utility, the cost model's answer, raised by 1e-6
            where it is produced
  half      a fault: each stacked inner search searches half of its
            (hardware, layer) items and leaves the rest out
  unchanged a fault: a search step that returns with the session's state
            unchanged

Prints one JSON line per seed: the check's numbers, `correct`, the probes.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


BATCH = "repro_torch.timeloop.batch_torch"
NESTED = "repro_torch.core.nested"


def float32(patches) -> None:
    def forced(call, *args, **kwargs):
        return call(*args, **{**kwargs, "dtype": "float32"})

    patches.hook(BATCH, None, "forward_device_stacked", forced)
    patches.hook(BATCH, None, "edp_lower_bounds_device", forced)


def gp32(patches) -> None:
    import torch

    patches.set("repro_torch.core.gp", "_F64", torch.float32)


def gp_halfsteps(patches) -> None:
    def halved(call, model, *args, **kwargs):
        model.steps = 40
        return call(model, *args, **kwargs)

    for owner in ("GP", "GPStack"):
        patches.hook("repro_torch.core.gp", owner, "fit", halved)


def gp_tail(patches) -> None:
    import torch

    def raised(call, params, X, y, mask, Xs, *args, **kwargs):
        mu, var = call(params, X, y, mask, Xs, *args, **kwargs)
        n = mask.sum(dim=1)
        mean = (y * mask).sum(dim=1) / n
        spread = torch.sqrt((((y - mean[:, None]) * mask) ** 2).sum(dim=1)
                            / n)
        mu = mu.clone()
        tail = mu.shape[-1] - (15 * mu.shape[-1]) // 100
        mu[..., tail:] += 0.5 * spread[:, None]
        return mu, var

    patches.hook("repro_torch.core.gp", None, "_posterior", raised)


def altered(patches) -> None:
    def raised(call, *args, **kwargs):
        out = call(*args, **kwargs)
        return {**out, "utility": out["utility"] + 1e-6}

    patches.hook(BATCH, None, "cost_forward", raised)


def half(patches) -> None:
    def many(call, hw, layers, *args, **kwargs):
        return call(hw, list(layers)[:max(1, len(layers) // 2)],
                    *args, **kwargs)

    def fanout(call, items, *args, seeds, **kwargs):
        k = max(1, len(items) // 2)
        kwargs.pop("pad_to", None)
        return call(list(items)[:k], *args, seeds=list(seeds)[:k], **kwargs)

    patches.hook(NESTED, None, "optimize_software_many", many)
    patches.hook(NESTED, None, "optimize_software_fanout", fanout)


def unchanged(patches) -> None:
    def idle(call, session):
        return not session.done

    patches.hook(NESTED, "SearchSession", "step", idle)


MODES = {"program": None, "float32": float32, "gp32": gp32,
         "gp_halfsteps": gp_halfsteps, "gp_tail": gp_tail,
         "altered": altered, "half": half, "unchanged": unchanged}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", choices=sorted(MODES), required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=None,
                    help="the window; the manifest's run_seconds by default")
    args = ap.parse_args()
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]

    import harness
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    _, config, traffic = harness.load_cell(args.workload)
    seconds = (harness.load_manifest()["run_seconds"] if args.seconds is None
               else args.seconds)
    for seed in args.seeds:
        out = harness.run_cell(args.workload, config, traffic, seed,
                               seconds, False,
                               patch=MODES[args.mode])
        line = out["line"]
        print(json.dumps({"workload": args.workload, "mode": args.mode,
                          "seed": seed, "correct": line["correct"],
                          "attempted": line["attempted"],
                          "failed": line["failed"], "check": line["check"],
                          "window_s": out["info"]["window_s"],
                          "searches": out["info"]["searches"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
