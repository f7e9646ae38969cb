"""Quickstart on the PyTorch port: the paper's technique in ~40 lines.

Optimize the software mapping of one ResNet layer on the Eyeriss accelerator
with constrained Bayesian optimization, and compare against constrained random
search -- `examples/quickstart.py` on `repro_torch`, the cost model's forward
one launch of kernel K1b on the card.

    PYTHONPATH=src python examples/quickstart_torch.py [--tiny] [--device cuda|cpu]

`--tiny` cuts the budgets (30 trials, 10 warm-up, pools of 30) for a smoke
run.  Without a CUDA device it stops with an error unless `--device cpu` is
given.
"""

import argparse

from repro_torch.core import SoftwareSpace, bo_maximize, random_search
from repro_torch.device import cli_device
from repro_torch.timeloop import PAPER_WORKLOADS, evaluate, eyeriss_168


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true",
                    help="smoke-test budgets (30 trials)")
    ap.add_argument("--device", default="cuda",
                    help="where the cost model and the GPs run (cuda or cpu)")
    args = ap.parse_args(argv)
    device = cli_device(args.device, "quickstart_torch")
    n_trials, n_warmup, pool = (30, 10, 30) if args.tiny else (100, 25, 100)

    hw = eyeriss_168()
    layer = PAPER_WORKLOADS["ResNet-K2"]
    space = SoftwareSpace(hw, layer, device=device)
    print(f"layer {layer.name}: {layer.macs/1e6:.1f}M MACs on Eyeriss "
          f"({hw.pe_mesh_x}x{hw.pe_mesh_y} PEs), device {device}")

    r_random = random_search(space, n_trials=n_trials, seed=0)
    r_bo = bo_maximize(space, n_trials=n_trials, n_warmup=n_warmup,
                       pool_size=pool, seed=0, device=device)

    for name, r in (("random", r_random), ("constrained BO", r_bo)):
        ev = evaluate(hw, r.best_point, layer)
        print(f"{name:16s}: EDP {ev.edp:.3e} pJ*cycles "
              f"(energy {ev.energy_pj:.3e} pJ, delay {ev.delay_cycles:.3e} cyc)")
    gain = 10 ** (r_bo.best_value - r_random.best_value)
    print(f"BO finds a {gain:.2f}x better EDP within the same "
          f"{n_trials}-trial budget")

    m = r_bo.best_point
    print("\nbest mapping (factors per level, dims R,S,P,Q,C,K):")
    for lvl, row in zip(("LB", "spatialX", "spatialY", "GB", "DRAM"), m.factors):
        print(f"  {lvl:9s} {row}")
    print(f"  loop order GB:   {m.order_gb}")
    print(f"  loop order DRAM: {m.order_dram}")


if __name__ == "__main__":
    main()
