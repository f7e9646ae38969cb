"""Full nested HW/SW co-design on the DQN workload (the paper's best case:
40.2% EDP improvement over Eyeriss) on the PyTorch port: `examples/
codesign_dqn.py` on `repro_torch`, the cost model's forward one launch of
kernel K1b on the card.

    PYTHONPATH=src python examples/codesign_dqn_torch.py [--paper | --tiny]
        [--strategy auto|sequential|layer_batched|probe_fanout|speculative]
        [--hw-refit-every N] [--prune off|safe|aggressive]
        [--backend numpy|torch] [--save-config cfg.json] [--device cuda|cpu]

The flags are the original's; the port's backends are "torch" (the batched
cost model on `--device`) and "numpy" (the host engine; the GPs still run
on `--device`).  Without a CUDA device it stops with an error unless
`--device cpu` is given.  `--save-config` writes the `CodesignConfig` that
ran as JSON (`CodesignConfig.from_json` reads it back).
"""

import argparse
import dataclasses

from repro_torch.core import (BACKENDS, PRUNE_MODES, STRATEGIES,
                              CodesignConfig, CodesignEngine, EngineConfig,
                              HWSearchConfig, SWSearchConfig)
from repro_torch.device import cli_device
from repro_torch.timeloop import MODEL_LAYERS, eyeriss_baseline_edp


def build_config(args) -> CodesignConfig:
    if args.paper:  # 50 HW x 250 SW trials (paper §4.1)
        sw = SWSearchConfig()                      # 250 / 30 / 150
        hw = HWSearchConfig()                      # 50 / 5 / 150
    elif args.tiny:  # CI smoke budgets: seconds, exercises every layer
        sw = SWSearchConfig(n_trials=10, n_warmup=5, pool_size=16)
        hw = HWSearchConfig(n_trials=2, n_warmup=2, pool_size=16)
    else:
        sw = SWSearchConfig(n_trials=60, n_warmup=20, pool_size=60)
        hw = HWSearchConfig(n_trials=12, pool_size=60)
    hw = dataclasses.replace(hw, prune=args.prune)
    return CodesignConfig(
        sw=sw, hw=hw,
        engine=EngineConfig(backend=args.backend, strategy=args.strategy,
                            hw_gp_refit_every=args.hw_refit_every,
                            device=args.device),
        seed=0, verbose=not args.tiny,
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--paper", action="store_true", help="50 HW x 250 SW trials")
    ap.add_argument("--tiny", action="store_true",
                    help="smoke-test budgets (CI)")
    ap.add_argument("--backend", default="torch", choices=BACKENDS)
    ap.add_argument("--strategy", default="auto", choices=STRATEGIES)
    ap.add_argument("--hw-refit-every", type=int, default=1,
                    help="outer-loop GP refit stride; >1 batches the outer "
                         "acquisition into frozen q-batch windows (pairs "
                         "with --strategy speculative)")
    ap.add_argument("--prune", default="off", choices=PRUNE_MODES,
                    help="bound-gated pruning of doomed outer probes "
                         "(timeloop.bounds): 'safe' never changes the result")
    ap.add_argument("--save-config", default=None, metavar="PATH",
                    help="write the CodesignConfig that ran as JSON")
    ap.add_argument("--device", default="cuda",
                    help="where the search runs (cuda or cpu)")
    args = ap.parse_args(argv)
    args.device = cli_device(args.device, "codesign_dqn_torch")

    layers = MODEL_LAYERS["dqn"]
    base = eyeriss_baseline_edp(layers, num_pes=168, budget=4000)
    base_total = sum(base.values())
    print(f"Eyeriss baseline: model EDP {base_total:.3e}")
    for k, v in base.items():
        print(f"  {k}: {v:.3e}")

    config = build_config(args)
    # The config is one serializable object: JSON round-trip is exact.
    assert CodesignConfig.from_json(config.to_json()) == config
    if args.save_config:
        with open(args.save_config, "w") as f:
            f.write(config.to_json())
        print(f"wrote {args.save_config}")

    engine = CodesignEngine(config)
    print(f"search: {config.hw.n_trials} HW x {config.sw.n_trials} SW trials, "
          f"backend={engine.backend}, strategy={engine.strategy_name}, "
          f"device={args.device}")
    res = engine.run(layers)

    print(f"\nco-designed: model EDP {res.best_model_edp:.3e} "
          f"({(1 - res.best_model_edp / base_total) * 100:.1f}% better than Eyeriss)")
    if res.stats and res.stats["spec_evaluated"]:
        print(f"speculation: {res.stats['spec_evaluated']} probes evaluated "
              f"ahead of time, {res.stats['spec_hits']} consumed "
              f"(hit rate {res.stats['spec_hit_rate']:.0%})")
    if res.stats and config.hw.prune != "off":
        print(f"pruning: {res.stats['probes_gated']} probe(s) bound-gated, "
              f"{res.stats['prune_pruned']} pool candidate(s) removed "
              f"(pruned fraction {res.stats['pruned_fraction']:.0%})")
    hw = res.best_hw
    print(f"best hardware: PE array {hw.pe_mesh_x}x{hw.pe_mesh_y}, "
          f"LB split I/W/O = {hw.lb_input}/{hw.lb_weight}/{hw.lb_output}, "
          f"GB {hw.gb_instances} instance(s) "
          f"({hw.gb_mesh_x}x{hw.gb_mesh_y}, block {hw.gb_block}, "
          f"cluster {hw.gb_cluster}), dataflow fw={hw.df_fw} fh={hw.df_fh}")
    for name, edp in res.layer_edps.items():
        print(f"  {name}: {edp:.3e}  (eyeriss {base[name]:.3e})")


if __name__ == "__main__":
    main()
