"""Portfolio co-design on the PyTorch port: ONE chip scored against a
weighted mix of zoo models -- `examples/codesign_portfolio.py` on
`repro_torch`, the stacked inner dispatches' cost-model forwards launches
of kernel K1b on the card.

    PYTHONPATH=src python examples/codesign_portfolio_torch.py [--tiny]
        [--workloads NAME,NAME,...] [--weights W,W,...]
        [--backend numpy|torch] [--specialists] [--service]
        [--device cuda|cpu]

The flags are the original's, with the port's backends; `--device` (the
card by default) is where the searches run.  Without a CUDA device it stops
with an error unless `--device cpu` is given.

Builds a `PortfolioConfig` over workload-zoo models (modern LLM configs turned
into deduped ConvLayer sets, MACs cross-checked against `models/flops.py`),
runs the portfolio outer search -- every trial fans the union of all members'
layers into one stacked inner dispatch and scores the chip by the weighted
geomean of per-member EDPs -- and prints the winning hardware, the per-member
EDP split, and the Pareto front of non-dominated probes.

`--specialists` additionally runs one standalone search per member at the same
budgets and prints the specialist-vs-portfolio EDP table (the generalization
gap of one-chip-per-model vs one-chip-for-all).  `--service` round-trips the
same portfolio through the co-design service's JSON queue surface and asserts
the result is identical.
"""

import argparse
import json

from repro_torch.core import (BACKENDS, CodesignConfig, CodesignEngine,
                              EngineConfig, HWSearchConfig, ServiceConfig,
                              SWSearchConfig)
from repro_torch.device import cli_device
from repro_torch.service import CodesignService, ServiceRequest
from repro_torch.workloads import (PortfolioConfig, portfolio_codesign,
                                   resolve_workload)


def build_config(args) -> CodesignConfig:
    if args.tiny:  # CI smoke budgets: seconds, exercises every layer
        sw = SWSearchConfig(n_trials=10, n_warmup=5, pool_size=16)
        hw = HWSearchConfig(n_trials=2, n_warmup=2, pool_size=16)
    else:
        sw = SWSearchConfig(n_trials=25, n_warmup=8, pool_size=60)
        hw = HWSearchConfig(n_trials=6, pool_size=60)
    return CodesignConfig(sw=sw, hw=hw, seed=args.seed,
                          engine=EngineConfig(backend=args.backend,
                                              device=args.device))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true",
                    help="smoke-test budgets (CI)")
    ap.add_argument("--workloads",
                    default="smollm_360m,qwen3_14b,moonshot_v1_16b_a3b",
                    help="comma-separated zoo/paper workload names")
    ap.add_argument("--weights", default=None,
                    help="comma-separated member weights (default: uniform)")
    ap.add_argument("--backend", default="torch", choices=BACKENDS)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--specialists", action="store_true",
                    help="also run per-member standalone searches and print "
                         "the specialist-vs-portfolio EDP table")
    ap.add_argument("--service", action="store_true",
                    help="round-trip the portfolio through the co-design "
                         "service JSON surface and check parity")
    ap.add_argument("--device", default="cuda",
                    help="where the searches run (cuda or cpu)")
    args = ap.parse_args(argv)
    args.device = cli_device(args.device, "codesign_portfolio_torch")

    workloads = tuple(w.strip() for w in args.workloads.split(","))
    weights = (tuple(float(w) for w in args.weights.split(","))
               if args.weights else ())
    pf = PortfolioConfig(workloads=workloads, weights=weights)
    # The portfolio spec is JSON all the way down.
    assert PortfolioConfig.from_json(pf.to_json()) == pf
    cfg = build_config(args)

    n_layers = sum(len(resolve_workload(w)) for w in workloads)
    print(f"portfolio: {', '.join(workloads)}  "
          f"weights={[round(w, 3) for w in pf.normalized_weights()]}  "
          f"({n_layers} stacked layers per outer trial)")
    res = portfolio_codesign(pf, cfg)
    edps = res.stats["portfolio_member_edps"]
    print(f"  best chip: {res.best_hw}")
    print(f"  weighted-geomean EDP {res.best_model_edp:.3e}")
    for name in workloads:
        print(f"    {name}: EDP {edps[name]:.3e}")
    front = res.stats["portfolio_pareto"]
    print(f"  pareto front: {len(front)} non-dominated probes")
    for p in front[:5]:
        cells = "  ".join(f"{m}={e:.2e}" for m, e in p["member_edps"].items())
        print(f"    {cells}")

    if args.specialists:
        print("specialists: one standalone search per member, same budgets")
        table = {}
        for name in workloads:
            r = CodesignEngine(cfg).run(list(resolve_workload(name)))
            table[name] = r.best_model_edp
            own = edps[name] / r.best_model_edp
            print(f"    {name}: specialist EDP {r.best_model_edp:.3e}  "
                  f"(portfolio chip is {own:.2f}x on this model)")

    if args.service:
        print("service: same portfolio through the JSON queue surface")
        svc = CodesignService(ServiceConfig())
        req = ServiceRequest.from_dict(json.loads(json.dumps(
            {"portfolio": pf.to_dict(), "config": cfg.to_dict(),
             "rid": "portfolio-0"})))
        svc.submit(req)
        resp = svc.run()["portfolio-0"]
        svc.close()
        assert resp.result.best_hw == res.best_hw
        assert resp.result.stats["portfolio_member_edps"] == edps
        print(f"    parity OK: service EDP {resp.result.best_model_edp:.3e} "
              f"in {resp.latency_s:.2f}s")


if __name__ == "__main__":
    main()
