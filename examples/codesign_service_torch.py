"""Co-design as a service on the PyTorch port: many tenants' nested
searches, one fused engine -- `examples/codesign_service.py` on
`repro_torch`, every fused dispatch's cost-model forwards launches of kernel
K1b on the card.

    PYTHONPATH=src python examples/codesign_service_torch.py [--tiny]
        [--warm-start] [--store-dir DIR] [--max-slots N] [--no-fuse]
        [--backend numpy|torch] [--executor inline|process] [--workers N]
        [--device cuda|cpu]

The flags are the original's, with the port's backends; `--device` (the
card by default) is where every request's engine runs, and the process
executor's workers too.  Without a CUDA device it stops with an error
unless `--device cpu` is given.

Submits a mixed batch of co-design requests (DQN + MLP workloads, one of them
round-tripped through the JSON queue surface), serves them concurrently --
each scheduler tick fuses every live session's pending inner software
searches into ONE cross-request stacked dispatch -- and prints per-request
results with latency/throughput and cache/store accounting.  Every result is
bit-identical to running that request standalone through
`CodesignEngine(config).run(layers)`.

With `--store-dir`, finished (hw, layer) searches persist in a
content-addressed design store and the batch is resubmitted once more: the
warm pass answers every request from disk without a single inner search.

With `--warm-start`, the service additionally keeps a cross-run trial history
and runs a third pass with `HWSearchConfig.warm_start` on: each request's
outer GP starts from the cold pass's recorded trials, exact store misses fall
back to approximate (nearest stored hardware) warm starts, and the printout
adds the consumed prior rows + warm hits plus a per-request cold-vs-warm
incumbent comparison.  Priors reshape the outer acquisition, so warm results
can differ from cold; what stays exact is the replay contract (pass 2 is
asserted bit-identical to pass 1) and that approximate hits always carry
exactly evaluated EDPs.
"""

import argparse
import dataclasses
import shutil
import tempfile

from repro_torch.core import (BACKENDS, EXECUTOR_KINDS, CodesignConfig,
                              EngineConfig, ExecutorConfig, HWSearchConfig,
                              ServiceConfig, SWSearchConfig)
from repro_torch.device import cli_device
from repro_torch.service import CodesignService, ServiceRequest, make_executor
from repro_torch.timeloop import MODEL_LAYERS


def build_requests(args) -> list[ServiceRequest]:
    if args.tiny:  # CI smoke budgets: seconds, exercises every layer
        sw = SWSearchConfig(n_trials=10, n_warmup=5, pool_size=16)
        hw = HWSearchConfig(n_trials=2, n_warmup=2, pool_size=16)
    else:
        sw = SWSearchConfig(n_trials=25, n_warmup=8, pool_size=60)
        hw = HWSearchConfig(n_trials=6, pool_size=60)
    reqs = []
    for i, model in enumerate(("dqn", "mlp", "dqn", "mlp")):
        cfg = CodesignConfig(sw=sw, hw=hw, seed=i,
                             engine=EngineConfig(backend=args.backend,
                                                 device=args.device))
        reqs.append(ServiceRequest(layers=tuple(MODEL_LAYERS[model]),
                                   config=cfg, rid=f"{model}-{i}"))
    # The queue surface is JSON: a request round-trips exactly.
    assert ServiceRequest.from_json(reqs[0].to_json()) == reqs[0]
    return reqs


def serve(requests, service_config, executor=None, baseline=None) -> dict:
    svc = CodesignService(service_config, executor=executor)
    rids = [svc.submit(r) for r in requests]
    responses = svc.run()
    for rid in rids:
        resp = responses[rid]
        stats = resp.result.stats
        transfer = (f"  prior {stats['prior_rows']}  "
                    f"warm {stats['warm_hits']}"
                    if stats.get("prior_rows") or stats.get("warm_hits")
                    else "")
        if baseline is not None:
            cold = baseline[rid].result.best_model_edp
            warm = resp.result.best_model_edp
            transfer += ("  vs cold: " + ("better" if warm < cold else
                                          "equal" if warm == cold else
                                          "worse"))
        print(f"  {rid}: model EDP {resp.result.best_model_edp:.3e}  "
              f"latency {resp.latency_s:.2f}s  ticks {resp.ticks}  "
              f"store {stats['store_hits']}h/{stats['store_misses']}m  "
              f"cache {stats['cache_hits']}h/{stats['cache_misses']}m"
              f"{transfer}")
    total = max(r.latency_s for r in responses.values())
    print(f"  throughput: {len(rids)} requests in {total:.2f}s "
          f"({len(rids) / total * 60:.1f} req/min), "
          f"{svc.stats['fused_dispatches']} fused dispatches over "
          f"{svc.stats['ticks']} ticks, "
          f"{svc.stats['deduped_items']} searches deduped across requests")
    return responses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true",
                    help="smoke-test budgets (CI)")
    ap.add_argument("--backend", default="torch", choices=BACKENDS)
    ap.add_argument("--max-slots", type=int, default=4,
                    help="concurrent search sessions per tick")
    ap.add_argument("--no-fuse", action="store_true",
                    help="one dispatch per request per tick (ablation; "
                         "results are identical either way)")
    ap.add_argument("--store-dir", default=None, metavar="DIR",
                    help="persistent design-store directory (default: a "
                         "temporary one, removed on exit)")
    ap.add_argument("--warm-start", action="store_true",
                    help="keep a cross-run trial history and run a third "
                         "pass with hw.warm_start on: outer GPs seeded from "
                         "the cold pass's recorded trials, approximate "
                         "(nearest stored hardware) warm starts on exact "
                         "store misses")
    ap.add_argument("--executor", default="inline", choices=EXECUTOR_KINDS,
                    help="where fused dispatches run: in-process (inline) or "
                         "on a worker-process pool (results are bit-identical "
                         "either way)")
    ap.add_argument("--workers", type=int, default=0,
                    help="process-executor pool width (0 = one per core, "
                         "capped at 4)")
    ap.add_argument("--device", default="cuda",
                    help="where the searches run (cuda or cpu)")
    args = ap.parse_args(argv)
    args.device = cli_device(args.device, "codesign_service_torch")

    store_dir = args.store_dir or tempfile.mkdtemp(prefix="design_store_")
    history_dir = (tempfile.mkdtemp(prefix="trial_history_")
                   if args.warm_start else None)
    sc = ServiceConfig(max_slots=args.max_slots, fuse=not args.no_fuse,
                       store_dir=store_dir, history_dir=history_dir,
                       executor=ExecutorConfig(kind=args.executor,
                                               n_workers=args.workers))
    requests = build_requests(args)

    # One shared executor across both passes, so the process pool's spawn +
    # import cost is paid once (exactly how a long-lived service would run).
    executor = make_executor(sc.executor)
    try:
        print(f"cold pass: {len(requests)} concurrent requests, "
              f"max_slots={sc.max_slots}, fuse={sc.fuse}, "
              f"executor={executor.kind}, store={store_dir}")
        cold = serve(requests, sc, executor)

        print("warm pass: same workload resubmitted -- every (hw, layer) "
              "search replays from the design store, zero inner searches")
        replay = serve(requests, sc, executor)
        assert all(replay[rid].result.best_model_edp
                   == cold[rid].result.best_model_edp
                   for rid in cold), "store replay changed a result"

        if args.warm_start:
            print("warm-start pass: hw.warm_start on -- outer GPs seeded "
                  "from the recorded trial history, approximate warm starts "
                  "on exact store misses")
            warm_requests = [
                dataclasses.replace(
                    r, config=dataclasses.replace(
                        r.config, hw=dataclasses.replace(
                            r.config.hw, warm_start=True)))
                for r in requests]
            serve(warm_requests, sc, executor, baseline=cold)
    finally:
        executor.close()
        if args.store_dir is None:
            shutil.rmtree(store_dir, ignore_errors=True)
        if history_dir is not None:
            shutil.rmtree(history_dir, ignore_errors=True)


if __name__ == "__main__":
    main()
