"""The training entry point: real steps on the card, with checkpoints,
fault-tolerant restart, straggler monitoring and the synthetic data
pipeline (the port of `repro.launch.train`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --steps 200 --batch 8 --seq 256 --ckpt-dir /tmp/ckpt

Runs on the card (`--device cuda`, the default; it raises without CUDA) or
the host (`--device cpu`, e.g. with `--smoke`, the reduced config).  Weights
come from `--seed` through a `torch.Generator`, data from the NumPy
`SyntheticSource` on the same seed.  It prints the reference's lines, and
`main` returns the losses.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from repro_torch.configs.base import (ModelConfig, ShapeConfig, get_config,
                                      get_smoke_config)
from repro_torch.data.pipeline import DataConfig, SyntheticSource
from repro_torch.device import resolve_device
from repro_torch.launch import steps as S
from repro_torch.optim import adamw
from repro_torch.runtime.fault_tolerance import ResilientLoop


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


@dataclasses.dataclass
class TrainRun:
    """What `train` did: the loss of every step run (replays included, in
    order), the loop's metrics log, its restart events, the final state and
    step, the straggler monitor, the wall seconds of the loop and the
    checkpointer's (step, host copy s, write s) a save."""
    losses: list
    metrics_log: list
    restarts: list
    state: dict
    step: int
    monitor: object
    wall_s: float
    save_seconds: list


def opt_config(cfg: ModelConfig, args) -> adamw.AdamWConfig:
    return adamw.AdamWConfig(lr=args.lr, total_steps=args.steps,
                             warmup_steps=max(args.steps // 20, 10),
                             state_dtype=cfg.optimizer_dtype)


def train(cfg: ModelConfig, args, fault_schedule: set | None = None,
          log=None) -> TrainRun:
    """`args.steps` steps of `cfg` on `args.device` under the resilient loop;
    `log(record)` sees {"event": "init", "params": n} once the state is
    built, then every step's metrics and every restart event, and last
    {"event": "done", ...} with the run's step, wall seconds, straggler
    count and the checkpointer's save seconds."""
    device = resolve_device(args.device)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    opt_cfg = opt_config(cfg, args)
    model, train_step = S.make_train_step(cfg, opt_cfg, device)
    state = S.init_train_state(model, cfg, opt_cfg,
                               torch.Generator().manual_seed(args.seed))
    if log:
        log({"event": "init",
             "params": sum(p.numel() for p in state["params"].values())})
    source = SyntheticSource(cfg, shape, DataConfig(seed=args.seed))

    def step_fn(state, batch):
        tb = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        state, metrics = train_step(state, tb)
        return state, {k: float(v) for k, v in metrics.items()}

    losses, restarts = [], []

    def record(m):
        if "loss" in m:
            losses.append(m["loss"])
        elif m.get("event") == "restart":
            restarts.append(m)
        if log:
            log(m)

    loop = ResilientLoop(step_fn, source, args.ckpt_dir,
                         save_every=args.save_every)
    t0 = time.time()
    state, step, mlog, monitor = loop.run(state, 0, args.steps,
                                          fault_schedule=fault_schedule,
                                          log=record)
    run = TrainRun(losses, mlog, restarts, state, step, monitor,
                   time.time() - t0, list(loop.saver.save_seconds))
    if log:
        log({"event": "done", "step": step, "wall_s": run.wall_s,
             "stragglers": monitor.flagged, "save_seconds": run.save_seconds,
             "first_loss": losses[0], "last_loss": losses[-1]})
    return run


def main(argv=None, log=None):
    """The CLI; `log` sees every record `train` logs.  Returns the losses."""
    args = parse_args(argv)
    resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)

    def show(m):
        event = m.get("event")
        if event == "init":
            print(f"arch={cfg.name} params={m['params']/1e6:.1f}M "
                  f"batch={args.batch}x{args.seq} steps={args.steps}")
        elif event == "done":
            print(f"done: {m['step']} steps in {m['wall_s']:.0f}s | first "
                  f"loss {m['first_loss']:.4f} last loss {m['last_loss']:.4f} "
                  f"| stragglers flagged {m['stragglers']}")
        elif "loss" in m:
            if m["step"] % args.log_every == 0:
                print(f"step {m['step']:5d} loss {m['loss']:.4f} "
                      f"gnorm {m['grad_norm']:.3f} lr {m['lr']:.2e} "
                      f"{m['dt']*1e3:.0f}ms{' STRAGGLER' if m.get('straggler') else ''}")
        else:
            print(m)
        if log:
            log(m)

    return train(cfg, args, log=show).losses


if __name__ == "__main__":
    main()
