"""End-to-end training on the PyTorch port: a ~100M-parameter llama-style
model trained for a few hundred steps on the synthetic Markov-chain
pipeline, with checkpointing, an injected mid-run fault (restart exercised
for real), and loss reporting -- `examples/train_100m.py` on `repro_torch`,
attention through kernel K3 and its backward K3-bwd on the card.

    PYTHONPATH=src python examples/train_100m_torch.py --steps 300

The flags are the original's, and:

  --device cuda|cpu   where the steps run (the card by default; without a
                      CUDA device it stops with an error unless cpu is
                      given)
  --tiny              a 2-layer, 64-wide cut of the same configuration in
                      f32, for smoke runs on the host
  --init-from NPZ     start from these weights instead of a fresh draw:
                      the reference `LM.init` tree with its leaves under
                      '/'-joined paths (`convert.lm_params_from_reference`)
"""

import argparse
import dataclasses
import shutil
import tempfile

import numpy as np
import torch

from repro_torch import convert
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data.pipeline import DataConfig, SyntheticSource
from repro_torch.device import cli_device
from repro_torch.launch import steps as S
from repro_torch.optim import adamw
from repro_torch.runtime.fault_tolerance import ResilientLoop

# ~100M params: 12 layers x d_model 768, llama-style GQA + SwiGLU.
CFG_100M = ModelConfig(
    name="repro-100m",
    family="dense",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=4,
    d_ff=2048,
    vocab_size=32768,
    remat="none",
)

# The same family cut for smoke runs on the host.
CFG_TINY = dataclasses.replace(
    CFG_100M, name="repro-100m-tiny", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, d_ff=128, vocab_size=256, compute_dtype="float32")


def load_tree(path: str) -> dict:
    """The nested tree of an npz whose keys are '/'-joined paths."""
    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            *parents, leaf = key.split("/")
            node = tree
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = data[key]
    return tree


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--inject-fault", type=int, default=150,
                    help="step at which to inject a fault (-1 to disable)")
    ap.add_argument("--device", default="cuda",
                    help="where the steps run (cuda or cpu)")
    ap.add_argument("--tiny", action="store_true",
                    help="a 2-layer, 64-wide f32 cut for smoke runs")
    ap.add_argument("--init-from", default=None, metavar="NPZ",
                    help="start from the reference weights in NPZ")
    args = ap.parse_args(argv)
    device = cli_device(args.device, "train_100m_torch")

    cfg = CFG_TINY if args.tiny else CFG_100M
    shape = ShapeConfig("train100m", args.seq, args.batch, "train")
    opt_cfg = adamw.AdamWConfig(lr=6e-4, warmup_steps=30,
                                total_steps=args.steps)
    model, train_step = S.make_train_step(cfg, opt_cfg, device)
    state = S.init_train_state(model, cfg, opt_cfg,
                               torch.Generator().manual_seed(0))
    if args.init_from:
        model.load_params(convert.lm_params_from_reference(
            load_tree(args.init_from)))
        params = {k: p.detach() for k, p in model.named_parameters()}
        state = {"params": params, "opt": adamw.init_state(opt_cfg, params)}
    n = sum(p.numel() for p in state["params"].values())
    print(f"model: {n/1e6:.1f}M params | batch {args.batch}x{args.seq} "
          f"| {args.steps} steps | device {device}")

    source = SyntheticSource(cfg, shape, DataConfig(seed=0))
    ckpt_dir = tempfile.mkdtemp(prefix="repro100m_torch_")

    losses = []

    def step_fn(state, batch):
        tb = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        state, metrics = train_step(state, tb)
        return state, {k: float(v) for k, v in metrics.items()}

    def log(m):
        if "loss" in m:
            losses.append(m["loss"])
            if m["step"] % 25 == 0:
                print(f"step {m['step']:4d}  loss {m['loss']:.4f}  "
                      f"gnorm {m['grad_norm']:.2f}  {m['dt']*1e3:.0f} ms")
        else:
            print(f"*** {m}")

    loop = ResilientLoop(step_fn, source, ckpt_dir, save_every=50)
    faults = {args.inject_fault} if args.inject_fault >= 0 else None
    state, step, _, monitor = loop.run(state, 0, args.steps,
                                       fault_schedule=faults, log=log)
    first = sum(losses[:10]) / 10
    last = sum(losses[-10:]) / 10
    print(f"\ndone: loss {first:.3f} -> {last:.3f} "
          f"({'LEARNING' if last < first - 0.5 else 'check hyperparams'}) | "
          f"restarts survived, stragglers flagged: {monitor.flagged}")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    assert last < first, "training must reduce loss"


if __name__ == "__main__":
    main()
