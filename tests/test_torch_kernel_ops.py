"""K3 and K3-bwd as registered ops (`repro_torch::flash_attention`,
`repro_torch::flash_attention_fwd`, `repro_torch::flash_attention_bwd`).

On the CPU: `torch.library.opcheck` of all three on CPU tensors (their
plain versions), and under `FakeTensorMode` the fake implementations run
and the plain versions do not.  On the card (the `cuda` marker; they skip
without one): `opcheck` on CUDA tensors in both dtypes, and a sharded train
step of a reduced smollm on a (1, 1) NCCL mesh launches K3 and K3-bwd, in a
process of its own (this file run as a script) so that no process group is
left in the pytest process.  This file imports no jax, so it runs on the
machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernel_ops.py
"""

from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

FA = importlib.import_module("repro_torch.kernels.flash_attention")
REPO = Path(__file__).resolve().parents[1]
OPS = torch.ops.repro_torch


def _operands(device, dtype, B=2, S=64, H=4, KV=2, hd=16, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=g).to(device, dtype)
            for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd))]


def _opcheck(device, dtype):
    q, k, v = _operands(device, dtype)
    res = [torch.library.opcheck(OPS.flash_attention.default, (q, k, v))]
    grads = [t.clone().requires_grad_() for t in (q, k, v)]
    res.append(torch.library.opcheck(OPS.flash_attention_fwd.default,
                                     (*grads, 0.25, 64)))
    o, lse = FA.flash_attention_fwd(q, k, v, scale=0.25, sk_valid=64)
    res.append(torch.library.opcheck(
        OPS.flash_attention_bwd.default,
        (q, k, v, o, lse, torch.randn_like(o), 0.25, 64)))
    for r in res:
        assert set(r.values()) == {"SUCCESS"}, r


def test_opcheck_on_cpu():
    _opcheck("cpu", torch.float32)


def test_fake_mode_runs_no_plain_version(monkeypatch):
    """Under FakeTensorMode the ops allocate only what the kernels write:
    the plain versions (a materialised score matrix) never run."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def boom(*a, **k):
        raise AssertionError("the plain version ran under FakeTensorMode")

    for name in ("flash_attention_ref", "flash_attention_lse_ref",
                 "flash_attention_bwd_ref"):
        monkeypatch.setattr(FA, name, boom)
    with FakeTensorMode():
        q, k, v = (torch.empty(2, 100, 4, 40), torch.empty(2, 100, 2, 40),
                   torch.empty(2, 100, 2, 40))
        with torch.no_grad():
            assert FA.flash_attention(q, k, v).shape == q.shape
        q.requires_grad_()
        out = FA.flash_attention(q, k, v)
        (g,) = torch.autograd.grad(out.sum(), (q,))
        assert out.shape == q.shape and g.shape == q.shape


def test_flop_formulas_count_the_causal_pairs():
    from torch.utils.flop_counter import FlopCounterMode

    q, k, v = _operands("cpu", torch.float32, S=64)
    with FlopCounterMode(display=False) as fc:
        FA.flash_attention(q, k, v)
    pairs = 64 * 65 // 2
    assert fc.get_total_flops() == 4 * 2 * 4 * 16 * pairs
    assert FA.causal_pairs(100, 64) == 64 * 65 // 2 + 36 * 64
    assert FA.causal_pairs(128, 128, 100) == 100 * 101 // 2 + 28 * 100


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_opcheck_on_the_card(dtype):
    _card()
    _opcheck("cuda", dtype)


@pytest.mark.cuda
def test_sharded_train_step_launches_k3_and_k3_bwd(tmp_path):
    _card()
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, __file__, str(tmp_path)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads((tmp_path / "out.json").read_text())
    assert got["fwd"] > 0 and got["bwd"] > 0, got
    assert np.isfinite(got["loss"]) and np.isfinite(got["grad_norm"])


def main(workdir: str) -> int:
    """A (1, 1) NCCL mesh: one sharded train step of a 2-layer smollm in
    bf16 on the card, with its K3 / K3-bwd launch counts."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding

    dist.init_process_group("nccl", init_method=f"file://{workdir}/store",
                            rank=0, world_size=1)
    try:
        cfg = dataclasses.replace(get_config("smollm-360m"), num_layers=2)
        shape = ShapeConfig("t", 256, 2, "train")
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        rules = sharding.AxisRules()
        opt_cfg = adamw.AdamWConfig()
        with sharding.use_mesh(mesh, rules):
            model, step = steps.make_train_step(cfg, opt_cfg, "cuda")
            state = steps.init_train_state(
                model, cfg, opt_cfg, torch.Generator("cuda").manual_seed(0))
            pspecs = steps.state_shardings(model, mesh, rules)["params"]
            params = steps.distribute(state["params"], pspecs, mesh)
            g = torch.Generator("cuda").manual_seed(1)
            tok = torch.randint(0, cfg.vocab_size, (2, 256), generator=g,
                                device="cuda")
            batch = steps.distribute({"tokens": tok, "labels": tok},
                                     steps.batch_sharding(cfg, shape, mesh,
                                                          rules), mesh)
            f0, b0 = FA.flash_attention.launches, FA.flash_attention_bwd.launches
            _, m = step({"params": params,
                         "opt": adamw.init_state(opt_cfg, params)}, batch)
            torch.cuda.synchronize()
        out = {"fwd": FA.flash_attention.launches - f0,
               "bwd": FA.flash_attention_bwd.launches - b0,
               "loss": float(m["loss"].full_tensor()),
               "grad_norm": float(m["grad_norm"].full_tensor())}
    finally:
        dist.destroy_process_group()
    Path(workdir, "out.json").write_text(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
