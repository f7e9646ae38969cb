"""The port's mesh branches, run sharded, held against the reference's
sharded runs: the vocab-sharded `embed` and `softmax_xent`, the
expert-parallel `moe_block` and a whole train step with FSDP, on a (2, 2)
("data", "model") mesh.

The reference runs once on 4 host devices (`tests/torch_port_reference.py`,
task "sharded").  The port runs in 4 processes joined by gloo, started by
this file run as a script (`python tests/test_torch_sharded.py <dir>`), so
no process group ever exists in the pytest process; rank 0 writes the
results.  A one-rank gloo world (`<dir> one`) holds the sharded train step
on a (1, 1) mesh to the unsharded one, bit for bit.  Bars:

  * embed: exact (a gather and a sum of one nonzero row);
  * softmax_xent (padded vocab): loss 1e-6 relative, each gradient 1e-6 of
    its largest value (f32; the sums over the vocab shards run in another
    order);
  * moe_block's shard-map branch (moonshot's E 64, k 6, narrow widths, T
    enough that experts overflow their capacity): 1e-2 of the output's
    largest value, the reference's own estimate of its bf16 combine
    (`repro.models.moe`), and two runs bit-equal;
  * a train step of a 2-layer smollm in f32: loss and grad norm 1e-5
    relative to the reference's sharded step and to the port's unsharded
    one.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from torch_port_reference import run_reference

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
VOCAB = 500                      # padded to 512: the last shard has padding
MOE = {"num_experts": 64, "top_k": 6, "d_model": 64, "d_ff": 32,
       "compute_dtype": "float32"}
TRAIN = {"compute_dtype": "float32", "kv_cache_dtype": "float32"}
B, S = 4, 64
# decode over a sharded cache: dense (KV length sharded) and the rolling
# window of local attention (smoke window 16, prompt 40: the window wraps)
DECODE_ARCHS = ("smollm-360m", "recurrentgemma-9b")
DECODE_S = 40


def _arrays(rng) -> dict:
    D, E, Fd = MOE["d_model"], MOE["num_experts"], MOE["d_ff"]
    skew = rng.normal(size=(D,))
    return {
        "table": (rng.normal(size=(512, 64)) * 0.1).astype(np.float32),
        "tokens": rng.integers(0, VOCAB, (4, 16)).astype(np.int32),
        "x": rng.normal(size=(4, 16, 64)).astype(np.float32),
        "labels": rng.integers(0, VOCAB, (4, 16)).astype(np.int32),
        "moe_ln": (rng.normal(size=(D,)) * 0.1).astype(np.float32),
        "moe_router": (rng.normal(size=(D, E)) * D ** -0.5).astype(np.float32),
        "moe_expert_wi": (rng.normal(size=(E, D, 2 * Fd)) * D ** -0.5
                          ).astype(np.float32),
        "moe_expert_wo": (rng.normal(size=(E, Fd, D)) * Fd ** -0.5
                          ).astype(np.float32),
        # a shared direction: the router sends most tokens to a few experts
        "moe_x": (rng.normal(size=(8, 64, D)) + 3.0 * skew
                  ).astype(np.float32),
        "train_tokens": rng.integers(0, 256, (B, S)).astype(np.int32),
        "train_labels": rng.integers(0, 256, (B, S)).astype(np.int32),
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded")
    arrays = _arrays(np.random.default_rng(0))
    spec = {"task": "sharded", "vocab_size": VOCAB, "moe_overrides": MOE,
            "train_overrides": TRAIN, "seq": S, "batch": B, "seed": 0}
    ref = run_reference(spec, arrays, d, host_devices=WORLD)
    params = {k: v for k, v in ref.items() if k.startswith("param/")}
    np.savez(d / "in.npz", **arrays, **params)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src"), str(REPO / "tests")]))
    proc = subprocess.run([sys.executable, __file__, str(d)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(d / "out.npz") as data:
        port = {k: data[k] for k in data.files}
    return ref, port


def test_embed_is_exact(runs):
    ref, port = runs
    assert np.array_equal(port["embed"], ref["embed"])


def test_softmax_xent_and_its_gradients(runs):
    ref, port = runs
    assert abs(port["xent"] - ref["xent"]) <= 1e-6 * abs(ref["xent"])
    for k in ("xent_gx", "xent_gt"):
        bar = 1e-6 * np.abs(ref[k]).max()
        assert np.abs(port[k] - ref[k]).max() <= bar, k


def test_moe_shard_map_branch(runs):
    ref, port = runs
    assert port["moe_overflowed"] > 0          # capacity is exercised
    err = np.abs(port["moe"] - ref["moe"]).max()
    assert err <= 1e-2 * np.abs(ref["moe"]).max(), err
    assert np.array_equal(port["moe"], port["moe_again"])


def test_sharded_train_step(runs):
    ref, port = runs
    for k in ("loss", "grad_norm"):
        got = float(port["train_" + k])
        for want in (float(ref["train_" + k]), float(port["plain_" + k])):
            assert abs(got - want) <= 1e-5 * abs(want), (k, got, want)


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_over_a_sequence_sharded_cache(runs, arch):
    """Prefill, then one decode step with the cache laid out as
    `cache_sharding` gives it (batch over "data", the KV length -- or the
    rolling window's slots -- over "model"), against the same steps with no
    mesh, f32: the port's flash-decoding split of the cache."""
    _, port = runs
    for k in ("prefill", "decode"):
        want = port[f"{arch}/plain_{k}"]
        err = np.abs(port[f"{arch}/sharded_{k}"] - want).max()
        assert err <= 1e-5 * np.abs(want).max(), (k, err)


def test_one_rank_mesh_is_bit_equal_to_no_mesh(tmp_path):
    """On a (1, 1) mesh every mesh branch runs and every collective moves
    nothing: three bf16 train steps of the smollm smoke config give the
    unsharded steps' losses and grad norms bit for bit (the card's
    `sharded_train` phase at a small size)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src"), str(REPO / "tests")]))
    proc = subprocess.run([sys.executable, __file__, str(tmp_path), "one"],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(tmp_path / "one.npz") as data:
        assert np.array_equal(data["sharded"], data["plain"]), (
            data["sharded"], data["plain"])


# ------------------------------------------------------- the port's ranks

def _decode_case(arch, mesh, rules) -> dict:
    """Prefill DECODE_S tokens and decode one at the last position, with no
    mesh and then with DTensor parameters and the cache laid out by
    `cache_sharding` (called under `use_mesh`)."""
    import torch

    from repro_torch.configs.base import ShapeConfig, get_smoke_config
    from repro_torch.launch import steps
    from repro_torch.models.model import build_model
    from repro_torch.parallel import sharding

    cfg = dataclasses.replace(get_smoke_config(arch), **TRAIN)
    model = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    params = {k: p.detach() for k, p in model.named_parameters()}
    g = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (B, DECODE_S), generator=g)
    nxt = torch.randint(0, cfg.vocab_size, (B, 1), generator=g)
    pos = DECODE_S - 1
    out = {}
    with sharding.use_mesh(None):
        logits, cache = model.prefill({"tokens": tokens})
        out[f"{arch}/plain_prefill"] = logits
        out[f"{arch}/plain_decode"] = model.decode_step(
            cache, {"tokens": nxt}, pos)[0]
    shape = ShapeConfig("t", DECODE_S, B, "decode")
    dparams = steps.distribute(params, steps.state_shardings(
        model, mesh, rules, opt=False), mesh)
    bspec = sharding.logical_spec(mesh, rules, ("batch", None))
    logits, cache = model.prefill(
        {"tokens": steps.distribute(tokens, bspec, mesh)}, dparams)
    specs = steps.cache_sharding(cfg, shape, mesh, rules)
    cache = [{k: t.redistribute(mesh, sharding.placements(sp[k], mesh))
              for k, t in c.items()} for c, sp in zip(cache, specs)]
    out[f"{arch}/sharded_prefill"] = logits.full_tensor()
    out[f"{arch}/sharded_decode"] = model.decode_step(
        cache, {"tokens": steps.distribute(nxt, bspec, mesh)}, pos,
        dparams)[0].full_tensor()
    return out


def _one_rank(workdir: str) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.configs.base import ShapeConfig, get_smoke_config
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding

    dist.init_process_group("gloo", init_method=f"file://{workdir}/store1",
                            rank=0, world_size=1)
    cfg = get_smoke_config("smollm-360m")
    opt_cfg = adamw.AdamWConfig(warmup_steps=1)
    shape = ShapeConfig("t", S, B, "train")
    g = torch.Generator().manual_seed(1)
    batches = [{k: torch.randint(0, cfg.vocab_size, (B, S), generator=g)
                for k in ("tokens", "labels")} for _ in range(3)]
    out = {}
    mesh = make_mesh((1, 1), ("data", "model"), "cpu")
    rules = sharding.AxisRules()
    for name, m in (("plain", None), ("sharded", mesh)):
        with sharding.use_mesh(m, rules):
            model, step = steps.make_train_step(cfg, opt_cfg, "cpu")
            state = steps.init_train_state(model, cfg, opt_cfg,
                                           torch.Generator().manual_seed(0))
            if m is not None:
                params = steps.distribute(state["params"], steps.
                                          state_shardings(model, m, rules)
                                          ["params"], m)
                state = {"params": params,
                         "opt": adamw.init_state(opt_cfg, params)}
            rows = []
            for b in batches:
                if m is not None:
                    b = steps.distribute(b, steps.batch_sharding(
                        cfg, shape, m, rules), m)
                state, met = step(state, b)
                rows.append([float(getattr(met[k], "full_tensor",
                                           lambda: met[k])())
                             for k in ("loss", "grad_norm")])
        out[name] = np.array(rows)
    np.savez(Path(workdir) / "one.npz", **out)
    dist.destroy_process_group()


def _rank(rank: int, workdir: str) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.configs.base import get_smoke_config
    from repro_torch.convert import lm_params_from_reference
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE_
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding
    from repro_torch.configs.base import ShapeConfig
    from torch_port_reference import unflat

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store",
                            rank=rank, world_size=WORLD)
    with np.load(Path(workdir) / "in.npz") as data:
        a = {k: data[k] for k in data.files}
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    rules = sharding.AxisRules()
    out = {}

    def put(t, *axes):
        return steps.distribute(torch.as_tensor(t), sharding.logical_spec(
            mesh, rules, axes), mesh)

    def param(name, t, period=1):
        return steps.distribute(torch.as_tensor(t), sharding.port_param_spec(
            name, t.shape, mesh, rules, period), mesh)

    with sharding.use_mesh(mesh, rules):
        table = param("embed.embedding", a["table"])
        tokens = put(a["tokens"].astype(np.int64), "batch", None)
        out["embed"] = L.embed({"embedding": table}, tokens).full_tensor()
        x = put(a["x"], "batch", None, None).requires_grad_()
        table = table.detach().requires_grad_()
        labels = put(a["labels"].astype(np.int64), "batch", None)
        loss = L.softmax_xent({"embedding": table}, x, labels, VOCAB)
        gx, gt = torch.autograd.grad(loss, (x, table))
        out.update(xent=loss.full_tensor(), xent_gx=gx.full_tensor(),
                   xent_gt=gt.full_tensor())

        mcfg = dataclasses.replace(get_smoke_config("moonshot-v1-16b-a3b"),
                                   **MOE)
        mp = {k: param(f"blocks.0.moe.{k}", a["moe_" + k])
              for k in ("ln", "router", "expert_wi", "expert_wo")}
        mx = put(a["moe_x"], "batch", None, None)
        MOE_.STATS.reset()
        out["moe"] = MOE_.moe_block(mp, mcfg, mx).full_tensor()
        out["moe_again"] = MOE_.moe_block(mp, mcfg, mx).full_tensor()
        over = torch.tensor(MOE_.STATS.read()["overflowed_experts"])
        dist.all_reduce(over)
        out["moe_overflowed"] = over

        for arch in DECODE_ARCHS:
            out.update(_decode_case(arch, mesh, rules))

    cfg = dataclasses.replace(get_smoke_config("smollm-360m"), **TRAIN)
    shape = ShapeConfig("t", S, B, "train")
    opt_cfg = adamw.AdamWConfig(state_dtype=cfg.optimizer_dtype)
    params = lm_params_from_reference(unflat(a, "param"))
    batch = {"tokens": torch.as_tensor(a["train_tokens"]).long(),
             "labels": torch.as_tensor(a["train_labels"]).long()}
    _, step = steps.make_train_step(cfg, opt_cfg, "cpu")
    _, m = step({"params": params, "opt": adamw.init_state(opt_cfg, params)},
                batch)
    out.update(plain_loss=m["loss"], plain_grad_norm=m["grad_norm"])
    with sharding.use_mesh(mesh, rules):
        model, step = steps.make_train_step(cfg, opt_cfg, "cpu")
        pspecs = steps.state_shardings(model, mesh, rules)["params"]
        dparams = steps.distribute(params, pspecs, mesh)
        dbatch = steps.distribute(batch, steps.batch_sharding(
            cfg, shape, mesh, rules), mesh)
        _, m = step({"params": dparams,
                     "opt": adamw.init_state(opt_cfg, dparams)}, dbatch)
        out.update(train_loss=m["loss"].full_tensor(),
                   train_grad_norm=m["grad_norm"].full_tensor())
    if rank == 0:
        np.savez(Path(workdir) / "out.npz",
                 **{k: v.detach().numpy() for k, v in out.items()})
    dist.destroy_process_group()


def main(workdir: str, what: str = "world") -> int:
    import logging
    import warnings

    import torch.multiprocessing as mp

    warnings.simplefilter("ignore")
    logging.disable(logging.WARNING)
    if what == "one":
        _one_rank(workdir)
    else:
        mp.spawn(_rank, args=(workdir,), nprocs=WORLD)
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
