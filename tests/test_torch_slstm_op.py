"""The sLSTM's scan as a registered op pair (`repro_torch::slstm_scan`,
`repro_torch::slstm_scan_bwd`, in `repro_torch.models.slstm_scan`).

  * both ops pass `torch.library.opcheck` (schema, fake implementation,
    autograd registration, AOT dispatch);
  * the op's forward is bit-equal to the plain loop (`_slstm_scan_plain`),
    and its backward within 1e-6 of the largest gradient of autograd
    through that loop (at S 512, of the loop run in f64);
  * against the JAX reference (run in a subprocess,
    `tests/torch_port_reference.py` case "slstm_scan") on xlstm-1.3b's
    smoke config: the scan's outputs and its VJP (`jax.vjp` through
    `jax.lax.scan`) within 1e-5 of their largest values; the whole block
    through the op, forward and `jax.grad`, within the bars the reference's
    own sLSTM comparison uses (1e-4, `tests/test_torch_recurrent.py`);
  * `CostMode` (the dry-run's counter) on one sLSTM block at S = 32: the
    op's FLOPs and collective bytes equal the plain loop's in the forward;
    forward plus backward, the op counts one more forward (its backward
    recomputes the steps), by the registered formula;
  * the fake-world dry-run (this file run as a script, in a child process):
    xlstm-1.3b cut to one period on the 16 x 16 mesh, through the shard-map
    branch -- a prefill and a train step at S 32 count the same FLOPs and
    collective bytes through the op as through the plain loop (the train
    step one forward more a layer), and the train cell at S 256 traces
    through the op, one call a layer a pass, in seconds.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_port_reference import (F32, assert_close, assert_grads,
                                  port_config, run_reference, unflat)

from repro_torch.models import slstm_scan as SS
from repro_torch.models import xlstm as XL

REPO = Path(__file__).resolve().parents[1]
B, S = 2, 24
GRAD_BAR = 1e-6        # the op's backward against autograd through the loop
REF_BAR = 1e-5         # the scan and its VJP against the reference's
BLOCK_BAR = 1e-4       # the block, as tests/test_torch_recurrent.py holds it


def _cfg():
    return port_config("xlstm-1.3b", F32)


def _inputs(rng, B=B, S=S, cfg=None):
    """Gate pre-activations, recurrent weights and a carry with a live
    stabiliser (m not at its -1e30 start), f32, as numpy."""
    cfg = cfg or _cfg()
    H, D = cfg.num_heads, cfg.d_model
    dh = D // H
    a = {f"g{k}": rng.normal(size=(B, S, D)) for k in "ifzo"}
    a.update({f"r{k}": rng.normal(size=(H, dh, dh)) * dh ** -0.5
              for k in "ifzo"})
    a.update(h0=rng.normal(size=(B, H, dh)) * 0.3,
             c0=rng.normal(size=(B, H, dh)) * 0.3,
             n0=rng.uniform(0.5, 1.5, size=(B, H, dh)),
             m0=rng.normal(size=(B, H, dh)))
    return {k: v.astype(np.float32) for k, v in a.items()}


def _dicts(a, grad=False):
    def t(x):
        x = torch.from_numpy(np.array(x))
        return x.requires_grad_() if grad else x

    return ({k: t(a[f"r{k}"]) for k in "ifzo"},
            {k: t(a[f"{k}0"]) for k in "hcnm"},
            {k: t(a[f"g{k}"]) for k in "ifzo"})


def _grads(fn, a, dhs, dcarry, H):
    """Gradients of gates, r and carry through `fn` for the cotangents."""
    r, c, g = _dicts(a, grad=True)
    hs, last = fn(r, c, g, H)
    torch.autograd.backward([hs, *(last[k] for k in "hcnm")],
                            [dhs, *(dcarry[k] for k in "hcnm")])
    return ({k: g[k].grad for k in "ifzo"}, {k: r[k].grad for k in "ifzo"},
            {k: c[k].grad for k in "hcnm"})


def _op_args(a, H):
    r, c, g = _dicts(a)
    return (*(g[k] for k in "ifzo"), *(r[k] for k in "ifzo"),
            *(c[k] for k in "hcnm"), H)


def test_opcheck_forward_and_backward():
    from torch.library import opcheck

    cfg = _cfg()
    a = _inputs(np.random.default_rng(0), S=5)
    args = tuple(x.requires_grad_() if isinstance(x, torch.Tensor) else x
                 for x in _op_args(a, cfg.num_heads))
    opcheck(torch.ops.repro_torch.slstm_scan.default, args)
    hs, h, *_ = torch.ops.repro_torch.slstm_scan(*args)
    cot = (torch.randn(hs.shape),) + tuple(torch.randn(h.shape)
                                           for _ in range(4))
    opcheck(torch.ops.repro_torch.slstm_scan_bwd.default,
            (*(x.detach() for x in args[:12]), *cot, cfg.num_heads, True))


def test_fake_implementations_allocate_only_the_outputs():
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = _cfg()
    H, D = cfg.num_heads, cfg.d_model
    with FakeTensorMode():
        g = [torch.empty(4, 4096, D) for _ in range(4)]
        r = [torch.empty(H, D // H, D // H) for _ in range(4)]
        c = [torch.empty(4, H, D // H) for _ in range(4)]
        out = torch.ops.repro_torch.slstm_scan(*g, *r, *c, H)
        grads = torch.ops.repro_torch.slstm_scan_bwd(
            *g, *r, *c, out[0], *out[1:], H, True)
    assert out[0].shape == (4, 4096, H, D // H)
    assert [tuple(t.shape) for t in out[1:]] == [(4, H, D // H)] * 4
    assert [tuple(t.shape) for t in grads] == [tuple(t.shape)
                                               for t in (*g, *r, *c)]


@pytest.mark.parametrize("seed", [0, 1])
def test_op_forward_is_bit_equal_to_the_loop(seed):
    cfg = _cfg()
    a = _inputs(np.random.default_rng(seed))
    hs, last = SS._slstm_scan_plain(*_dicts(a), cfg.num_heads)
    hs_op, last_op = SS.slstm_scan(*_dicts(a), cfg.num_heads)
    assert torch.equal(hs, hs_op)
    for k in "hcnm":
        assert torch.equal(last[k], last_op[k]), k
    # from the block's own zero state (m at -1e30) as well
    r, _, g = _dicts(a)
    c0 = XL.init_slstm_state(cfg, B)
    assert torch.equal(SS._slstm_scan_plain(r, c0, g, cfg.num_heads)[0],
                       SS.slstm_scan(r, c0, g, cfg.num_heads)[0])


@pytest.mark.parametrize("seed", [0, 1])
def test_op_backward_matches_autograd_through_the_loop(seed):
    cfg = _cfg()
    rng = np.random.default_rng(seed)
    a = _inputs(rng)
    H = cfg.num_heads
    dh = cfg.d_model // H
    dhs = torch.from_numpy(rng.normal(size=(B, S, H, dh)).astype(np.float32))
    dcarry = {k: torch.from_numpy(rng.normal(size=(B, H, dh)).astype(
        np.float32)) for k in "hcnm"}
    want = _grads(SS._slstm_scan_plain, a, dhs, dcarry, H)
    got = _grads(SS.slstm_scan, a, dhs, dcarry, H)
    top = max(float(t.abs().max()) for d in want for t in d.values())
    for gd, wd in zip(got, want):
        for k in wd:
            err = float((gd[k] - wd[k]).abs().max())
            assert err <= GRAD_BAR * top, (k, err, top)


def test_op_backward_at_a_long_sequence_matches_the_loop_in_f64():
    """At S 512 the f32 loop's step-by-step sum of the recurrent weights'
    gradient drifts from the exact one; the op (one product over all
    steps) stays within 1e-6 of the largest gradient of the loop run in
    f64."""
    cfg = _cfg()
    H = cfg.num_heads
    dh = cfg.d_model // H
    rng = np.random.default_rng(5)
    a = _inputs(rng, B=4, S=512)
    dhs = torch.from_numpy(rng.normal(size=(4, 512, H, dh)).astype(
        np.float32))
    dcarry = {k: torch.from_numpy(rng.normal(size=(4, H, dh)).astype(
        np.float32)) for k in "hcnm"}
    got = _grads(SS.slstm_scan, a, dhs, dcarry, H)
    a64 = {k: v.astype(np.float64) for k, v in a.items()}
    want = _grads(SS._slstm_scan_plain, a64, dhs.double(),
                  {k: v.double() for k, v in dcarry.items()}, H)
    top = max(float(t.abs().max()) for d in want for t in d.values())
    for gd, wd in zip(got, want):
        for k in wd:
            err = float((gd[k].double() - wd[k]).abs().max())
            assert err <= GRAD_BAR * top, (k, err, top)


def test_block_through_the_op_matches_the_loop():
    """slstm_block's output and parameter gradients: the op against the
    loop put back in its place."""
    cfg = _cfg()
    torch.manual_seed(0)
    p = {k: v.requires_grad_() for k, v in
         XL.init_slstm_block(torch.Generator().manual_seed(0), cfg).items()}
    x = torch.randn(B, S, cfg.d_model)

    def run():
        out = XL.slstm_block(p, cfg, x)
        grads = torch.autograd.grad(out.square().sum(), list(p.values()))
        return out.detach(), grads

    out, grads = run()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(XL, "slstm_scan", SS._slstm_scan_plain)
        out_p, grads_p = run()
    assert torch.equal(out, out_p)
    top = max(float(g.abs().max()) for g in grads_p)
    for g, w in zip(grads, grads_p):
        assert float((g - w).abs().max()) <= GRAD_BAR * top


# ------------------------------------------------------- the reference

@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    cfg = _cfg()
    rng = np.random.default_rng(7)
    a = _inputs(rng)
    H, D = cfg.num_heads, cfg.d_model
    a["dhs"] = rng.normal(size=(B, S, H, D // H)).astype(np.float32)
    a.update({f"d{k}": rng.normal(size=(B, H, D // H)).astype(np.float32)
              for k in "hcnm"})
    a["x"] = rng.normal(size=(B, S, D)).astype(np.float32)
    a["w"] = rng.normal(size=(B, S, D)).astype(np.float32)
    case = {"kind": "slstm_scan", "name": "sl", "arch": "xlstm-1.3b",
            "overrides": F32, "seed": 3}
    out = run_reference({"task": "models", "cases": [case]},
                        {f"sl_{k}": v for k, v in a.items()},
                        tmp_path_factory.mktemp("slstm_ref"))
    return out, a


def test_scan_and_its_vjp_match_the_reference(ref):
    out, a = ref
    cfg = _cfg()
    H = cfg.num_heads
    hs, last = SS.slstm_scan(*_dicts(a), H)
    assert_close(hs, out["sl/hs"], REF_BAR, "hs")
    for k, v in unflat(out, "sl/last").items():
        assert_close(last[k], v, REF_BAR, f"last {k}")
    dg, dr, dc = _grads(SS.slstm_scan, a, torch.from_numpy(a["dhs"]),
                        {k: torch.from_numpy(a[f"d{k}"]) for k in "hcnm"}, H)
    want = unflat(out, "sl/grad")
    top = max(float(np.abs(v).max()) for part in want.values()
              for v in part.values())
    for name, got in (("g", dg), ("r", dr), ("c", dc)):
        for k, v in want[name].items():
            assert_close(got[k], v, REF_BAR, f"grad {name}{k}", scale=top)


def test_block_forward_and_grad_match_the_reference(ref):
    out, a = ref
    cfg = _cfg()
    p = {k: torch.from_numpy(np.array(v)).requires_grad_()
         for k, v in unflat(out, "sl/param").items()}
    x = torch.from_numpy(a["x"]).requires_grad_()
    y = XL.slstm_block(p, cfg, x)
    assert_close(y, out["sl/block"], BLOCK_BAR, "block")
    (y * torch.from_numpy(a["w"])).sum().backward()
    want = unflat(out, "sl/block_grad")
    assert_grads({k: v.grad for k, v in p.items()}, want, BLOCK_BAR,
                 zero=("b_i",))
    assert_close(x.grad, out["sl/block_grad_x"], BLOCK_BAR, "grad x")


# ------------------------------------------------------- CostMode

def _cost(fn, backward: bool):
    from repro_torch.launch.dryrun import CostMode, collective_bytes

    cfg = _cfg()
    p = {k: v.requires_grad_() for k, v in
         XL.init_slstm_block(torch.Generator().manual_seed(0), cfg).items()}
    x = torch.randn(B, 32, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(XL, "slstm_scan", fn)
        with CostMode() as cost:
            y = XL.slstm_block(p, cfg, x)
            if backward:
                y.square().sum().backward()
    return cost.flops, cost.bytes, collective_bytes(cost.collectives)


@pytest.mark.parametrize("backward", [False, True])
def test_costmode_counts_the_op_as_the_loop(backward):
    cfg = _cfg()
    H = cfg.num_heads
    op = _cost(SS.slstm_scan, backward)
    plain = _cost(SS._slstm_scan_plain, backward)
    recompute = SS.scan_flops(B, 32, H, cfg.d_model // H) if backward else 0
    assert op[0] - recompute == plain[0] > 0
    assert op[2] == plain[2]
    print(f"backward={backward}: FLOPs {op[0]} vs {plain[0]}, bytes "
          f"{op[1]} vs {plain[1]} (no-fusion upper bounds)")


# ------------------------------------------------------- the dry-run

@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    d = tmp_path_factory.mktemp("slstm_dryrun")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src"), str(REPO / "tests")]))
    proc = subprocess.run([sys.executable, __file__, str(d)], env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads((d / "out.json").read_text())


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_dryrun_counts_the_op_as_the_loop(traced, kind):
    got = traced["compare"][kind]
    assert got["op"]["flops"] - got["recompute"] == got["plain"]["flops"] > 0
    assert got["op"]["coll"] == got["plain"]["coll"]
    assert got["op"]["coll"]["total"] > 0
    assert got["op"]["args_bytes"] == got["plain"]["args_bytes"]


def test_dryrun_cut_cell_traces_through_the_op(traced):
    cell = traced["cut_cell"]
    # one sLSTM layer: its forward and its remat recompute each call the op
    assert cell["op_calls"] == 2
    assert cell["flops"] > 0 and cell["coll"]["total"] > 0
    assert cell["fits_hbm"] is True
    assert cell["trace_s"] < 120, cell["trace_s"]


def main(workdir: str) -> int:
    import dataclasses
    import time

    from repro_torch.configs.base import SHAPES, ShapeConfig, get_config
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import fake_world, make_production_mesh

    cfg = DR._depth_variant(get_config("xlstm-1.3b"), 1)
    H, dh = cfg.num_heads, cfg.d_model // cfg.num_heads
    out = {"compare": {}}
    calls = [0]

    def counted(*a):
        calls[0] += 1
        return SS.slstm_scan(*a)

    with fake_world(256):
        mesh = make_production_mesh(device_type="cpu")
        data = dict(zip(mesh.mesh_dim_names, mesh.shape))["data"]
        short = dataclasses.replace(cfg, mlstm_chunk=32)
        for kind, cell in (("prefill", "prefill_32k"), ("train", "train_4k")):
            # the cell's own batch, at S 32
            batch = SHAPES[cell].global_batch
            shape = ShapeConfig(f"{kind}_cut", 32, batch, kind)
            rec = {}
            for name, fn in (("op", SS.slstm_scan),
                             ("plain", SS._slstm_scan_plain)):
                XL.slstm_scan = fn
                low = DR.lower_cell(short, shape, mesh)
                rec[name] = {k: low[k] for k in ("flops", "coll",
                                                 "args_bytes")}
            XL.slstm_scan = SS.slstm_scan
            # the train step's backward recomputes the forward once a layer
            rec["recompute"] = (SS.scan_flops(batch // data, 32, H, dh)
                                if kind == "train" else 0)
            out["compare"][kind] = rec
        XL.slstm_scan = counted
        t0 = time.perf_counter()
        shape = ShapeConfig("train_cut", 256, SHAPES["train_4k"].global_batch,
                            "train")
        low = DR.lower_cell(cfg, shape, mesh)
        rec = DR.analyze(low, cfg, shape, mesh)
        out["cut_cell"] = {"op_calls": calls[0], "flops": low["flops"],
                           "coll": low["coll"],
                           "fits_hbm": rec["memory"]["fits_hbm"],
                           "trace_s": time.perf_counter() - t0}
        XL.slstm_scan = SS.slstm_scan
    Path(workdir, "out.json").write_text(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
