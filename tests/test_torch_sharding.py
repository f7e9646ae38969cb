"""The port's sharding specs (`repro_torch.parallel.sharding`,
`repro_torch.launch.steps`, `repro_torch.launch.mesh`) held against the
reference's, exactly.

The reference runs once, in its own process with 512 host devices
(`tests/torch_port_reference.py`, task "sharding"): every parameter leaf's
spec of all ten archs on the (16, 16), (2, 16, 16) and (2, 2) meshes under
four rule sets, the batch and decode-cache specs of every applicable cell,
`_filter_spec` and `batch_axes_for` cases, and `make_mesh_for`'s shapes for
1..512 devices.  The port computes its specs from {axis: size} dicts, with
no process group.  A port parameter that is one layer of a reference layer
stack must get the reference leaf's spec with the stack dim dropped (that
dim is never sharded); a cache leaf likewise.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
from torch_port_reference import run_reference

from repro_torch.configs.base import ARCH_IDS, SHAPES, cell_is_applicable, get_config
from repro_torch.convert import is_stacked, reference_path
from repro_torch.launch import steps
from repro_torch.launch.mesh import mesh_shape_for, production_axes
from repro_torch.parallel import sharding

MESHES = [(16, 16), (2, 16, 16), (2, 2)]
RULES = [{}, {"fsdp": None}, {"seq": "model"}, {"kv_len": "data"}]
CELL_MESHES = [(16, 16), (2, 16, 16)]
CELL_RULES = [0, 3]
FILTER_CASES = [
    (("pod", "data"), None, "model"),
    ("model", "model", None),
    (("pod", "data"), "model", "model"),
    (None, ("data", "model"), "model"),
    ("pod", None),
    ((), "data"),
    (("pod",), ("data",)),
    ("model", ("pod", "data", "model")),
]
BATCH_SIZES = [1, 2, 4, 16, 32, 96, 128, 256, 512]


def axes_of(mshape) -> dict:
    names = ("pod", "data", "model")[-len(mshape):]
    return dict(zip(names, mshape))


def _cells():
    out = []
    for arch in ARCH_IDS:
        for shape in SHAPES:
            if cell_is_applicable(get_config(arch), SHAPES[shape])[0]:
                out += [(arch, shape, m, r) for m in CELL_MESHES
                        for r in CELL_RULES]
    return out


CELLS = _cells()


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    spec = {"task": "sharding", "archs": list(ARCH_IDS),
            "meshes": [list(m) for m in MESHES], "rules": RULES,
            "cells": [[a, s, list(m), r] for a, s, m, r in CELLS],
            "filter": [[list(m), 0, list(c)] for m in MESHES
                       for c in FILTER_CASES],
            "batch_axes": [[list(m), r, n] for m in MESHES
                           for r in (0, 2) for n in BATCH_SIZES],
            "mesh_for": list(range(1, 513))}
    out = run_reference(spec, {}, tmp_path_factory.mktemp("sharding"),
                        timeout=900, host_devices=512)
    return json.loads(str(out["json"]))


def _norm(entries) -> list:
    """Spec entries as a `PartitionSpec` compares them: a one-name tuple
    equals the name (the reference's `NamedSharding.spec` keeps the name)."""
    return [a[0] if isinstance(a, (tuple, list)) and len(a) == 1
            else list(a) if isinstance(a, tuple) else a for a in entries]


def _json(spec) -> list:
    return _norm(spec)


def _port_param_shapes(cfg) -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.model import build_model

    with FakeTensorMode():
        model = build_model(cfg, "cpu")
        return {k: tuple(p.shape) for k, p in model.named_parameters()}


@pytest.mark.parametrize("ri", range(len(RULES)))
@pytest.mark.parametrize("mshape", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_reference(ref, arch, mshape, ri):
    cfg = get_config(arch)
    want = ref["params"][f"{arch}|{tuple(mshape)}|{ri}"]
    shapes = _port_param_shapes(cfg)
    got = sharding.tree_param_specs(shapes, axes_of(mshape),
                                    sharding.AxisRules(**RULES[ri]),
                                    len(cfg.block_pattern))
    seen = set()
    for name, spec in got.items():
        path = reference_path(name, len(cfg.block_pattern))
        seen.add(path)
        w = _norm(want[path])
        if is_stacked(name):
            assert w[0] is None, (name, w)
            w = w[1:]
        assert _json(spec) == w, (name, spec, w)
    assert seen == set(want), sorted(set(want) ^ seen)[:5]


@pytest.mark.parametrize("arch,shape,mshape,ri", CELLS)
def test_batch_and_cache_specs_equal_reference(ref, arch, shape, mshape, ri):
    cfg, sh = get_config(arch), SHAPES[shape]
    mesh, rules = axes_of(mshape), sharding.AxisRules(**RULES[ri])
    key = f"{arch}|{shape}|{tuple(mshape)}|{ri}"
    got = steps.batch_sharding(cfg, sh, mesh, rules)
    assert ({k: _json(v) for k, v in got.items()}
            == {k: _norm(v) for k, v in ref["batch"][key].items()})
    want = ref["cache"][key]
    cache = steps.cache_sharding(cfg, sh, mesh, rules)
    period = len(cfg.block_pattern)
    if cfg.family == "encdec":
        layers, enc = cache
        assert _json(enc) == _norm(want["1"])
        flat = {f"0/self/{leaf}/{i}": s for i, c in enumerate(layers)
                for leaf, s in c["self"].items()}
        for k, s in flat.items():
            _, _, leaf, i = k.split("/")
            w = _norm(want[f"0/self/{leaf}"])
            assert w[0] is None and _json(s) == w[1:], (k, s, w)
        return
    for i, c in enumerate(cache):
        for leaf, s in c.items():
            w = _norm(want[f"pos{i % period}/{leaf}"])
            assert w[0] is None and _json(s) == w[1:], (i, leaf, s, w)
    assert {k.split("/")[0] for k in want} == {f"pos{i}"
                                               for i in range(period)}


@pytest.mark.parametrize("mshape", MESHES)
def test_filter_spec_equals_reference(ref, mshape):
    i0 = MESHES.index(mshape) * len(FILTER_CASES)
    for j, axes in enumerate(FILTER_CASES):
        got = sharding._filter_spec(axes_of(mshape), axes)
        assert _json(got) == _norm(ref["filter"][i0 + j]), (axes, got)


@pytest.mark.parametrize("ri", (0, 2))
@pytest.mark.parametrize("mshape", MESHES)
def test_batch_axes_for_equals_reference(ref, mshape, ri):
    k = MESHES.index(mshape) * 2 * len(BATCH_SIZES) + (ri == 2) * len(BATCH_SIZES)
    for j, n in enumerate(BATCH_SIZES):
        with sharding.use_mesh(axes_of(mshape), sharding.AxisRules(**RULES[ri])):
            got = sharding.batch_axes_for(n)
        want = ref["batch_axes"][k + j]
        assert _norm([got]) == _norm([want]), n


@pytest.mark.parametrize("lo", range(1, 513, 64))
def test_mesh_for_shapes_equal_reference(ref, lo):
    for n in range(lo, lo + 64):
        assert list(mesh_shape_for(n)) == ref["mesh_for"][str(n)], n


def test_production_axes_are_the_reference_cells():
    assert production_axes() == {"data": 16, "model": 16}
    assert production_axes(True) == {"pod": 2, "data": 16, "model": 16}


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard

    mesh = {"pod": 2, "data": 16, "model": 16}
    assert sharding.placements((("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert sharding.placements((None, None), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh order"):
        sharding.placements(((("data", "pod")),), mesh)


def test_act_is_the_identity_without_a_mesh():
    import torch

    x = torch.ones(2, 3)
    assert sharding.current_mesh() is None
    assert sharding.act(x, "batch", "dmodel") is x
    assert not sharding.is_sharded(x)
    assert np.array_equal(sharding.constant(x, x, "batch", None), x)


def test_checkpoint_recompute_sees_the_forward_mesh():
    """Autograd runs a CUDA backward on a thread of its own, and the block
    recompute with it; the sharding state is per thread, so the recompute
    must be handed the forward's mesh (`sharding.checkpoint_context`)."""
    import threading

    import torch
    from torch.utils.checkpoint import checkpoint

    seen = []

    def block(x):
        seen.append(sharding.current_mesh())
        return torch.sin(x)

    mesh = {"data": 2, "model": 2}
    x = torch.ones(3, requires_grad=True)
    with sharding.use_mesh(mesh):
        y = checkpoint(block, x, use_reentrant=False,
                       context_fn=sharding.checkpoint_context).sum()
    grads = []
    t = threading.Thread(target=lambda: grads.append(
        torch.autograd.grad(y, x)[0]))
    t.start()
    t.join()
    assert seen == [mesh, mesh]
    assert torch.equal(grads[0], torch.cos(torch.ones(3)))
