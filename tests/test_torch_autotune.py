"""The port's autotuner (`repro_torch.core.autotune`) held against the
reference's: the tune space samples, validates and featurizes exactly as
the reference does from the same NumPy seed, and with the dry-run replaced
in both packages by one fixed objective of the features
(`torch_port_reference.autotune_objective`, infeasible at the widest model
axis so the classifier has work) the constrained BO evaluates the
reference's points in the reference's order and returns its best one.
`elastic_remesh` re-plans a (16, 16) fake mesh down to
`make_mesh_for(192)`, in a process of its own (this file run as a
script), so no process group is left in the pytest process.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
from torch_port_reference import autotune_objective, run_reference

from repro_torch.configs.base import SHAPES, get_config
from repro_torch.core import autotune as AT

REPO = Path(__file__).resolve().parents[1]
ARCH, SHAPE = "smollm-360m", "train_4k"
SAMPLE_SEEDS = list(range(6))
N_SAMPLES = 40
BO_SEEDS = [0, 1, 2]
BO_KW = {"n_trials": 12, "n_warmup": 4, "pool_size": 32}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    spec = {"task": "autotune", "arch": ARCH, "shape": SHAPE,
            "sample_seeds": SAMPLE_SEEDS, "n_samples": N_SAMPLES,
            "bo_seeds": BO_SEEDS, "bo_kw": BO_KW}
    out = run_reference(spec, {}, tmp_path_factory.mktemp("autotune"))
    return json.loads(str(out["json"]))


@pytest.mark.parametrize("seed", SAMPLE_SEEDS)
def test_space_equals_reference(ref, seed):
    import numpy as np

    space = AT.TuneSpace(get_config(ARCH), SHAPES[SHAPE])
    rng = np.random.default_rng(seed)
    want = ref["samples"][seed * N_SAMPLES:(seed + 1) * N_SAMPLES]
    for t_want, valid, feats in want:
        t = space.sample(rng)
        assert list(dataclasses.astuple(t)) == t_want
        assert space.is_valid(t) == valid
        assert space.features(t).tolist() == feats


@pytest.mark.parametrize("i", range(len(BO_SEEDS)))
def test_autotune_takes_the_reference_decisions(ref, i, monkeypatch):
    monkeypatch.setattr(AT.TuneSpace, "evaluate",
                        lambda self, t: autotune_objective(self.features(t)))
    best, result = AT.autotune(get_config(ARCH), SHAPES[SHAPE],
                               seed=BO_SEEDS[i], device="cpu", **BO_KW)
    want = ref["runs"][i]
    assert [list(dataclasses.astuple(p)) for p in result.points] \
        == want["points"]
    assert list(dataclasses.astuple(best)) == want["best"]
    assert result.n_infeasible > 0 or all(
        autotune_objective(AT.TuneSpace(get_config(ARCH), SHAPES[SHAPE])
                           .features(p))[1] for p in result.points)


_NO_CUDA = r"""
import torch
from repro_torch.configs.base import SHAPES, get_config
from repro_torch.core import autotune as AT
from repro_torch.launch import dryrun as DR
assert not torch.cuda.is_available()
for name, call in {
        "autotune": lambda: AT.autotune(get_config("smollm-360m"),
                                        SHAPES["train_4k"], n_trials=1),
        "dryrun": lambda: DR.run_cell("smollm-360m", "decode_32k",
                                      save=False)}.items():
    try:
        call()
    except RuntimeError as e:
        assert "'cuda'" in str(e), (name, e)
        print("RAISED", name)
"""


def test_default_device_is_the_card():
    """The autotuner's GP and the dry-run's fake tensors default to the
    card: without CUDA both raise, naming the device."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", _NO_CUDA], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "RAISED autotune" in proc.stdout and "RAISED dryrun" in proc.stdout


def test_flash_blocks_select_nothing_on_the_card():
    """K3's tile is 64 x 64 whatever the config's flash blocks: two tune
    points that differ only in flash_bq / flash_bk run the same step."""
    import torch

    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models.model import build_model

    losses = []
    for blocks in (256, 2048):
        cfg = dataclasses.replace(get_smoke_config(ARCH),
                                  compute_dtype="float32",
                                  flash_block_q=blocks, flash_block_k=blocks)
        model = build_model(cfg, "cpu", train=True).init(
            torch.Generator().manual_seed(0))
        tokens = torch.arange(2 * 96).reshape(2, 96) % cfg.vocab_size
        losses.append(model.loss({"tokens": tokens, "labels": tokens}))
    assert torch.equal(losses[0], losses[1])


def test_elastic_remesh_down_to_192(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src"), str(REPO / "tests")]))
    proc = subprocess.run([sys.executable, __file__, str(tmp_path)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads((tmp_path / "out.json").read_text())
    assert got["mesh"] == [12, 16] and got["names"] == ["data", "model"]
    assert got["placements"] == ["R,R"]
    assert got["shapes_kept"] is True
    assert got["lowered_mesh"] == "12x16"


# ------------------------------------------------------- the fake world

def main(workdir: str) -> int:
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import (fake_world, make_mesh_for,
                                         make_production_mesh)
    from repro_torch.runtime.fault_tolerance import elastic_remesh

    cfg = dataclasses.replace(get_config(ARCH), num_layers=1)
    shape = SHAPES["decode_32k"]
    with fake_world(256):
        old = make_production_mesh(device_type="cpu")
        with FakeTensorMode():
            state = {"w": distribute_tensor(torch.empty(960, 2560), old,
                                            [Shard(0), Shard(1)]),
                     "step": torch.zeros((), dtype=torch.int32)}
        mesh, lowered, new = elastic_remesh(
            lambda n: make_mesh_for(n, device_type="cpu"),
            lambda m: DR.analyze(DR.lower_cell(cfg, shape, m), cfg, shape,
                                 m), state, 192)
        out = {"mesh": list(mesh.shape), "names": list(mesh.mesh_dim_names),
               "placements": sorted({",".join(map(str, t.placements))
                                     for t in new.values()}),
               "shapes_kept": all(new[k].shape == state[k].shape
                                  for k in state),
               "lowered_mesh": lowered["mesh"]}
        assert all(p == Replicate() for t in new.values()
                   for p in t.placements)
    Path(workdir, "out.json").write_text(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
