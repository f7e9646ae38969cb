"""The port's dry-run (`repro_torch.launch.dryrun`), mirroring
tests/test_dryrun.py: its analytic part equals the reference's, its
collective counter counts known redistributions exactly, a full dry-run of
smollm-360m's train_4k and decode_32k cells on the fake 16 x 16 mesh runs
on the CPU with the reference's record keys, and the trace counts every
layer (where XLA's cost analysis counts a scan body once).

Every fake-world part runs in a process of its own: this file run as a
script (`python tests/test_torch_dryrun.py <dir>`), so no process group is
left in the pytest process.  The reference's analytic part runs once in its
own process (`tests/torch_port_reference.py`, task "dryrun").

The traced FLOPs of a full dry-run are held to `cell_flops`' expected_hw
(the analytic count of what the hardware runs, block remat included):
their ratio must lie in [0.8, 1.25].  The trace counts every matmul and K3
call a rank runs (K3's causal pairs exactly, the analytic model S/2 a
query) and nothing elementwise, so it may fall a little either side; the
bar catches a layer traced twice or not at all, or a product run on
global instead of local shapes.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
from torch_port_reference import run_reference

from repro_torch.configs.base import ARCH_IDS, SHAPES, get_config

REPO = Path(__file__).resolve().parents[1]
CELLS = ("train_4k", "decode_32k")
RATIO_BAR = (0.8, 1.25)

# The keys of the reference's `analyze` record; the port renames
# memory.fits_16g to memory.fits_hbm and adds memory.hbm_gib.
REFERENCE_KEYS = {"arch", "shape", "kind", "mesh", "devices", "compile_s",
                  "memory", "hlo_flops_per_dev", "hlo_bytes_per_dev_upper",
                  "analytic_bytes_per_dev", "collective_bytes_per_dev",
                  "hlo_raw_per_dev", "analytic_flops", "roofline",
                  "useful_flops_ratio", "mfu_estimate"}
REFERENCE_MEMORY_KEYS = {"args_bytes_per_dev", "temp_bytes_per_dev",
                         "output_bytes_per_dev", "total_gib_per_dev"}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = run_reference({"task": "dryrun", "archs": list(ARCH_IDS)}, {},
                        tmp_path_factory.mktemp("dryrun_ref"))
    return json.loads(str(out["json"]))


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src"), str(REPO / "tests")]))
    proc = subprocess.run([sys.executable, __file__, str(d)], env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads((d / "out.json").read_text())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analytic_part_equals_reference(ref, arch):
    from repro_torch.launch import dryrun as DR

    cfg = get_config(arch)
    want = ref[arch]
    assert list(DR.count_params(cfg)) == want["count_params"]
    for s, v in want["model_flops"].items():
        assert DR.model_flops(cfg, SHAPES[s]) == v, s
    got = [[v.num_layers, v.encoder_layers, list(v.block_pattern)]
           for v in (DR._depth_variant(cfg, n) for n in (1, 2, 3))]
    assert got == want["depth"]


def test_collective_bytes_of_known_redistributions(traced):
    # (256, 1024) bf16 on the 16 x 16 mesh: 512 KiB whole
    whole = 256 * 1024 * 2
    got = traced["collectives"]
    assert got["gather_data"] == {"all-gather": whole, "total": whole,
                                  "ops": 1}
    assert got["reduce_model"] == {"all-reduce": whole // 16,
                                   "total": whole // 16, "ops": 1}
    assert got["scatter_model"] == {"reduce-scatter": whole // 256,
                                    "total": whole // 256, "ops": 1}
    assert got["none"] == {"total": 0, "ops": 0}


def test_collective_bytes_sums_by_kind():
    from repro_torch.launch.dryrun import collective_bytes

    got = collective_bytes([("all-gather", 8), ("all-reduce", 4),
                            ("all-gather", 2), ("all-to-all", 1)])
    assert got == {"all-gather": 10, "all-reduce": 4, "all-to-all": 1,
                   "total": 15, "ops": 4}


@pytest.mark.parametrize("shape", CELLS)
def test_full_dryrun_of_smollm(traced, shape):
    rec = traced["cells"][shape]
    assert REFERENCE_KEYS <= set(rec), REFERENCE_KEYS - set(rec)
    assert REFERENCE_MEMORY_KEYS <= set(rec["memory"])
    assert "fits_16g" not in rec["memory"]
    assert rec["memory"]["hbm_gib"] == 80.0
    assert rec["memory"]["fits_hbm"] is True
    assert rec["mesh"] == "16x16" and rec["devices"] == 256
    assert rec["extrapolated"] is False
    ratio = (rec["hlo_flops_per_dev"] * rec["devices"]
             / rec["analytic_flops"]["expected_hw"])
    print(f"{shape}: traced / expected_hw FLOPs = {ratio:.4f}")
    assert RATIO_BAR[0] <= ratio <= RATIO_BAR[1], ratio
    assert rec["collective_bytes_per_dev"] > 0
    r = rec["roofline"]
    assert r["step_time_s"] == max(r["compute_s"], r["memory_s"],
                                   r["collective_s"])


def test_trace_counts_every_layer(traced):
    """Replaces the reference's test that XLA counts a scan body once: the
    eager trace's counts are affine in depth, one period's worth a period,
    so extrapolating from depths 1 and 2 gives the full trace exactly."""
    f = traced["depth_flops"]
    assert f[2] - f[1] == f[1] - f[0] > 0
    assert traced["extrapolated_flops"] == f[2]


# ------------------------------------------------------- the fake world

def main(workdir: str) -> int:
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Partial, Replicate, Shard, DTensor

    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import fake_world, make_production_mesh

    out = {"collectives": {}, "cells": {}}
    with fake_world(256):
        mesh = make_production_mesh(device_type="cpu")

        def count(src, dst):
            """Collectives of one redistribution of a (256, 1024) bf16
            DTensor whose local chunk is (16, 1024)."""
            with FakeTensorMode():
                local = torch.empty(16, 1024, dtype=torch.bfloat16)
                t = DTensor.from_local(local, mesh, src, run_check=False)
                with DR.CostMode() as c:
                    t.redistribute(mesh, dst)
            return DR.collective_bytes(c.collectives)

        out["collectives"] = {
            "gather_data": count((Shard(0), Replicate()),
                                 (Replicate(), Replicate())),
            "reduce_model": count((Shard(0), Partial()),
                                  (Shard(0), Replicate())),
            "scatter_model": count((Shard(0), Partial()),
                                   (Shard(0), Shard(0))),
            "none": count((Shard(0), Replicate()), (Shard(0), Replicate())),
        }
        for shape in CELLS:
            out["cells"][shape] = DR.run_cell("smollm-360m", shape,
                                              save=False, device="cpu")
        cfg, shape = get_config("smollm-360m"), SHAPES["decode_32k"]
        out["depth_flops"] = [DR.lower_cell(DR._depth_variant(cfg, n), shape,
                                            mesh)["flops"] for n in (1, 2, 3)]
        three = DR._depth_variant(cfg, 3)
        out["extrapolated_flops"] = DR.extrapolated_costs(three, shape,
                                                          mesh)["flops"]
    Path(workdir, "out.json").write_text(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
