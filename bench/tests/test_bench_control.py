"""The check that decides `correct` has to fail: the float32 controls of the
cost model and of the GP surrogates, and the planted faults (GP fits
stopped at half of their steps, the GP's posterior mean moved on the tail
of each pool, an answer altered where it is produced, half of a stack's
searches left out, a step that leaves the search's state unchanged) drive
the rest of a run, with the chip's look skipped, at a size the CPU holds,
and the verdict comes out false; the program's own run comes out true.
The readings at the cells' own size are taken on the card
by `bench/control.py` (PERF.md).

    PYTHONPATH=src python -m pytest -q bench/tests
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT / "src")]

import control  # noqa: E402
import harness  # noqa: E402
from reference import check  # noqa: E402


def _run(workload: str, mode: str, seed: int) -> dict:
    import torch

    torch.set_num_threads(2)
    cell, config, traffic = harness.load_cell(workload)
    t = json.loads(json.dumps(traffic))
    # More inner trials than the GP's linear kernel has features: the
    # ill-conditioned fits the cells' searches make, where float32 fails.
    t["search"]["sw"].update(n_trials=24, n_warmup=18, pool_size=16)
    t["search"]["hw"].update(n_trials=5, n_warmup=2, pool_size=8)
    return harness.run_cell(workload, config, t, seed, 1.0, False,
                            device="cpu", patch=control.MODES[mode])["line"]


@pytest.mark.parametrize("workload", ["resnet.table", "dqn.speculative"])
@pytest.mark.parametrize("mode, number", [
    ("program", None), ("float32", "utility_gap"),
    ("gp32", "gp_posterior_gap"), ("gp_halfsteps", "gp_fit_shortfall"),
    ("gp_tail", "gp_posterior_gap"),
    ("altered", "utility_gap"), ("half", "mismatches"),
    ("unchanged", None)])
def test_control_and_faults_fail_the_check(workload, mode, number):
    line = _run(workload, mode, 2**31 + 11)
    numbers = line["check"]
    if mode == "unchanged":
        # No probe is answered: nothing to compare is no correct run.
        assert line["correct"] is False and line["attempted"] == 0
        return
    if number is None:
        assert line["correct"] is True and line["failed"] == 0
        assert numbers["mismatches"]["value"] == 0
        assert numbers["utility_gap"]["value"] <= 1e-12
        for name in ("gp_posterior_gap", "gp_choice_regret",
                     "gp_fit_shortfall"):
            assert numbers[name]["value"] <= check.LIMITS[name]
        return
    assert line["correct"] is False
    assert numbers[number]["value"] > check.LIMITS[number]


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    """One short run of each cell through the manifest's command;
    `correct` true and every end-to-end metric there."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    manifest = harness.load_manifest()
    for cell in manifest["workloads"]:
        out = subprocess.run(
            [*manifest["command"], "--workload", cell["name"], "--seed",
             str(2**31 + 3), "--seconds", "1", "--trace", "0"],
            cwd=ROOT, capture_output=True, text=True, timeout=900)
        assert out.returncode == 0, out.stderr[-4000:]
        line = json.loads(out.stdout.strip().splitlines()[-1])
        assert line["correct"] is True
        assert set(line["metrics"]) == {
            n for n, _ in harness.metric_names(cell["name"], False)}
