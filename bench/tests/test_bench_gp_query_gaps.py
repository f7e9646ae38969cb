"""`bench/gp_query_gaps.py`: every query judged by the check on its own, on
hand-made scoring records (the program's own posterior, one moved past the
limit, one whose fit never started).

    PYTHONPATH=src python -m pytest -q bench/tests
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT / "src")]

import gp_query_gaps as gq  # noqa: E402
from reference import check  # noqa: E402
from reference import gp as ref_gp  # noqa: E402


def _records(rng, queries=3, runs=2):
    out = []
    for _ in range(queries):
        Xs = [rng.normal(size=(12, 3)) for _ in range(runs)]
        ys = [x @ [1.0, -0.5, 0.2] + 0.1 * rng.normal(size=12) for x in Xs]
        pool = rng.normal(size=(runs, 6, 3))
        mus, vs, ps = [], [], []
        for X, y, P in zip(Xs, ys, pool):
            p = ref_gp.fit("linear", True, X, y)
            mu, var = ref_gp.posterior("linear", p, X, y, P)
            mus.append(mu)
            vs.append(var)
            ps.append(p)
        out.append({"kind": "GPStack.score", "kernel": "linear",
                    "noisy": True, "X": Xs, "y": ys, "pool": pool,
                    "mu": np.array(mus), "var": np.array(vs),
                    "params": {k: np.array([p[k] for p in ps])
                               for k in ps[0]}})
    return out


def test_judge_reads_each_query_as_the_check_does():
    recs = _records(np.random.default_rng(3))
    same = gq.judge(recs)
    assert same["queries"] == 3
    for name in gq.NUMBERS:
        assert same[name]["limit"] == check.LIMITS[name]
        assert same[name]["past"] == 0 and same[name]["max"] <= 1e-9
    assert [r[0] for r in same["readings"]] == ["GPStack.score"] * 3

    recs[1]["mu"] = recs[1]["mu"].copy()
    recs[1]["mu"][0, 2] += 0.5 * np.std(recs[1]["y"][0])
    out = gq.judge(recs)
    post = out["gp_posterior_gap"]
    assert (post["past"], post["past_share"]) == (1, pytest.approx(1 / 3))
    assert post["max"] == pytest.approx(0.5, rel=1e-6)
    assert out["readings"][1][1] == post["max"]


def test_judge_reads_a_fit_that_never_started_at_its_parameters():
    recs = _records(np.random.default_rng(4))
    rec = recs[2]
    start = [ref_gp.init("linear", True, X, y)
             for X, y in zip(rec["X"], rec["y"])]
    rec["params"] = {k: np.array([p[k] for p in start]) for k in start[0]}
    for r, (X, y) in enumerate(zip(rec["X"], rec["y"])):
        rec["mu"][r], rec["var"][r] = ref_gp.posterior(
            "linear", start[r], X, y, rec["pool"][r])
    out = gq.judge(recs)
    assert out["gp_posterior_gap"]["max"] <= 1e-9
    assert out["gp_fit_shortfall"]["past"] == 1
    assert out["gp_fit_shortfall"]["max"] == pytest.approx(1.0)
    assert out["readings"][2][3] == pytest.approx(1.0)
    assert out["readings"][0][3] <= 1e-12
    assert gq.judge([])["gp_fit_shortfall"]["past"] == 0
