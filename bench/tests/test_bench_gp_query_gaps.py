"""`bench/gp_query_gaps.py`: the check's posterior gap of one run, the
summary over queries and runs, and the three comparisons on hand-made
scoring records (an eager refit that is the program's own posterior, one
moved past the limit, and a reference refit of the records' own data).

    PYTHONPATH=src python -m pytest -q bench/tests
"""

from __future__ import annotations

import math
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


def test_gap_is_the_checks_widest_mean_or_deviation_gap():
    mu, var = np.array([1.0, 2.0]), np.array([4.0, 1.0])
    assert gq.gap(mu + [0.0, 0.3], var, mu, var, 2.0) == pytest.approx(0.15)
    assert gq.gap(mu, [9.0, 1.0], mu, var, 0.5) == pytest.approx(2.0)
    assert gq.gap([np.nan, 2.0], var, mu, var, 1.0) == math.inf


def test_summarise_counts_runs_and_queries_past_the_limit():
    rows = [(0, 10, 0.01), (0, 20, 0.5), (1, 12, 0.02), (2, 40, 0.2),
            (2, 41, 0.05)]
    s = gq.summarise(rows, 0.1)
    assert (s["runs"], s["runs_past"], s["queries"], s["queries_past"]) == (
        5, 2, 3, 2)
    assert s["runs_past_share"] == pytest.approx(0.4)
    assert s["queries_past_share"] == pytest.approx(2 / 3)
    assert s["max"] == 0.5 and s["median"] == 0.05
    assert s["by_rows"] == {"8": [2, 0], "16": [1, 1], "40": [2, 1]}
    assert gq.summarise([], 0.1) == {"runs": 0, "queries": 0}


def _records(rng, queries=3, runs=2):
    out = []
    for _ in range(queries):
        Xs = [rng.normal(size=(12, 3)) for _ in range(runs)]
        ys = [x @ [1.0, -0.5, 0.2] + 0.1 * rng.normal(size=12) for x in Xs]
        pool = rng.normal(size=(runs, 6, 3))
        mus, vs = [], []
        for X, y, P in zip(Xs, ys, pool):
            p = ref_gp.fit("linear", True, X, y)
            mu, var = ref_gp.posterior("linear", p, X, y, P)
            mus.append(mu)
            vs.append(var)
        out.append({"kind": "GPStack.score", "kernel": "linear",
                    "noisy": True, "X": Xs, "y": ys, "pool": pool,
                    "mu": np.array(mus), "var": np.array(vs)})
    return out


def test_compare_holds_each_posterior_to_the_references_refit():
    recs = _records(np.random.default_rng(3))
    same = gq.compare(recs, lambda rec: (rec["mu"], rec["var"]))
    assert same["limit"] == check.LIMITS["gp_posterior_gap"]
    for key in ("program", "eager", "program_vs_eager"):
        assert same[key]["runs"] == 6 and same[key]["queries"] == 3
        assert same[key]["runs_past"] == 0
        assert same[key]["max"] <= 1e-12

    def moved(rec):
        mu = rec["mu"].copy()
        if rec is recs[1]:
            mu[0] += 0.5 * np.std(rec["y"][0])
        return mu, rec["var"]

    out = gq.compare(recs, moved)
    assert out["program"]["runs_past"] == 0
    for key in ("eager", "program_vs_eager"):
        assert (out[key]["runs_past"], out[key]["queries_past"]) == (1, 1)
        assert out[key]["max"] == pytest.approx(0.5)
