"""The yardstick against the program it judges: the frozen reference
evaluator and lower bound against `repro_torch.timeloop`, the reference GP
against `repro_torch.core.gp`, K1b's byte and operation count against the
kernel lines of `chip_smoke.py`, and the interval arithmetic of the
per-layer metrics.  The tests may import the
port; the reference may not.

    PYTHONPATH=src python -m pytest -q bench/tests
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT / "src")]

import intervals  # noqa: E402
import work  # noqa: E402
from reference import check, gp, model  # noqa: E402


def _triples(name: str, n_hw: int, n_maps: int, seed: int):
    from repro_torch.timeloop.arch import sample_hardware_pool
    from repro_torch.timeloop.mapping import (constrained_random_mapping,
                                              random_mapping)
    from repro_torch.timeloop.workloads import MODEL_LAYERS

    rng = np.random.default_rng(seed)
    for hw in sample_hardware_pool(rng, n_hw, num_pes=168):
        for layer in MODEL_LAYERS[name]:
            for i in range(n_maps):
                draw = constrained_random_mapping if i % 2 else random_mapping
                yield hw, draw(rng, hw, layer), layer


def _budget(name: str) -> dict:
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())[
        "budget"]


def _layer(layer) -> dict:
    return {d: layer.dim(d) for d in model.DIMS} | {"stride": layer.stride}


@pytest.mark.parametrize("name", ["resnet", "dqn"])
def test_reference_evaluator_agrees_with_the_port(name):
    from repro_torch.timeloop.model import evaluate

    budget = _budget(name)
    n_valid = n = 0
    for hw, m, layer in _triples(name, 24, 40, seed=3):
        want = evaluate(hw, m, layer)
        got = model.evaluate(dataclasses.asdict(hw), budget,
                             (m.factors, m.order_gb, m.order_dram),
                             _layer(layer))
        assert math.isfinite(got) == want.valid
        if want.valid:
            assert got == want.edp
            n_valid += 1
        n += 1
    assert n_valid >= 20 and n - n_valid >= 20


@pytest.mark.parametrize("name", ["resnet", "dqn"])
def test_reference_lower_bound_agrees_with_the_port(name):
    from repro_torch.timeloop.arch import sample_hardware_pool
    from repro_torch.timeloop.bounds import lower_bound
    from repro_torch.timeloop.workloads import MODEL_LAYERS

    budget = _budget(name)
    rng = np.random.default_rng(5)
    for hw in sample_hardware_pool(rng, 64, num_pes=168):
        hw_d = dataclasses.asdict(hw)
        assert model.hw_is_valid(hw_d, budget)
        for layer in MODEL_LAYERS[name]:
            assert model.lower_bound(hw_d, budget, _layer(layer)) == \
                pytest.approx(lower_bound(hw, layer), rel=1e-15)


# K1b's `kernel` lines of a chip_smoke.py run on an H100:
# rows -> (bytes float64, bytes float32, operations).
KERNEL_LINES = {256: (170240, 97536, 51161), 1024: (680960, 390144, 204337),
                3072: (2042880, 1170432, 611688),
                8192: (5447680, 3121152, 1631357)}


@pytest.mark.parametrize("rows", sorted(KERNEL_LINES))
def test_k1b_bytes_and_operations_match_the_kernel_lines(rows):
    """The operands chip_smoke.py's `kernel` lines time: one 150-row valid
    pool a 256-row bucket, the four workloads' layers in turn on Eyeriss,
    sampled from seed 0."""
    from repro_torch.timeloop import MODEL_LAYERS, eyeriss_168
    from repro_torch.timeloop import batch as tlb
    from repro_torch.timeloop import batch_torch as ttlb

    hw = eyeriss_168()
    rng = np.random.default_rng(0)
    layers = [ly for m in ("resnet", "dqn", "mlp", "transformer")
              for ly in MODEL_LAYERS[m]]
    runs = [layers[k % len(layers)] for k in range(-(-8192 // 256))]
    pools = [tlb.sample_valid_pool(rng, hw, ly, 150) for ly in runs]
    ops = ttlb.forward_operands(hw, pools, runs, "float64", device="cpu")
    f = ops["factors"][:rows].numpy()
    flops = work.k1b_flops(f, ops["order_gb"][:rows].numpy(),
                           ops["order_dram"][:rows].numpy())
    b64, b32, want = KERNEL_LINES[rows]
    assert (work.k1b_bytes(rows, "float64"), work.k1b_bytes(rows, "float32"),
            flops) == (b64, b32, want)


def test_gp_counts_grow_with_their_shapes():
    assert work.gp_fit_flops([20], 14, 80, "linear") > 0
    assert (work.gp_fit_flops([40], 14, 80, "linear")
            > work.gp_fit_flops([20], 14, 80, "linear"))
    assert (work.gp_posterior_flops([20, 30], 60, 14, "se")
            > work.gp_posterior_flops([20], 60, 14, "se"))


@pytest.mark.parametrize("a, b, want", [
    ([(0.0, 4.0)], [(1.0, 2.0)], 3.0),
    ([(0.0, 4.0)], [(-1.0, 5.0)], 0.0),
    ([(0.0, 1.0), (2.0, 3.0)], [(0.5, 2.5)], 1.0),
    ([(0.0, 1.0)], [], 1.0),
])
def test_interval_difference(a, b, want):
    assert intervals.minus(a, b) == pytest.approx(want)


def test_union_merges_overlaps():
    spans = [("a", 0.0, 1.0), ("b", 0.5, 2.0), ("c", 3.0, 4.0)]
    assert intervals.union(spans) == [(0.0, 2.0), (3.0, 4.0)]


def test_reference_and_harness_files_import_no_program():
    """The reference, the metric readers and the yardstick import neither
    the port nor the JAX package (read in a fresh interpreter)."""
    code = ("import sys; sys.path.insert(0, %r); "
            "import reference.model, reference.check, work, intervals; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('repro', 'repro_torch', 'jax', 'torch')))"
            % str(BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "[]"


def _gp_data(kind: str, n: int, seed: int):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 14)) * (0.3 if kind == "se" else 1.0)
    y = X @ rng.normal(size=14) * 0.1 + rng.normal(size=n) * 0.05
    if kind == "se":
        y = np.where(y > np.median(y), 1.0, -1.0)
    return X, y, rng.normal(size=(30, 14)) * (0.3 if kind == "se" else 1.0)


@pytest.mark.parametrize("kind, noisy, n, tol", [
    ("linear", False, 12, 1e-9), ("linear", True, 9, 1e-9),
    ("se", True, 10, 1e-9),
    # More rows than the linear kernel's rank: the noise-free fit is
    # ill-conditioned, and two float64 implementations part further.
    ("linear", False, 40, check.LIMITS["gp_posterior_gap"])])
def test_reference_gp_refits_as_the_port(kind, noisy, n, tol):
    from repro_torch.core.gp import GP

    X, y, pool = _gp_data(kind, n, seed=n)
    mu, var = GP(kind=kind, noisy=noisy, device="cpu").fit(X, y).posterior(
        pool)
    p = gp.fit(kind, noisy, X, y)
    want_mu, want_var = gp.posterior(kind, p, X, y, pool)
    scale = y.std()
    assert np.max(np.abs(mu - want_mu)) / scale <= tol
    assert np.max(np.abs(np.sqrt(var) - np.sqrt(want_var))) / scale <= tol


@pytest.mark.parametrize("kind", ["linear", "se"])
def test_reference_gp_posterior_at_the_ports_hyperparameters(kind):
    from repro_torch.core.gp import GP

    X, y, pool = _gp_data(kind, 11, seed=5)
    model = GP(kind=kind, noisy=True, device="cpu").fit(X, y)
    mu, var = model.posterior(pool)
    p = {k: (v[0].numpy() if v.ndim > 1 else float(v[0]))
         for k, v in model.params.items()}
    want_mu, want_var = gp.posterior(kind, p, X, y, pool)
    assert np.max(np.abs(mu - want_mu)) <= 1e-10 * y.std()
    assert np.max(np.abs(var - want_var)) <= 1e-10 * y.std() ** 2


def test_gp_gradient_is_the_ports_autograd():
    import torch

    from repro_torch.core import gp as port

    for kind in ("linear", "se"):
        X, y, _ = _gp_data(kind, 9, seed=2)
        p = ({"log_w": np.linspace(-0.3, 0.2, 14), "log_bias": 0.1}
             if kind == "linear" else {"log_alpha": 0.2, "log_ell": -0.1})
        p |= {"mean_const": 0.05, "log_tau": -1.5}
        _, g = gp.nll_and_grad(kind, p, X, y)
        t = {k: torch.tensor(np.atleast_1d(v)[None] if np.ndim(v) else [v],
                             dtype=torch.float64, requires_grad=True)
             for k, v in p.items()}
        Xp, yp, mask = port._to("cpu", *port._pad_one(X, y))
        port._nll(t, Xp, yp, mask, kind).sum().backward()
        for k in p:
            np.testing.assert_allclose(t[k].grad.numpy().ravel(),
                                       np.atleast_1d(g[k]), rtol=1e-9,
                                       atol=1e-12)


def _pinned_run():
    """A run of an inner search's scoring query as a window met it: a
    linear kernel with pinned noise, 42 rows above its rank of 15, a
    feature constant over the rows that 12 of the pool's 150 rows leave."""
    data = json.loads((BENCH / "tests" / "data" /
                       "pinned_linear_run.json").read_text())
    return (np.array(data["X"]), np.array(data["y"]),
            np.array(data["pool"]))


def _score_record(X, y, pool) -> dict:
    """A `GPStack.score` record of the port's fit of one run, as
    `harness.Recorder.gp_records` gives it."""
    from repro_torch.core.gp import GPStack

    model = GPStack(kind="linear", noisy=False, device="cpu").fit([X], [y])
    mu, var = model.posterior(pool[None])
    best = np.array([[y.max()]])
    idx, _ = model.score_device(pool[None], best, "lcb", 1.0)
    return {"kind": "GPStack.score", "kernel": "linear", "noisy": False,
            "X": [X], "y": [y], "pool": pool[None], "mu": mu, "var": var,
            "best": best, "idx": np.asarray(idx), "acquisition": "lcb",
            "lam": 1.0, "params": {k: v.numpy() for k, v in
                                   model._state[0].items()}}


def test_check_gp_holds_fits_one_ulp_apart_of_a_pinned_run_correct():
    """Two sound fits of the same run, from inputs one ulp apart: the
    reference's refit of each parts from the port's posterior by more than
    the limit, in units of the data's spread; at the port's hyperparameters
    both posteriors, their choices and their fits pass."""
    X, y, pool = _pinned_run()
    recs = [_score_record(Xi, y, pool) for Xi in (X, np.nextafter(X, 1e9))]
    refit = [gp.posterior("linear", gp.fit("linear", False, rec["X"][0], y),
                          rec["X"][0], y, pool)[0] for rec in recs]
    assert max(np.max(np.abs(rec["mu"][0] - mu)) for rec, mu
               in zip(recs, refit)) > 0.1 * np.std(y)
    post_gap, regret, shortfall = check.check_gp(recs)
    assert post_gap <= check.LIMITS["gp_posterior_gap"]
    assert regret <= check.LIMITS["gp_choice_regret"]
    assert shortfall <= check.LIMITS["gp_fit_shortfall"]


@pytest.mark.parametrize("kind, noisy", [("linear", False), ("linear", True),
                                         ("se", True)])
def test_fit_shortfall_is_the_share_of_the_descent_left_undone(kind, noisy):
    if (kind, noisy) == ("linear", False):
        X, y, _ = _pinned_run()
    else:
        X, y, _ = _gp_data(kind, 11, seed=7)
    start = gp.init(kind, noisy, X, y)
    assert check.fit_shortfall(kind, noisy, start, X, y) == pytest.approx(1.0)
    assert check.fit_shortfall(kind, noisy, gp.fit(kind, noisy, X, y),
                               X, y) == 0.0
    half = check.fit_shortfall(kind, noisy, gp.fit(kind, noisy, X, y, 40),
                               X, y)
    assert 0.0 < half < 1.0


@pytest.mark.parametrize("key, value", [("log_bias", math.nan),
                                        ("log_w", math.inf),
                                        ("mean_const", -math.inf)])
def test_fit_shortfall_of_non_finite_hyperparameters_is_infinite(key, value):
    X, y, _ = _pinned_run()
    p = gp.fit("linear", False, X, y)
    if key == "log_w":
        p[key] = p[key].copy()
        p[key][3] = value
    else:
        p[key] = value
    assert check.fit_shortfall("linear", False, p, X, y) == math.inf


@pytest.mark.parametrize("broken", ["fit", "start"])
def test_a_fit_the_reference_cannot_judge_reads_infinite(monkeypatch,
                                                         broken):
    """Where the reference's own fit has no factor, or the starting point
    no finite likelihood, the program's fit is not judged, and the run is
    not correct."""
    X, y, _ = _pinned_run()
    p = gp.fit("linear", False, X, y)
    if broken == "fit":
        def fails(*args, **kwargs):
            raise np.linalg.LinAlgError("not positive definite")

        monkeypatch.setattr(gp, "fit", fails)
    else:
        start = gp.init("linear", False, X, y)
        monkeypatch.setattr(gp, "init",
                            lambda *args: {**start, "mean_const": math.inf})
    assert check.fit_shortfall("linear", False, p, X, y) == math.inf


def test_a_scoring_record_without_hyperparameters_is_refused():
    X, y, pool = _pinned_run()
    rec = _score_record(X, y, pool)
    del rec["params"]
    with pytest.raises(ValueError, match="hyperparameters"):
        check.check_gp([rec])


@pytest.mark.parametrize("moved, want", [(0, 0.0), (1, 1.0), (7, 1.0),
                                         (150, 1.0)])
def test_posterior_gap_is_the_widest_points_gap(moved, want):
    """Any point of a pool whose posterior moves by a data spread where
    float64 determines it fails the run, the pool's last point alone too."""
    rng = np.random.default_rng(9)
    mu, var = rng.normal(size=150), rng.uniform(0.5, 2.0, size=150)
    still = (np.full(150, 1e-12), np.full(150, 1e-12))
    got = mu.copy()
    got[150 - moved:] += 2.0
    assert check.posterior_gap(got, var, mu, var, still, 2.0) == (
        pytest.approx(want, abs=1e-10))
    got[-1] = math.nan
    assert check.posterior_gap(got, var, mu, var, still, 2.0) == math.inf


def test_posterior_gap_leaves_the_references_own_ulp_move():
    """Where one ulp of the inputs moves the reference's own posterior, a
    gap up to `ULP_ROOM` times that move is rounding; past it, the rest
    counts."""
    mu, var = np.zeros(4), np.ones(4)
    move = (np.array([0.0, 0.1, 0.1, 0.0]), np.array([0.0, 0.0, 0.0, 0.1]))
    room = check.ULP_ROOM * 0.1
    got_mu = mu + [0.0, room, room + 0.3, 0.0]
    assert check.posterior_gap(got_mu, var, mu, var, move, 1.0) == (
        pytest.approx(0.3))
    got_var = np.array([1.0, 1.0, 1.0, (1.0 + room) ** 2])
    assert check.posterior_gap(mu, got_var, mu, var, move, 1.0) == (
        pytest.approx(0.0, abs=1e-12))


@pytest.mark.parametrize("where", ["determined", "tail"])
def test_a_pinned_runs_posterior_moved_on_a_few_points_fails(where):
    """A real scoring run of a pinned-noise fit past its rank: a third of a
    data spread added to seven points that float64 determines, or to the
    pool's last 15%, fails the check; the same run as fit passes."""
    X, y, pool = _pinned_run()
    rec = _score_record(X, y, pool)
    assert check.check_gp([rec])[0] <= check.LIMITS["gp_posterior_gap"]
    p = check.run_params(rec, 0)
    mu, var = gp.posterior("linear", p, X, y, pool)
    move = check.ulp_move("linear", p, X, y, pool, mu, var)[0]
    points = (np.argsort(move)[:7] if where == "determined"
              else np.arange(150 - 22, 150))
    rec["mu"] = rec["mu"].copy()
    rec["mu"][0, points] += np.std(y) / 3
    assert check.check_gp([rec])[0] > check.LIMITS["gp_posterior_gap"]


def test_ulp_move_is_nought_to_rounding_on_well_posed_data():
    X, y, Xs = _gp_data("linear", 11, seed=5)
    p = gp.fit("linear", True, X, y)
    mu, var = gp.posterior("linear", p, X, y, Xs)
    move_mu, move_sd = check.ulp_move("linear", p, X, y, Xs, mu, var)
    assert np.max(move_mu) < 1e-12 * max(1.0, np.max(np.abs(mu)))
    assert np.max(move_sd) < 1e-12
