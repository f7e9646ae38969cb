"""K4, the GP's whole Adam fit in one CUDA launch (`repro_torch.kernels.gp_fit`).

On the CPU:
  * the routing rule (`fit_path`), case by case: device, dtype, `fit_tol`,
    kind, form and caps; a CPU fit never takes the kernel, and `GP` /
    `GPStack` route by their operands' dtype;
  * the packed parameter layout; `gp_fit` refuses CPU tensors;
  * the kernel's algorithm in plain PyTorch (`gp_fit_reference.gp_fit_ref`:
    each run on its real rows, the NLL's gradient in closed form, `_fit`'s
    Adam) against the eager autograd `_fit`: hyperparameters within 1e-9 of
    each block's largest value where the fit is well conditioned;
  * the same algorithm, routed through `GP` / `GPStack` / the classifiers,
    against the JAX reference's own fits of `test_torch_gp.py`'s parity data
    at that file's bars, the reference run live (`test_torch_gp.parity`);
  * the golden the card tests read (`goldens/gp_reference_fits.json`,
    written from the reference by `--regen`) against that live run, so a
    stale golden fails here;
  * a run whose factor fails turns NaN alone.

On the card (`cuda` marker; they skip without one, and this file imports no
jax, so they run on a machine without it): K4 through the public classes
against the eager `_fit` on the same card, for every form (linear Cholesky
noisy and pinned, linear Woodbury over 32 rows, SE, the classifiers) on a
single `GP` and ragged stacks of 1, 4, 8 and 10 runs: well-conditioned fits
hold hyperparameters within 1e-9 and posteriors within `POST_BAR`; the
ill-conditioned pinned-noise fits above the kernel's rank and every
Woodbury fit hold posteriors within `ILL_BAR` and, for a single GP, the same
argmax.  K4 against its algorithm (`gp_fit_ref`) on the same CUDA operands,
at the same bars.  Also on the card: K4 against the reference's own fits
(from the golden: the card has no jax), NaN in a failed run only, one launch
a fit, the library's shared memory at the caps, and the fits that keep the
eager path (an early exit, a shape over the caps).

    PYTHONPATH=src python -m pytest -q tests/test_torch_gp_fit_kernel.py
    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_gp_fit_kernel.py
    PYTHONPATH=src python tests/test_torch_gp_fit_kernel.py --regen
"""

import hashlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import test_torch_gp as parity_data
from gp_fit_reference import gp_fit_ref
from test_torch_gp import ILL_BAR, POST_BAR, _assert_posterior, _rel
from test_torch_gp import parity  # noqa: F401  (the live reference run)

from repro_torch import trace
from repro_torch.core import gp
from repro_torch.core.gp import (GP, GPClassifier, GPClassifierStack, GPStack,
                                 _LOWRANK_MIN_ROWS)
from repro_torch.kernels import gp_fit as k4
from repro_torch.timeloop import MODEL_LAYERS, eyeriss_168
from repro_torch.timeloop import batch as tlb

GOLDEN = Path(__file__).resolve().parent / "goldens" / "gp_reference_fits.json"
PARAM_BAR = 1e-9


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: a CUDA kernel has no CPU mode")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- data -----------------------------------------------------------------------

def _sw_data(rng, layer, n):
    hw = eyeriss_168()
    pool = tlb.sample_valid_pool(rng, hw, layer, n)
    ev = tlb.evaluate_batch(hw, pool, layer)
    return tlb.features_batch(pool, hw, layer), -np.log10(ev["edp"])


def _hw_data(rng, n):
    X = rng.uniform(size=(n, 11))
    return X, np.where(X[:, 4] > np.median(X[:, 4]), 1.0, -1.0)


# name -> (class, kind, noisy, rows: an int for a single GP, a tuple a
# stack, ill conditioned).  Pinned linear fits are well conditioned some
# rows below the kernel's rank d + 1 = 15 (cond K <= 2e6 here) and near
# 1e12 above it; Woodbury fits (a stacked linear fit over 32 padded rows)
# are held at the ill-conditioned bars.
CASES = {
    "linear_noisy": ("GP", "linear", True, 16, False),
    "linear_pinned": ("GP", "linear", False, 8, False),
    "linear_pinned_late": ("GP", "linear", False, 20, True),
    "se_noisy": ("GP", "se", True, 24, False),
    "classifier": ("GPClassifier", "se", True, 30, False),
    "stack1_pinned": ("GPStack", "linear", False, (12,), False),
    "stack4_pinned": ("GPStack", "linear", False, (5, 8, 10, 12), False),
    "stack8_noisy": ("GPStack", "linear", True,
                     (8, 11, 15, 19, 22, 26, 29, 32), False),
    "stack10_pinned_late": ("GPStack", "linear", False,
                            (16, 18, 20, 22, 24, 25, 27, 29, 31, 32), True),
    "stack4_woodbury": ("GPStack", "linear", False, (24, 37, 45, 64), True),
    "stack8_woodbury_noisy": ("GPStack", "linear", True,
                              (33, 36, 40, 44, 48, 52, 58, 64), True),
    "stack10_se": ("GPStack", "se", True,
                   (5, 9, 12, 17, 21, 26, 30, 38, 45, 64), False),
    "clf_stack4": ("GPClassifierStack", "se", True, (9, 14, 20, 33), False),
}


def _case_data(name):
    cls, kind, _, rows, _ = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name) + 100)
    layers = MODEL_LAYERS["resnet"]
    sizes = (rows,) if isinstance(rows, int) else rows
    data, pools = [], []
    for k, n in enumerate(sizes):
        if kind == "linear":
            data.append(_sw_data(rng, layers[k % len(layers)], n))
            pools.append(_sw_data(rng, layers[k % len(layers)], 50)[0])
        else:
            data.append(_hw_data(rng, n))
            pools.append(_hw_data(rng, 50)[0])
    return [x for x, _ in data], [y for _, y in data], np.stack(pools)


def _fit(name, device):
    """(model, GP or GPStack holding the state) of case `name`."""
    cls, kind, noisy, rows, _ = CASES[name]
    Xs, ys, _ = _case_data(name)
    if cls == "GP":
        model = GP(kind=kind, noisy=noisy, device=device).fit(Xs[0], ys[0])
        return model, model
    if cls == "GPClassifier":
        model = GPClassifier(device=device).fit(Xs[0], ys[0] > 0)
        return model, model._gp
    if cls == "GPClassifierStack":
        model = GPClassifierStack(device=device).fit(Xs, [y > 0 for y in ys])
        return model, model._stack
    model = GPStack(kind=kind, noisy=noisy, device=device).fit(Xs, ys)
    return model, model


def _posteriors(name, state):
    _, _, pools = _case_data(name)
    if isinstance(state, GP):
        mu, var = state.posterior(pools[0])
        return mu[None], var[None]
    return state.posterior(pools)


def _host_params(state) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in state._state[0].items()}


def _eager(monkeypatch):
    monkeypatch.setattr(k4, "fit_path", lambda *args: "eager")


def _algorithm_everywhere(monkeypatch):
    """Every fit without an early exit through the kernel's algorithm on the
    CPU, where `gp_fit` would launch K4."""
    monkeypatch.setattr(k4, "fit_path",
                        lambda dev, tol, *args: "kernel" if tol == 0.0
                        else "eager")
    monkeypatch.setattr(k4, "gp_fit",
                        lambda *args, rows, **kwargs: gp_fit_ref(*args,
                                                                 **kwargs))


# --- the routing rule -----------------------------------------------------------

F64, F32 = torch.float64, torch.float32


@pytest.mark.parametrize("device, fit_tol, kind, lowrank, rows, d, dtype, "
                         "path", [
    ("cpu", 0.0, "linear", False, 8, 14, F64, "eager"),
    (torch.device("cpu"), 0.0, "se", False, 8, 11, F64, "eager"),
    ("cuda", 0.0, "linear", False, 8, 14, F64, "kernel"),
    ("cuda:0", 0.0, "linear", False, 64, 14, F64, "kernel"),
    (torch.device("cuda"), 0.0, "se", False, 64, 11, F64, "kernel"),
    ("cuda", 0.0, "linear", False, 65, 14, F64, "eager"),
    ("cuda", 0.0, "se", False, 65, 11, F64, "eager"),
    ("cuda", 1e-3, "linear", False, 8, 14, F64, "eager"),
    ("cuda", 10.0, "se", False, 8, 11, F64, "eager"),
    ("cuda", 0.0, "linear", True, 33, 14, F64, "kernel"),
    ("cuda", 0.0, "linear", True, 512, 14, F64, "kernel"),
    ("cuda", 0.0, "linear", True, 513, 14, F64, "eager"),
    ("cuda", 0.0, "se", True, 40, 11, F64, "eager"),
    ("cuda", 0.0, "matern", False, 8, 11, F64, "eager"),
    ("cuda", 0.0, "linear", False, 8, 32, F64, "kernel"),
    ("cuda", 0.0, "linear", False, 8, 33, F64, "eager"),
    ("cuda", 0.0, "linear", True, 64, 33, F64, "eager"),
    ("cuda", 0.0, "linear", False, 8, 14, F32, "eager"),
    ("cuda", 0.0, "linear", True, 64, 14, F32, "eager"),
    ("cuda", 0.0, "se", False, 16, 11, F32, "eager"),
])
def test_fit_path_routes_by_what_it_can_observe(device, fit_tol, kind,
                                                lowrank, rows, d, dtype,
                                                path):
    assert k4.fit_path(device, fit_tol, kind, lowrank, rows, d, dtype) == path


@pytest.mark.parametrize("dtype", [F64, F32])
def test_the_fits_route_by_their_operands_dtype(monkeypatch, dtype):
    """`GP` and `GPStack` hand `fit_path` the dtype of the operands they
    fit, so the float32 GP (`core.gp._F64` set to float32) keeps the eager
    fit."""
    asked = []

    def record(dev, tol, kind, lowrank, rows, d, dt):
        asked.append(dt)
        return "eager"

    monkeypatch.setattr(k4, "fit_path", record)
    monkeypatch.setattr(gp, "_F64", dtype)
    rng = np.random.default_rng(0)
    Xs = [rng.normal(size=(n, 11)) for n in (12, 20)]
    ys = [rng.normal(size=n) for n in (12, 20)]
    GP(kind="linear", steps=1, device="cpu").fit(Xs[0], ys[0])
    GPStack(kind="se", steps=1, device="cpu").fit(Xs, ys)
    assert asked == [dtype, dtype]


def test_gp_fit_refuses_cpu_tensors():
    params, X, y, mask, kind, noisy, lowrank = _stack_inputs("stack4_pinned")
    with pytest.raises(ValueError, match="CUDA"):
        k4.gp_fit(params, X, y, mask, kind, 2, train_tau=noisy,
                  lowrank=lowrank, rows=12)


@pytest.mark.parametrize("name", ["linear_noisy", "classifier",
                                  "stack4_woodbury", "clf_stack4"])
def test_a_cpu_fit_never_takes_the_kernel(monkeypatch, name):
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU fit reached K4")

    kernel = k4.gp_fit
    before = kernel.launches
    monkeypatch.setattr(k4, "gp_fit", refuse)
    _fit(name, "cpu")
    assert kernel.launches == before


def test_the_stack_routes_by_the_eager_fits_form(monkeypatch):
    """`GPStack.fit` asks for the Woodbury form exactly where `_fit_stack`
    uses it: a linear stack over `_LOWRANK_MIN_ROWS` padded rows."""
    asked = []

    def record(dev, tol, kind, lowrank, rows, d, dtype):
        asked.append((kind, lowrank, rows))
        return "eager"

    monkeypatch.setattr(k4, "fit_path", record)
    rng = np.random.default_rng(0)
    for kind, sizes in (("linear", (20, 32)), ("linear", (20, 33)),
                        ("se", (20, 40))):
        Xs = [rng.normal(size=(n, 11)) for n in sizes]
        GPStack(kind=kind, steps=1, device="cpu").fit(
            Xs, [rng.normal(size=n) for n in sizes])
    assert asked == [("linear", False, 32), ("linear", True, 33),
                     ("se", False, 40)]
    assert _LOWRANK_MIN_ROWS == 32


# --- layout and resources ---------------------------------------------------------

@pytest.mark.parametrize("kind", ["linear", "se"])
def test_the_packed_layout_is_the_fits_sorted_keys(kind):
    params = gp._init_params(kind, 3, 14, "cpu")
    params.update(mean_const=torch.zeros(3, dtype=torch.float64),
                  log_tau=torch.zeros(3, dtype=torch.float64))
    layout = k4.layout(kind, 14)
    assert [k for k, _ in layout] == sorted(params)
    assert all(params[k][0].numel() == w for k, w in layout)


def test_the_bias_corrections_are_the_fits():
    t, want = 0.0, []
    for _ in range(80):
        t = t + 1
        want.append((1 - 0.9 ** t, 1 - 0.999 ** t))
    bc = k4.bias_corrections(80)
    assert bc == [a for a, _ in want] + [b for _, b in want]


# --- the algorithm on the CPU -----------------------------------------------------

WELL = [n for n, c in CASES.items() if not c[4]]


def _stack_inputs(name):
    """(params, X, y, mask, kind, noisy, lowrank) of case `name` as
    `GPStack.fit` packs them, on the CPU."""
    _, kind, noisy, _, _ = CASES[name]
    Xs, ys, _ = _case_data(name)
    if CASES[name][0].startswith("GPClassifier"):
        ys = [np.where(y > 0, 1.0, -1.0) for y in ys]
    X, y, mask = gp._to("cpu", *gp._pad_runs(Xs, ys))
    L, b, d = X.shape
    params = gp._init_params(kind, L, d, "cpu")
    params["mean_const"] = torch.tensor([float(v.mean()) for v in ys],
                                        dtype=torch.float64)
    params["log_tau"] = torch.tensor(
        [np.log(max(v.std(), 1e-3) * 0.1) for v in ys] if noisy
        else [-6.0] * L, dtype=torch.float64)
    lowrank = kind == "linear" and b > _LOWRANK_MIN_ROWS
    return params, X, y, mask, kind, noisy, lowrank


@pytest.mark.parametrize("name", WELL)
def test_the_algorithm_matches_the_eager_fit(name):
    params, X, y, mask, kind, noisy, lowrank = _stack_inputs(name)
    ref = gp_fit_ref(params, X, y, mask, kind, 80, 0.05, noisy, lowrank)
    eager = gp._fit(params, X, y, mask, kind, 80, 0.05, noisy,
                    lowrank=lowrank)
    assert sorted(ref) == sorted(eager)
    for key in eager:
        assert ref[key].shape == eager[key].shape
        assert _rel(ref[key], eager[key]) <= PARAM_BAR, key


def test_a_failed_factor_turns_that_run_nan_alone():
    params, X, y, mask, kind, noisy, lowrank = _stack_inputs("stack4_pinned")
    X = X.clone()
    X[1, 0, 0] = np.inf
    ref = gp_fit_ref(params, X, y, mask, kind, 10, 0.05, noisy, lowrank)
    eager = gp._fit(params, X, y, mask, kind, 10, 0.05, noisy)
    for got in (ref, eager):
        for key, v in got.items():
            v = v.reshape(len(v), -1)
            assert torch.isfinite(v[[0, 2, 3]]).all(), key
            # the pinned noise level keeps its value (zeroed gradient)
            assert (torch.isfinite(v[1]).all() if key == "log_tau"
                    else torch.isnan(v[1]).all()), key


# --- against the JAX reference's own fits ------------------------------------------

def _golden_inputs():
    arrays, cases = parity_data._setup()
    h = hashlib.sha256()
    for key in sorted(arrays):
        h.update(key.encode() + np.ascontiguousarray(arrays[key]).tobytes())
    return arrays, {c["name"]: c for c in cases}, h.hexdigest()


GOLDEN_CASES = [n for n in list(parity_data.SINGLE) + list(parity_data.STACKS)
                if n not in parity_data.FIT_TOL]


@pytest.fixture(scope="module")
def golden():
    arrays, cases, digest = _golden_inputs()
    data = json.loads(GOLDEN.read_text())
    assert data["inputs_sha256"] == digest, (
        "test_torch_gp.py's parity data changed: rerun this file with --regen")
    return arrays, cases, {k: np.asarray(v) for k, v in data["outputs"].items()}


def _hold_to_reference(name, arrays, cases, ref, device, monkeypatch):
    monkeypatch.setattr(parity_data, "DEV", device)
    case = cases[name]
    if name in parity_data.SINGLE:
        clf, model = parity_data._fit_port_single(arrays, case)
        Xq = arrays[name + "_Xs"]
        mu, var = model.posterior(Xq)
        parity_data._check(name, mu, var, ref[name + "_mu"],
                           ref[name + "_var"])
        assert np.argmax(mu + np.sqrt(var)) == np.argmax(
            ref[name + "_mu"] + np.sqrt(ref[name + "_var"]))
    else:
        clf, model = parity_data._fit_port_stack(arrays, case)
        Xq = arrays[name + "_Xs"]
        mu, var = model.posterior(Xq)
        for k in range(case["runs"]):
            parity_data._check(name, mu[k], var[k], ref[name + "_mu"][k],
                               ref[name + "_var"][k])
    if clf is not None:
        prob = clf.prob_feasible_device(Xq).cpu().numpy()
        assert _rel(prob, ref[name + "_prob"]) <= POST_BAR


@pytest.mark.parametrize("name", GOLDEN_CASES)
def test_the_algorithm_matches_the_references_own_fits(parity, monkeypatch,
                                                       name):
    _algorithm_everywhere(monkeypatch)
    _hold_to_reference(name, *parity, "cpu", monkeypatch)


@pytest.mark.parametrize("name", GOLDEN_CASES)
def test_the_golden_is_the_references_own_fits(parity, golden, name):
    """The card's copy of the reference's fits against a live run of it, at
    the bars the card tests hold K4 to."""
    *_, live = parity
    *_, stored = golden
    keys = sorted(k for k in stored if k.startswith(name + "_"))
    assert keys and all(k in live for k in keys)
    bar = ILL_BAR if name in parity_data.ILL_CONDITIONED else POST_BAR
    for key in keys:
        assert stored[key].shape == live[key].shape, key
        assert _rel(stored[key], live[key]) <= bar, key


# --- on the card ------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_k4_matches_the_eager_fit_on_card(card, monkeypatch, name):
    before = k4.gp_fit.launches
    _, state = _fit(name, "cuda")
    assert k4.gp_fit.launches == before + 1
    mu, var = _posteriors(name, state)
    got = _host_params(state)
    with monkeypatch.context() as m:
        _eager(m)
        _, eager_state = _fit(name, "cuda")
    assert k4.gp_fit.launches == before + 1
    mu_e, var_e = _posteriors(name, eager_state)
    want = _host_params(eager_state)
    assert sorted(got) == sorted(want)
    ill = CASES[name][4]
    for k in range(len(mu)):
        _assert_posterior(mu[k], var[k], mu_e[k], var_e[k],
                          ILL_BAR if ill else POST_BAR, ill)
    if ill:
        if CASES[name][0] == "GP":
            assert np.argmax(mu[0] + np.sqrt(var[0])) == np.argmax(
                mu_e[0] + np.sqrt(var_e[0]))
    else:
        for key in want:
            assert got[key].shape == want[key].shape
            assert _rel(got[key], want[key]) <= PARAM_BAR, key


@pytest.mark.cuda
@pytest.mark.parametrize("name", GOLDEN_CASES)
def test_k4_matches_the_references_own_fits_on_card(card, golden,
                                                    monkeypatch, name):
    before = k4.gp_fit.launches
    _hold_to_reference(name, *golden, "cuda", monkeypatch)
    assert k4.gp_fit.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["stack4_pinned", "stack4_woodbury",
                                  "stack10_se"])
def test_k4_turns_a_failed_run_nan_alone_on_card(card, monkeypatch, name):
    _, kind, noisy, rows, _ = CASES[name]
    Xs, ys, _ = _case_data(name)
    Xs[1] = Xs[1].copy()
    Xs[1][0, 0] = np.inf
    fitted = []
    for path in ("kernel", "eager"):
        with monkeypatch.context() as m:
            if path == "eager":
                _eager(m)
            st = GPStack(kind=kind, noisy=noisy, device="cuda").fit(Xs, ys)
            fitted.append(_host_params(st))
    for got in fitted:
        for key, v in got.items():
            v = v.reshape(len(v), -1)
            others = [k for k in range(len(v)) if k != 1]
            assert np.isfinite(v[others]).all(), key
            assert (np.isfinite(v[1]).all() if key == "log_tau" and not noisy
                    else np.isnan(v[1]).all()), key


@pytest.mark.cuda
def test_the_fit_span_says_kernel_on_card(card):
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        _fit("stack4_woodbury", "cuda")
        _fit("linear_noisy", "cuda")
    paths = [s[4]["path"] for s in trace.spans() if s[0] == "gp.fit"]
    trace.clear()
    assert paths == ["kernel", "kernel"]


@pytest.mark.cuda
def test_an_early_exit_or_a_shape_over_the_caps_stays_eager_on_card(card):
    rng = np.random.default_rng(5)
    before = k4.gp_fit.launches
    X, y = _sw_data(rng, MODEL_LAYERS["resnet"][0], 70)
    GP(kind="linear", noisy=True, fit_tol=10.0, device="cuda").fit(X[:16],
                                                                   y[:16])
    GP(kind="se", noisy=True, device="cuda").fit(X, y)
    assert k4.gp_fit.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("form", sorted(k4.FORMS.values()))
def test_the_shared_memory_at_the_caps_fits_an_sm(card, form):
    rows = k4.MAX_ROWS["woodbury" if form == 2 else "cholesky"]
    assert k4.built_smem_bytes(form, rows, k4.MAX_D) <= 227 * 1024


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_k4_matches_its_algorithm_on_card(card, name):
    """K4 against `gp_fit_ref` on the same CUDA operands: hyperparameters
    within 1e-9 where the fit is well conditioned, else the posteriors
    within `ILL_BAR` (a change of one ulp in X moves those fits' parameters
    by up to ~2e-6)."""
    params, X, y, mask, kind, noisy, lowrank = _stack_inputs(name)
    X, y, mask = (t.cuda() for t in (X, y, mask))
    rows = int(mask.sum(dim=1).max())
    got = k4.gp_fit(params, X, y, mask, kind, 80, train_tau=noisy,
                    lowrank=lowrank, rows=rows)
    want = gp_fit_ref({k: v.cuda() for k, v in params.items()}, X, y, mask,
                      kind, 80, 0.05, noisy, lowrank)
    assert sorted(got) == sorted(want)
    if not CASES[name][4]:
        for key in want:
            assert got[key].shape == want[key].shape
            assert _rel(got[key].cpu(), want[key].cpu()) <= PARAM_BAR, key
        return
    _, _, pools = _case_data(name)
    F = torch.as_tensor(pools, dtype=torch.float64, device="cuda")
    mu, var = (t.cpu().numpy() for t in gp._posterior(got, X, y, mask, F,
                                                       kind))
    mu_w, var_w = (t.cpu().numpy() for t in gp._posterior(want, X, y, mask,
                                                          F, kind))
    for k in range(len(mu)):
        _assert_posterior(mu[k], var[k], mu_w[k], var_w[k], ILL_BAR, True)


def regen() -> None:
    """Write the golden: the JAX reference's own fits of the parity data
    (needs jax; `tests/torch_port_reference.py` runs it in a subprocess)."""
    import tempfile

    from torch_port_reference import run_reference

    arrays, cases, digest = _golden_inputs()
    with tempfile.TemporaryDirectory() as tmp:
        ref = run_reference({"task": "gp", "cases": list(cases.values())},
                            arrays, tmp)
    keep = {f"{n}_{what}": ref[f"{n}_{what}"].tolist()
            for n in GOLDEN_CASES for what in ("mu", "var", "prob")
            if f"{n}_{what}" in ref}
    GOLDEN.write_text(json.dumps({"inputs_sha256": digest, "outputs": keep},
                                 sort_keys=True) + "\n")


if __name__ == "__main__":
    if sys.argv[1:] != ["--regen"]:
        raise SystemExit(__doc__)
    regen()
