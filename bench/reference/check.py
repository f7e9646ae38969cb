"""The comparison that decides a run's `correct`.

After the window has closed, every answer the search recorded in it is
worked out again by the plain reference (`model.py`):

* every inner trial: the utility -log10(EDP) the search recorded for each
  mapping it tried (the device cost model's for the warm-up pools, the host
  model's for the scored trials), and whether it called the mapping
  feasible;
* every inner search's best mapping: the best of the mappings it tried;
* every (hardware, layer) entry of the engine's cache: that search's best
  mapping and its EDP;
* every outer trial (a probe): its recorded utility, -log10 of the summed
  per-layer EDPs, or, where the prune gate censored it, -log10 of the larger
  of the reference's summed lower bound and the incumbent, with the bound
  above the incumbent;
* the incumbent: the least summed EDP among the probes searched, and its
  hardware.

and of the GP surrogates, a sample of the window's queries drawn from the
seed (`harness.Recorder`), worked out again by `gp.py` from the data the
program's GP was handed and the hyperparameters its fit reached:

* every posterior (the inner searches' fused scoring,
  `GPStack.score_device`, the search's hot path; the outer GP; the
  feasibility classifiers): its mean and standard deviation over the
  queried pool at the program's hyperparameters, and for the scoring the
  candidate it chose: its acquisition under that posterior against the
  best there;
* every fit of the scoring (each run of a `GPStack` is fit on exactly the
  data it is queried with): the likelihood it reaches, against the
  reference's own fit of the same data.

The posterior is not judged after a refit of the reference's own: on the
linear kernel's noise-free fits past its rank (cond K ~1e12) the likelihood
is flat along some directions, any two float64 fits part there by ~1e-6,
and the posterior moves by whole data spreads for that.  Nor is a fit
judged by its hyperparameters: a hyperparameter whose gradient is nought
to rounding (the classifier's mean, over hardware points far apart) is
moved by Adam's normalised steps from round-off alone.  The likelihood
does not move along those directions.

Five numbers come out, each with its limit (see `LIMITS` and PERF.md):
`utility_gap`, the widest gap in log10 units between a recorded value and
the reference's; `mismatches`, the count of decisions the reference
refutes (a feasibility, a best mapping, a cache entry, a censored probe, the
incumbent's hardware, a hardware point outside its budget);
`gp_posterior_gap`, the widest gap of a posterior mean or standard
deviation at a point of a pool beyond `ULP_ROOM` times the reference's own
move there for a change of one ulp in the run's inputs, in units of the
spread of the data the GP was fit to (`posterior_gap`; infinite where the
program's is not a number);
`gp_choice_regret`, the widest shortfall of a chosen candidate's
acquisition below the best, in units of the data's spread; and
`gp_fit_shortfall`, the widest share of the reference fit's descent of the
negative log-likelihood that the program's fit leaves undone
(`fit_shortfall`).

Records are plain data (see `harness.Search.record` and
`harness.Recorder.gp_records`); nothing here imports
the program.
"""

from __future__ import annotations

import math

import numpy as np

from reference import gp, model

# Set from the readings in PERF.md ("How correct is decided"): utility_gap
# between the program's largest reading over its seeds and the float32
# control's smallest; mismatches is an exact comparison.  The GP's numbers
# sit above the program's largest readings and below its controls': the
# float32 GP's posterior is not a number, its fits' and those of fits
# stopped at half of their steps fall far short of the reference's, and a
# posterior mean moved by half a spread on a pool's tail reads 0.5.
LIMITS = {"utility_gap": 1e-9, "mismatches": 0,
          "gp_posterior_gap": 0.1, "gp_choice_regret": 0.1,
          "gp_fit_shortfall": 0.1}
# The least descent of the NLL, in nats, a fit's shortfall is a share of.
FIT_FLOOR = 1e-3
# A point's posterior gap may reach this many times the reference's own
# move there for one ulp of the inputs (set from the readings in PERF.md:
# no sound run needed more than 2.35 times; the points a planted fault
# moves, where float64 determines the posterior, have next to no room).
ULP_ROOM = 6.0
# Two summed EDPs within this relative gap are one incumbent.
_TIE = 1e-12


def _hw_key(hw: dict) -> tuple:
    return tuple(hw[k] for k in model.SEARCHED)


def _log_gap(a: float, b: float) -> float:
    return abs(math.log10(a) - math.log10(b))


class _Tally:
    def __init__(self):
        self.gap = 0.0
        self.mismatches = 0

    def value(self, got: float, want: float) -> bool:
        """Records a recorded-versus-reference gap; True when it is within
        the limit."""
        if math.isinf(got) and got == want:
            return True
        gap = abs(got - want) if math.isfinite(got - want) else math.inf
        self.gap = max(self.gap, gap)
        return gap <= LIMITS["utility_gap"]

    def refute(self) -> bool:
        self.mismatches += 1
        return False


def check_session(rec: dict, config: dict, margin: float | None,
                  tally: _Tally) -> tuple[int, int]:
    """Checks one search's record; returns (probes, probes that failed)."""
    budget = config["budget"]
    layers = {ly["name"]: ly for ly in config["layers"]}
    names = [ly["name"] for ly in config["layers"]]
    ok_of_item: dict[tuple, bool] = {}
    best_of_item: dict[tuple, object] = {}

    def edp(hw, mapping, layer):
        return model.evaluate(hw, budget, mapping, layers[layer])

    for run in rec["inner"]:
        key = (_hw_key(run["hw"]), run["layer"])
        ok = True
        utils = []
        for mapping, got in zip(run["points"], run["values"]):
            want = model.utility(edp(run["hw"], mapping, run["layer"]))
            utils.append(want)
            if math.isfinite(got) != math.isfinite(want):
                ok = tally.refute()
            elif math.isfinite(got):
                ok &= tally.value(got, want)
        if len(run["points"]) != len(run["values"]):
            ok = tally.refute()
        best = run["best_point"]
        feasible = [u for u in utils if math.isfinite(u)]
        if best is None:
            if feasible:
                ok = tally.refute()
        else:
            u_best = model.utility(edp(run["hw"], best, run["layer"]))
            if not math.isfinite(u_best):
                ok = tally.refute()
            else:
                ok &= tally.value(u_best, max(feasible))
        ok_of_item[key] = ok
        best_of_item[key] = best

    for (hw, layer), (mapping, got) in rec["cache"]:
        key = (_hw_key(hw), layer)
        ok = ok_of_item.get(key, False)
        if key not in best_of_item or best_of_item[key] != mapping:
            ok = tally.refute()
        elif mapping is not None:
            want = edp(hw, mapping, layer)
            if not math.isfinite(want) or not math.isfinite(got):
                ok = tally.refute()
            else:
                ok &= tally.value(-math.log10(got), -math.log10(want))
        ok_of_item[key] = ok

    cache = {(_hw_key(hw), layer): entry for (hw, layer), entry in
             rec["cache"]}
    incumbent, inc_key = math.inf, None
    failed = 0
    for probe in rec["outer"]:
        hw, got = probe["hw"], probe["value"]
        key = _hw_key(hw)
        ok = model.hw_is_valid(hw, budget) and all(
            hw[k] == budget[k] for k in ("num_pes", "lb_budget", "gb_entries",
                                         "dram_bandwidth"))
        if not ok:
            tally.refute()
        if probe["censored"] is None:
            failed += not tally.refute()
            continue
        if probe["censored"]:
            bound = sum(model.lower_bound(hw, budget, layers[n])
                        for n in names)
            if margin is None or not bound > incumbent * margin:
                ok = tally.refute()
            ok &= tally.value(got, -math.log10(max(bound, incumbent)))
            failed += not ok
            continue
        entries = [cache.get((key, n)) for n in names]
        if any(e is None for e in entries):
            failed += not tally.refute()
            continue
        ok &= all(ok_of_item.get((key, n), False) for n in names)
        if any(m is None for m, _ in entries):
            if math.isfinite(got):
                ok = tally.refute()
            failed += not ok
            continue
        total = sum(edp(hw, m, n) for (m, _), n in zip(entries, names))
        if not math.isfinite(total):
            ok = tally.refute()
        else:
            ok &= tally.value(got, -math.log10(total))
            if total < incumbent:
                incumbent, inc_key = total, key
        failed += not ok

    best = rec["best"]
    if math.isfinite(incumbent):
        if not math.isfinite(best["edp"]):
            tally.refute()
        else:
            tally.value(-math.log10(best["edp"]), -math.log10(incumbent))
            if best["hw"] is None or _hw_key(best["hw"]) != inc_key:
                mine = math.inf
                if best["hw"] is not None:
                    entries = [cache.get((_hw_key(best["hw"]), n))
                               for n in names]
                    if all(e is not None and e[0] is not None
                           for e in entries):
                        mine = sum(edp(best["hw"], m, n)
                                   for (m, _), n in zip(entries, names))
                if not _log_gap(mine, incumbent) <= _TIE:
                    tally.refute()
    elif best["hw"] is not None or math.isfinite(best["edp"]):
        tally.refute()
    return len(rec["outer"]), failed


def run_params(rec: dict, r: int) -> dict:
    """Run r's hyperparameters as the program's fit left them."""
    if "params" not in rec:
        raise ValueError(f"a {rec['kind']} record without the program's "
                         "hyperparameters: the check does not refit")
    return {k: (v[r] if np.ndim(v) > 1 else float(v[r]))
            for k, v in rec["params"].items()}


def _nll(kind: str, p: dict, X, y) -> float:
    """The reference's negative marginal log-likelihood; infinite where it
    is not a number or the kernel matrix has no factor."""
    try:
        value = float(gp.nll_and_grad(kind, p, X, y)[0])
    except np.linalg.LinAlgError:
        return math.inf
    return value if math.isfinite(value) else math.inf


def fit_shortfall(kind: str, noisy: bool, p: dict, X, y) -> float:
    """The share of the reference fit's own descent of the NLL that the
    program's fit leaves undone:

        (NLL(p) - NLL(p_ref)) / max(NLL(p_0) - NLL(p_ref), FIT_FLOOR),

    clipped below at 0, with p the program's hyperparameters, p_ref the
    reference's `gp.fit` and p_0 the stated starting point (`gp.init`), all
    on the run's own data.  A fit that stops short, or never starts, reads
    near 1; two fits that part along a flat direction of the likelihood
    read near 0.  `FIT_FLOOR` (1e-3 nats, a likelihood ratio of 1.001)
    keeps a fit the reference cannot improve from being divided by nought.
    Non-finite hyperparameters, or an NLL that is not a number, read
    infinite; so does a fit that the reference cannot judge, where its own
    fit or the starting point has no finite NLL: no run is correct with a
    fit left unjudged."""
    X = np.asarray(X, np.float64)
    y = np.asarray(y, np.float64)
    if not all(np.all(np.isfinite(v)) for v in p.values()):
        return math.inf
    try:
        best = _nll(kind, gp.fit(kind, noisy, X, y), X, y)
    except np.linalg.LinAlgError:
        return math.inf
    got = _nll(kind, p, X, y)
    start = _nll(kind, gp.init(kind, noisy, X, y), X, y)
    if math.isinf(got) or math.isinf(best) or math.isinf(start):
        return math.inf
    return max(0.0, (got - best) / max(start - best, FIT_FLOOR))


def ulp_move(kind: str, p: dict, X, y, pool, mu, var):
    """Each pool point's move of the reference's own posterior mean and
    standard deviation at p when every input of X moves by one ulp, up or
    down (the wider of the two): how far float64 determines the posterior
    there."""
    X = np.asarray(X, np.float64)
    sd = np.sqrt(var)
    move_mu = move_sd = np.zeros(len(mu))
    for direction in (math.inf, -math.inf):
        m, v = gp.posterior(kind, p, np.nextafter(X, direction), y, pool)
        move_mu = np.maximum(move_mu, np.abs(m - mu))
        move_sd = np.maximum(move_sd, np.abs(np.sqrt(v) - sd))
    return move_mu, move_sd


def posterior_gap(got_mu, got_var, mu, var, move, scale: float) -> float:
    """The gap of one run's posterior over its pool: the widest point's gap
    of the mean or the standard deviation beyond `ULP_ROOM` times the
    reference's own move there for one ulp of the inputs (`move`, from
    `ulp_move`), in units of `scale`, the spread of the data; infinite
    where the program's is not a number.  On the linear kernel's noise-free
    fits past its rank (cond K ~1e12) float64 determines the mean at a few
    points of a pool only to about a data spread; everywhere else the
    room is nought to rounding."""
    move_mu, move_sd = move
    gaps = np.maximum(
        np.abs(got_mu - mu) - ULP_ROOM * move_mu,
        np.abs(np.sqrt(np.maximum(got_var, 0.0)) - np.sqrt(var))
        - ULP_ROOM * move_sd)
    if not np.all(np.isfinite(gaps)):
        return math.inf
    return max(0.0, float(np.max(gaps))) / scale


def check_gp(records: list[dict]) -> tuple[float, float, float]:
    """(widest posterior gap, widest choice regret, widest fit shortfall)
    over the kept GP queries: each run's posterior worked out again at the
    hyperparameters the program's fit reached, on its own data, and each
    run of a scoring query's fit judged by the likelihood it reaches."""
    post_gap = regret = shortfall = 0.0
    for rec in records:
        for r, (X, y) in enumerate(zip(rec["X"], rec["y"])):
            if r >= len(rec["pool"]):
                break
            p = run_params(rec, r)
            scale = max(float(np.std(y)), 1e-3)
            if rec["kind"] == "GPStack.score":
                shortfall = max(shortfall, fit_shortfall(
                    rec["kernel"], rec["noisy"], p, X, y))
            pool = rec["pool"][r]
            try:
                mu, var = gp.posterior(rec["kernel"], p, X, y, pool)
                move = ulp_move(rec["kernel"], p, X, y, pool, mu, var)
            except np.linalg.LinAlgError:
                post_gap = math.inf
                continue
            post_gap = max(post_gap, posterior_gap(
                rec["mu"][r], rec["var"][r], mu, var, move, scale))
            if "idx" in rec:
                acq = gp.acquisition(rec["acquisition"], mu, var,
                                     float(rec["best"][r][0]), rec["lam"])
                regret = max(regret, float(acq.max() - acq[int(rec["idx"][r])])
                             / scale)
    return post_gap, regret, shortfall


def check(records: list[dict], config: dict, margin: float | None,
          gp_records: list[dict] = ()) -> dict:
    """The run's verdict over every search of the window: `correct`,
    `attempted` and `failed` probes, and the numbers compared with their
    limits."""
    tally = _Tally()
    attempted = failed = 0
    for rec in records:
        n, f = check_session(rec, config, margin, tally)
        attempted += n
        failed += f
    post_gap, regret, shortfall = check_gp(gp_records)
    numbers = {"utility_gap": tally.gap, "mismatches": tally.mismatches,
               "gp_posterior_gap": post_gap, "gp_choice_regret": regret,
               "gp_fit_shortfall": shortfall}
    correct = (attempted > 0
               and all(numbers[k] <= LIMITS[k] for k in LIMITS))
    return {"correct": correct, "attempted": attempted, "failed": failed,
            "numbers": {k: {"value": numbers[k], "limit": LIMITS[k]}
                        for k in LIMITS}}
