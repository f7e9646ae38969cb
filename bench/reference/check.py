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
program's GP was handed:

* the inner searches' fused scoring (`GPStack.score_device`, the search's
  hot path): each run refit from its data, its posterior mean and standard
  deviation over the queried pool, and the candidate it chose: its
  acquisition under the reference's posterior against the best there;
* every other posterior (the outer GP, the feasibility classifiers): the
  posterior mean and standard deviation at the hyperparameters the
  program's fit reached.  Their fits are not redone: a hyperparameter whose
  gradient is nought to rounding at the start (the classifier's mean, over
  hardware points far apart) is moved by Adam's normalised steps from
  round-off alone, so two float64 fits part by about a thousandth of the
  data's spread.  The fit is the same function as the hot path's, which is
  refit.

Four numbers come out, each with its limit (see `LIMITS` and PERF.md):
`utility_gap`, the widest gap in log10 units between a recorded value and
the reference's; `mismatches`, the count of decisions the reference
refutes (a feasibility, a best mapping, a cache entry, a censored probe, the
incumbent's hardware, a hardware point outside its budget);
`gp_posterior_gap`, the widest gap of a posterior mean or standard
deviation, in units of the spread of the data the GP was fit to (infinite
where the program's is not a number); and `gp_choice_regret`, the widest
shortfall of a chosen candidate's acquisition below the best, in the same
units.

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
# sit above the program's largest readings (its noise-free fits past the
# linear kernel's rank are ill-conditioned: its own posterior moves by
# about 1e-2 of the data's spread for a change of one ulp in its input) and
# below the float32 control's, which is not a number (posterior) or over 1.
LIMITS = {"utility_gap": 1e-9, "mismatches": 0,
          "gp_posterior_gap": 0.1, "gp_choice_regret": 0.1}
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


def check_gp(records: list[dict]) -> tuple[float, float]:
    """(widest posterior gap, widest choice regret) over the kept GP
    queries, each run refit by the reference from its own data."""
    post_gap = regret = 0.0
    for rec in records:
        for r, (X, y) in enumerate(zip(rec["X"], rec["y"])):
            if r >= len(rec["pool"]):
                break
            if "params" in rec:
                p = {k: (v[r] if np.ndim(v) > 1 else float(v[r]))
                     for k, v in rec["params"].items()}
            else:
                p = gp.fit(rec["kernel"], rec["noisy"], X, y)
            mu, var = gp.posterior(rec["kernel"], p, X, y, rec["pool"][r])
            scale = max(float(np.std(y)), 1e-3)
            got_mu, got_var = rec["mu"][r], rec["var"][r]
            gaps = np.concatenate([
                np.abs(got_mu - mu),
                np.abs(np.sqrt(np.maximum(got_var, 0.0)) - np.sqrt(var))])
            gap = (float(np.max(gaps)) / scale if np.all(np.isfinite(gaps))
                   else math.inf)
            post_gap = max(post_gap, gap)
            if "idx" in rec:
                acq = gp.acquisition(rec["acquisition"], mu, var,
                                     float(rec["best"][r][0]), rec["lam"])
                regret = max(regret, float(acq.max() - acq[int(rec["idx"][r])])
                             / scale)
    return post_gap, regret


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
    post_gap, regret = check_gp(gp_records)
    numbers = {"utility_gap": tally.gap, "mismatches": tally.mismatches,
               "gp_posterior_gap": post_gap, "gp_choice_regret": regret}
    correct = (attempted > 0
               and all(numbers[k] <= LIMITS[k] for k in LIMITS))
    return {"correct": correct, "attempted": attempted, "failed": failed,
            "numbers": {k: {"value": numbers[k], "limit": LIMITS[k]}
                        for k in LIMITS}}
