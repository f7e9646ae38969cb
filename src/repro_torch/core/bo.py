"""Generic constrained Bayesian optimization loop (paper §3, §4).

The loop implements the paper's scheme exactly:
  * warmup with random feasible samples (5 HW / 30 SW in the paper),
  * fit the objective surrogate on feasible observations (linear kernel on
    engineered features; noise kernel only when the evaluator is noisy),
  * if any *output*-infeasible points have been observed, fit the SE-kernel GP
    classifier and weight the acquisition by P(C(x)) (Gelbart et al. 2014),
  * optimize the acquisition by rejection sampling: pool `pool_size` candidates
    that satisfy all input constraints, pick the acquisition argmax,
  * evaluate, record, repeat for `n_trials`.

Two pool-construction refinements apply to list-pool spaces (the hardware
loop): *candidate carry-forward* (`cfg.elite_k` > 0 keeps the previous scored
trial's best unevaluated candidates in the next trial's pool, so the
acquisition optimizer has memory across pool resamples) and *frozen refit
windows* (`gp_refit_every` > 1 reuses one pool per refit window with consumed
candidates masked out, turning the window into one batched acquisition round
-- the q-batch semantics of BoTorch/Vizier-style parallel suggestion, and the
regime where the nested search's speculative prefetch becomes exact).  Packed
software (MappingBatch) pools are untouched by both.

Spaces may implement the *batched evaluation protocol* — `supports_batch`
(truthy), `sample_pool(rng, n)`, `features_batch(pool)`, `evaluate_batch(pool)`
(see `repro_torch.timeloop.batch`) — in which case warmup draws and the per-trial
acquisition pool are sampled, featurized, and scored as whole arrays instead of
one candidate at a time (both the software-mapping space and the hardware
space implement it; the hardware space's `evaluate_batch` still loops — its
evaluator is a full nested search); spaces without the protocol transparently
fall back to the scalar path.

Spaces that additionally expose `supports_device` + `features_batch_device`
(the torch engine, `repro_torch.timeloop.batch_torch`) get *device-resident*
pool scoring: featurization, GP posterior, acquisition, and the feasibility
classifier all stay on-device as one chain per trial, and only the argmax
index (plus the winner's feature row) crosses back to the host.  Everything
on the host side of that boundary is kept strictly NumPy -- an explicit
`.cpu().numpy()` at every device edge (`trace.host`) -- so no host computation
silently works on device tensors with a blocking transfer per trial.

Every surrogate this loop fits is a torch GP on `device` ("cuda" unless the
caller asks for "cpu"), whatever engine evaluates the candidates.

`bo_maximize_many` is the *multi-run* engine: it advances L independent
searches (the nested scheme's per-layer software searches of one hardware
probe) in lockstep, so per-round work that the sequential path repeats L times
collapses into one batched program each — one fused device evaluation over all
runs' candidate pools (`LayerStackSpace` packs them into a single (L*B, 5, 6)
batch), one batched GP fit over all runs' surrogates (`GPStack`, batched
`torch.linalg` solves), one stacked posterior + acquisition + classifier
chain.  Each run
keeps its own RNG stream
(seeded exactly as `bo_maximize(seed=...)` would be), its own observation
history, and its own early-stop mask, so the lockstep engine reproduces L
sequential `bo_maximize` calls run-for-run.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch import trace
from repro_torch.core.acquisition import (make_acquisition,
                                          make_acquisition_device)
from repro_torch.core.config import BACKENDS, SearchConfig, SWSearchConfig
from repro_torch.core.gp import (GP, GPClassifier, GPClassifierStack, GPStack,
                                 apply_prior_mean)
from repro_torch.core.trees import RandomForestSurrogate
from repro_torch.device import resolve_device
from repro_torch.timeloop import batch as tlb


class InfeasibleSpace(RuntimeError):
    """Raised when input-constraint rejection sampling cannot find any valid
    point -- the search space itself is (empirically) empty.  At the hardware
    level this is the paper's *unknown constraint*."""


@contextlib.contextmanager
def _backend_override(spaces, backend: str):
    """Engine override for spaces that carry one, scoped to one run -- the
    callers' spaces are restored on the way out.  Unknown values and spaces
    without backend selection are reported, never ignored.  Shared by
    `bo_maximize` and `bo_maximize_many`."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    for s in spaces:
        if not hasattr(s, "backend"):
            raise ValueError(
                f"space {getattr(s, 'name', s)!r} does not support "
                "backend selection")
    prev = [s.backend for s in spaces]
    for s in spaces:
        s.backend = backend
    try:
        yield
    finally:
        for s, b in zip(spaces, prev):
            s.backend = b


@dataclasses.dataclass
class BOResult:
    best_point: Any
    best_value: float                 # utility (maximized): -log10(EDP)
    history: list[float]              # best-so-far utility per trial
    values: list[float]               # raw utility per trial (-inf if infeasible)
    points: list[Any]
    n_infeasible: int = 0


def score_topk(utility, k: int) -> np.ndarray:
    """Indices of the k largest utilities in DESCENDING order -- the ranking
    sibling of `GPStack.score_device`'s fused argmax, used by the speculative
    outer loop to pick its fan-out candidates.  The sort is stable, so ties
    rank by pool index and entry 0 is exactly `np.argmax(utility)` -- the
    candidate the BO trial itself consumes."""
    utility = trace.host(utility)
    k = max(1, min(int(k), len(utility)))
    return np.argsort(-utility, kind="stable")[:k]


def _prefetch_topk(space, pool, utility, k_cap: int | None = None) -> None:
    """Speculative-prefetch hook: spaces exposing `prefetch_topk_fn` (+ a
    `prefetch_topk` width > 1) get the trial's pool candidates ranked by
    acquisition utility, best first, BEFORE the argmax is evaluated.  The
    nested search's "speculative" strategy injects it on the hardware space to
    fan the top-k probes' inner searches out as one stacked multi-run program;
    entry 0 is the trial's own argmax, the rest are speculation.  Purely an
    observer: no RNG is consumed and the trial's own selection is untouched,
    so the BO trajectory is exactly the un-hooked one.

    `k_cap` bounds the width when the loop KNOWS how much speculation can
    still be consumed -- inside a frozen refit window only the window's
    remaining trials can select a speculated candidate, so anything wider is
    guaranteed waste."""
    fn = getattr(space, "prefetch_topk_fn", None)
    k = int(getattr(space, "prefetch_topk", 0) or 0)
    if k_cap is not None:
        k = min(k, k_cap)
    if fn is None or k <= 1:
        return
    idx = score_topk(utility, k)
    fn([pool[int(i)] for i in idx])


def _resolve_search_config(config, overrides) -> SearchConfig:
    """Normalize (config object, field overrides) to one validated
    `SearchConfig`.  Overrides are the config's own field names
    (n_trials/n_warmup/pool_size/acquisition/lam/surrogate) -- the pre-config
    kwarg surface -- applied through `dataclasses.replace`, so the replaced
    config re-validates and an unknown name raises TypeError."""
    if config is not None and not isinstance(config, SearchConfig):
        # Loud break for pre-config positional callers (n_trials used to be
        # the second positional argument).
        raise TypeError(
            f"config must be a SearchConfig (e.g. SWSearchConfig), got "
            f"{config!r}; pass search fields by keyword (n_trials=...)")
    cfg = config if config is not None else SWSearchConfig()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


class BOLoop:
    """One constrained-BO search as an explicit, resumable state machine.

    `bo_maximize(...)` is exactly `BOLoop(...).run()`: all of the loop's
    state -- RNG stream, observation history, surrogate/classifier, frozen
    pool window, elite carry-forward -- lives on the instance instead of in
    closure variables, and each trial splits into two halves:

      `plan()`    advance the loop up to (but not through) its next
                  evaluation: refit the surrogate if due, sample the trial's
                  candidate pool, score it, and return a *plan* describing
                  what the trial is about to evaluate.  All RNG consumption
                  happens here.  Idempotent: repeated calls return the same
                  pending plan.
      `commit()`  execute the pending plan: evaluate the selected
                  candidate(s), record observations, update elites, fire the
                  speculative-prefetch hook and the callback.

    The split is what lets an external scheduler (the co-design service)
    inspect what a session is about to evaluate -- `plan()["pool"]` /
    the scored plan's ranked utilities -- and pre-fill evaluation caches
    across many concurrent loops before any of them commits.  `plan()`
    followed by `commit()` performs the exact statement sequence of the
    historical inline loop, so stepped execution is bit-identical to
    `run()`, which is bit-identical to the pre-refactor `bo_maximize`.

    `snapshot()`/`restore()` round-trip the loop through a plain dict (no
    live plan may be outstanding): the RNG state, histories, incumbent, and
    frozen window are copied, and the surrogate/classifier are *refit* from
    the recorded fit boundary on restore (model fits are deterministic given
    their data, so the restored loop continues bit-identically).
    """

    def __init__(
        self,
        space,
        config: SearchConfig | None = None,
        *,
        noisy: bool = False,
        seed: int = 0,
        gp_refit_every: int = 1,
        gp_rank1: bool = False,
        callback: Callable[[int, BOResult], None] | None = None,
        prior: dict | None = None,
        prior_mean_fn: Callable | None = None,
        device: str = "cuda",
        **overrides,
    ):
        cfg = _resolve_search_config(config, overrides)
        resolve_device(device)
        self.device = device
        self.space = space
        self.cfg = cfg
        self.noisy = noisy
        self.seed = seed
        self.gp_refit_every = gp_refit_every
        self.gp_rank1 = gp_rank1
        self.callback = callback
        self.elite_k = getattr(cfg, "elite_k", 0)
        self.rng = np.random.default_rng(seed)
        self._acq = make_acquisition(cfg.acquisition, cfg.lam)
        self._acq_dev = None

        # Candidate carry-forward (cfg.elite_k): the previous scored trial's
        # top candidates that were NOT evaluated survive into the next
        # trial's pool, so the acquisition optimizer has memory across pool
        # resamples.  Only list pools support appending (the hardware space;
        # packed MappingBatch pools of the software loop keep elite_k = 0).
        self._elites: list = []
        self._observed: set = set()
        # Frozen refit windows: see the comment at `plan`.
        self._can_freeze = gp_refit_every > 1 and bool(
            getattr(space, "supports_pool_freeze", False))

        self._X_feas: list[np.ndarray] = []
        self._y_feas: list[float] = []
        self._X_all: list[np.ndarray] = []
        self._feas_all: list[bool] = []
        # Residual prior mean (cross-run transfer): when `prior_mean_fn` is
        # set the surrogate is fit on y - m(x) and `plan()` adds m back via
        # `apply_prior_mean`, so `_m_feas` mirrors `_y_feas` row-for-row with
        # the m value of each feasible observation.
        self._prior_mean_fn = prior_mean_fn
        self._m_feas: list[float] = []
        self.n_prior = 0
        self.result = BOResult(None, -np.inf, [], [], [])

        self._use_batch = bool(getattr(space, "supports_batch", False))
        # Device-resident scoring needs the GP surrogate (the tree surrogate
        # is host-only) and a space whose feature arrays live on device.
        self._use_device = (
            self._use_batch
            and bool(getattr(space, "supports_device", False))
            and cfg.surrogate in ("gp_linear", "gp_se")
        )
        if prior_mean_fn is not None and self._use_device:
            raise ValueError(
                "prior_mean_fn is host-path only: the fused device scoring "
                "path never materializes host posterior means to offset")
        if prior is not None:
            self._load_prior(prior)

        self._model = None
        self._classifier = None
        self._window_pool = None
        self._window_feats = None
        # Fit boundary bookkeeping for snapshot/restore: the trial index and
        # history lengths of the most recent refit (restore refits from
        # exactly this prefix, then replays any rank-1 appends).
        self._fit: dict | None = None
        self._warmed = min(cfg.n_warmup, cfg.n_trials) == 0
        self._plan: dict | None = None

    # --- state queries -----------------------------------------------------------

    @property
    def done(self) -> bool:
        return self._warmed and len(self.result.history) >= self.cfg.n_trials

    # --- prior observations (cross-run transfer) ---------------------------------

    def _load_prior(self, prior: dict) -> None:
        """Seed the surrogate/classifier data lists with prior observations
        (cross-run transfer) before the first warmup probe.

        `prior` carries feature-space rows only -- no candidate points -- so
        priors shape the *surrogate* (and the feasibility classifier) without
        entering `result`: the incumbent, histories, and trial budget all
        still come exclusively from this run's own evaluations.  Required
        keys: "X_feas" (feasible feature rows), "y_feas" (their utilities),
        "X_all" (every prior row), "feas_all" (their feasibility flags).
        When `prior_mean_fn` is set, "m_feas" (the prior mean at each
        feasible row) is required too -- feature rows cannot be pushed back
        through a point-wise mean function.  An all-empty prior is exactly
        equivalent to no prior."""
        required = ("X_feas", "y_feas", "X_all", "feas_all")
        missing = [k for k in required if k not in prior]
        if missing:
            raise ValueError(f"prior is missing keys {missing}; "
                             f"required: {list(required)}")
        X_feas = [np.asarray(x, dtype=np.float64) for x in prior["X_feas"]]
        y_feas = [float(v) for v in prior["y_feas"]]
        X_all = [np.asarray(x, dtype=np.float64) for x in prior["X_all"]]
        feas_all = [bool(f) for f in prior["feas_all"]]
        if len(X_feas) != len(y_feas):
            raise ValueError(
                f"prior X_feas/y_feas length mismatch: "
                f"{len(X_feas)} != {len(y_feas)}")
        if len(X_all) != len(feas_all):
            raise ValueError(
                f"prior X_all/feas_all length mismatch: "
                f"{len(X_all)} != {len(feas_all)}")
        if len(X_feas) != sum(feas_all):
            raise ValueError(
                f"prior feasible-row count mismatch: {len(X_feas)} X_feas "
                f"rows but {sum(feas_all)} feasible flags in feas_all")
        dim = getattr(self.space, "feature_dim", None)
        for row in X_feas + X_all:
            if row.ndim != 1 or (dim is not None and row.shape != (dim,)):
                raise ValueError(
                    f"prior feature row has shape {row.shape}; expected a "
                    f"1-d row{f' of dim {dim}' if dim is not None else ''}")
        if self._prior_mean_fn is not None:
            if "m_feas" not in prior:
                raise ValueError(
                    "prior_mean_fn is set but prior has no 'm_feas': prior "
                    "mean values cannot be recovered from feature rows")
            m_feas = [float(v) for v in prior["m_feas"]]
            if len(m_feas) != len(X_feas):
                raise ValueError(
                    f"prior m_feas/X_feas length mismatch: "
                    f"{len(m_feas)} != {len(X_feas)}")
            self._m_feas.extend(m_feas)
        self._X_feas.extend(X_feas)
        self._y_feas.extend(y_feas)
        self._X_all.extend(X_all)
        self._feas_all.extend(feas_all)
        self.n_prior = len(X_all)

    # --- inner helpers (the historical closures, verbatim) -----------------------

    def _observe(self, point, feats=None, outcome=None) -> None:
        space, result = self.space, self.result
        feats = space.features(point) if feats is None else feats
        value, feasible = space.evaluate(point) if outcome is None else outcome
        if self.elite_k or self._can_freeze:
            # evaluated points never re-enter as elites, and frozen window
            # pools mask them out
            self._observed.add(point)
        self._X_all.append(feats)
        self._feas_all.append(feasible)
        result.points.append(point)
        if feasible:
            self._X_feas.append(feats)
            self._y_feas.append(value)
            if self._prior_mean_fn is not None:
                self._m_feas.append(
                    float(np.asarray(self._prior_mean_fn([point]))[0]))
            if value > result.best_value:
                result.best_value, result.best_point = value, point
            result.values.append(value)
        else:
            result.n_infeasible += 1
            result.values.append(-np.inf)
        result.history.append(result.best_value)

    def _rank1_update(self, feat_row) -> None:
        """`gp_rank1`: fold the observation just recorded into the surrogate's
        posterior by an O(n^2) incremental Cholesky update (frozen
        hyperparameters; see `GP.append_observation`) instead of leaving the
        posterior stale until the next aligned refit.  GP surrogates only --
        the tree surrogate has no incremental form -- and only feasible
        observations (infeasible ones never enter the objective GP's data)."""
        if not (self.gp_rank1 and isinstance(self._model, GP)):
            return
        v = self.result.values[-1]
        if np.isfinite(v):
            if self._prior_mean_fn is not None:
                v = v - self._m_feas[-1]  # the GP holds residuals y - m(x)
            self._model.append_observation(np.asarray(feat_row, np.float64), v)

    def _update_elites(self, pool, utility, i_best) -> None:
        elite_k, observed = self.elite_k, self._observed
        if not (elite_k and isinstance(pool, list)):
            return
        new: list = []
        winner = pool[i_best]
        for i in score_topk(utility, elite_k + 1 + len(observed)):
            p = pool[int(i)]
            # compare by value, not index: a duplicate of the just-evaluated
            # winner elsewhere in the pool must not survive as an elite
            if p == winner or p in observed or p in new:
                continue
            new.append(p)
            if len(new) == elite_k:
                break
        self._elites[:] = new

    def _sample_valid(self, max_attempts: int = 20_000):
        """Rejection sampling against the *known* input constraints (paper
        §3.4): invalid draws are rejected before any evaluation."""
        for _ in range(max_attempts):
            p = self.space.sample(self.rng)
            if self.space.is_valid(p):
                return p
        raise InfeasibleSpace(getattr(self.space, "name", "space"))

    def _sample_valid_pool(self, n):
        """Input-valid candidate pool as a packed batch (batched protocol)."""
        pool = self.space.sample_pool(self.rng, n)
        if pool is None:
            raise InfeasibleSpace(getattr(self.space, "name", "space"))
        return pool

    def _make_model(self, t: int):
        """An unfitted surrogate of the configured kind (the refit at trial
        `t`; the forest's seed depends on it)."""
        surrogate = self.cfg.surrogate
        if surrogate == "gp_linear":
            return GP(kind="linear", noisy=self.noisy, device=self.device)
        if surrogate == "gp_se":
            return GP(kind="se", noisy=self.noisy, device=self.device)
        if surrogate == "rf":
            return RandomForestSurrogate(seed=self.seed + t)
        raise ValueError(surrogate)

    def _maybe_refit(self, t: int) -> None:
        if not (len(self._y_feas) >= 2
                and (self._model is None or t % self.gp_refit_every == 0)):
            return
        Xf = np.stack(self._X_feas)
        yf = np.asarray(self._y_feas)
        if self._prior_mean_fn is not None:
            yf = yf - np.asarray(self._m_feas)  # fit residuals y - m(x)
        self._model = self._make_model(t).fit(Xf, yf)
        if any(not f for f in self._feas_all):
            self._classifier = GPClassifier(device=self.device).fit(
                np.stack(self._X_all), np.asarray(self._feas_all))
        else:
            self._classifier = None
        self._window_pool = self._window_feats = None  # new posterior -> new pool
        self._fit = {"t": t, "n_feas": len(self._y_feas),
                     "n_all": len(self._X_all),
                     "had_clf": self._classifier is not None}

    # --- plan / commit -----------------------------------------------------------

    def plan(self) -> dict | None:
        """Advance to the next evaluation boundary and describe it; None when
        the loop is done.  Plan kinds:

          {"kind": "warmup", "pool": candidates}  the warmup block (evaluated
              in one batch at commit)
          {"kind": "sample", "t", "point"}        a pre-surrogate trial (not
              enough feasible data yet): one random candidate
          {"kind": "scored", "t", "pool", "utility", "k_cap", ...}  a scored
              trial: the acquisition-ranked pool; commit evaluates
              `pool[argmax(utility)]`

        All RNG consumption and surrogate refits happen here; the pending
        plan is cached until `commit()` consumes it, so external schedulers
        may inspect it (and pre-fill evaluation caches) without perturbing
        the trajectory."""
        if self._plan is not None:
            return self._plan
        if self.done:
            return None
        if not self._warmed:
            n_warm = min(self.cfg.n_warmup, self.cfg.n_trials)
            if self._use_batch:
                pool = self._sample_valid_pool(n_warm)
            else:
                pool = [self._sample_valid() for _ in range(n_warm)]
            self._plan = {"kind": "warmup", "pool": pool}
            return self._plan

        t = len(self.result.history)
        self._maybe_refit(t)

        if self._model is None:  # not enough feasible data yet -> keep sampling
            point = (self._sample_valid_pool(1)[0] if self._use_batch
                     else self._sample_valid())
            self._plan = {"kind": "sample", "t": t, "point": point}
            return self._plan

        if self._use_device:
            # Fused pool scoring: features, GP posterior, acquisition, and
            # P(feasible) chain on-device; one scalar index comes back (at
            # commit).
            if self._acq_dev is None:
                self._acq_dev = make_acquisition_device(
                    self.cfg.acquisition, self.cfg.lam)
            pool = self._sample_valid_pool(self.cfg.pool_size)
            feats_dev = self.space.features_batch_device(pool)
            mu, var = self._model.posterior_device(feats_dev)
            utility = self._acq_dev(mu, var, self.result.best_value)
            if self._classifier is not None:
                utility = utility * self._classifier.prob_feasible_device(
                    feats_dev)
            self._plan = {"kind": "scored", "t": t, "pool": pool,
                          "feats": None, "feats_dev": feats_dev,
                          "utility": utility, "k_cap": None, "device": True}
            return self._plan

        # Pool freezing (gp_refit_every > 1 on spaces that opt in through
        # `supports_pool_freeze`, e.g. the hardware space): within one refit
        # window the posterior is fixed, so the window IS one batched
        # acquisition round -- the pool sampled at the refit trial is reused
        # (frozen) by the window's remaining trials with consumed candidates
        # masked out, making the window consume the posterior's top
        # candidates one per trial (the q-batch semantics of BoTorch/
        # Vizier-style parallel suggestion, and what makes speculative
        # prefetches exact for rank-stable acquisitions like LCB).  Spaces
        # without the opt-in (all software spaces; `bo_maximize_many`'s
        # lockstep contract covers them) keep per-trial resampling, and only
        # list pools -- hashable candidate identity -- can freeze.
        frozen = self._window_pool is not None
        if frozen and all(p in self._observed for p in self._window_pool):
            # The window outlived its pool (stride > unobserved candidates):
            # resample instead of re-evaluating masked-out points forever.
            self._window_pool = self._window_feats = None
            frozen = False
        if frozen:
            pool, feats = self._window_pool, self._window_feats
        elif self._use_batch:
            pool = self._sample_valid_pool(self.cfg.pool_size)
            feats = self.space.features_batch(pool)
            if self._elites and isinstance(pool, list):
                # Reuse the base pool's packed features (memoized per pool
                # identity by the space) and append the handful of elite rows
                # scalar-wise -- same column math, so the stacked matrix is
                # bit-identical to featurizing pool + elites from scratch.
                pool = pool + self._elites
                feats = np.vstack(
                    [feats] + [self.space.features(p)[None]
                               for p in self._elites])
        else:
            pool = [self._sample_valid() for _ in range(self.cfg.pool_size)]
            if self._elites:
                pool = pool + self._elites
            feats = np.stack([self.space.features(p) for p in pool])
        if self._can_freeze and not frozen and isinstance(pool, list):
            self._window_pool, self._window_feats = pool, feats
        mu, var = self._model.posterior(feats)
        if self._prior_mean_fn is not None:
            # The surrogate holds residuals y - m(x); put m back before the
            # acquisition so utilities compare against the true incumbent.
            mu = apply_prior_mean(mu, self._prior_mean_fn(pool))
        utility = self._acq(mu, var, self.result.best_value)
        if self._classifier is not None:
            # prob_feasible returns a host array; the asarray keeps the
            # boundary explicit so the acquisition math never silently
            # promotes to device arrays.
            utility = utility * np.asarray(
                self._classifier.prob_feasible(feats))
        if frozen:
            # Already-consumed candidates leave the frozen window pool.
            utility = np.where([p in self._observed for p in pool],
                               -np.inf, utility)
        k_cap = None
        if self._window_pool is not None:
            # Windowed mode: only the window's remaining trials (this one
            # included) can consume a speculated candidate -- wider
            # speculation is guaranteed waste.
            next_refit = (t // self.gp_refit_every + 1) * self.gp_refit_every
            k_cap = min(next_refit, self.cfg.n_trials) - t
        self._plan = {"kind": "scored", "t": t, "pool": pool, "feats": feats,
                      "utility": utility, "k_cap": k_cap, "device": False}
        return self._plan

    def commit(self) -> None:
        """Execute the pending plan (see `plan`): evaluate, observe, update
        elites, fire the prefetch hook and callback."""
        plan = self._plan
        assert plan is not None, "commit() without a pending plan()"
        self._plan = None
        if plan["kind"] == "warmup":
            pool = plan["pool"]
            n_warm = len(pool)
            self._warmed = True
            if self._use_batch and n_warm:
                warm_feats = self.space.features_batch(pool)
                warm_vals, warm_feas = self.space.evaluate_batch(pool)
                for i in range(n_warm):
                    self._observe(pool[i], feats=warm_feats[i],
                                  outcome=(warm_vals[i], bool(warm_feas[i])))
            else:
                for p in pool:
                    self._observe(p)
            return
        t = plan["t"]
        if plan["kind"] == "sample":
            self._observe(plan["point"])
            if self.callback:
                self.callback(t, self.result)
            return
        pool, utility = plan["pool"], plan["utility"]
        if plan["device"]:
            _prefetch_topk(self.space, pool, utility)
            i_best = int(trace.host(torch.argmax(utility)))
            feat_row = trace.host(plan["feats_dev"][i_best]).astype(np.float64)
            self._observe(pool[i_best], feats=feat_row)
            self._rank1_update(feat_row)
        else:
            _prefetch_topk(self.space, pool, utility, k_cap=plan["k_cap"])
            i_best = int(np.argmax(utility))
            self._update_elites(pool, utility, i_best)
            self._observe(pool[i_best], feats=plan["feats"][i_best])
            self._rank1_update(plan["feats"][i_best])
        if self.callback:
            self.callback(t, self.result)

    def step(self) -> bool:
        """plan + commit one stage (the warmup block counts as one stage,
        then one trial per call); returns True while the loop has more work."""
        if self.done:
            return False
        self.plan()
        self.commit()
        return not self.done

    def run(self) -> BOResult:
        while self.step():
            pass
        return self.result

    # --- snapshot / restore ------------------------------------------------------

    def snapshot(self) -> dict:
        """Resumable state as a plain (picklable) dict.  Must be taken at an
        evaluation boundary -- no pending plan (its RNG draws are already
        consumed and cannot be replayed)."""
        if self._plan is not None:
            raise RuntimeError(
                "snapshot() with a pending plan: commit() it first")
        r = self.result
        return {
            "rng": self.rng.bit_generator.state,
            "X_feas": [np.array(x) for x in self._X_feas],
            "y_feas": list(self._y_feas),
            "X_all": [np.array(x) for x in self._X_all],
            "feas_all": list(self._feas_all),
            "m_feas": list(self._m_feas),
            "n_prior": self.n_prior,
            "result": {
                "best_point": r.best_point, "best_value": r.best_value,
                "history": list(r.history), "values": list(r.values),
                "points": list(r.points), "n_infeasible": r.n_infeasible,
            },
            "elites": list(self._elites),
            "observed": list(self._observed),
            "window_pool": (None if self._window_pool is None
                            else list(self._window_pool)),
            "window_feats": (None if self._window_feats is None
                             else np.array(self._window_feats)),
            "fit": None if self._fit is None else dict(self._fit),
            "warmed": self._warmed,
        }

    def restore(self, snap: dict) -> "BOLoop":
        """Load a `snapshot()` into this (freshly constructed, same space +
        config) loop.  The surrogate/classifier are refit from the recorded
        fit boundary's data prefix -- fits are deterministic, so the refit
        model matches the snapshotted one -- and rank-1 appends recorded
        after that boundary are replayed."""
        self.rng.bit_generator.state = snap["rng"]
        self._X_feas = [np.array(x) for x in snap["X_feas"]]
        self._y_feas = list(snap["y_feas"])
        self._X_all = [np.array(x) for x in snap["X_all"]]
        self._feas_all = list(snap["feas_all"])
        self._m_feas = list(snap.get("m_feas", []))
        self.n_prior = int(snap.get("n_prior", 0))
        rs = snap["result"]
        self.result = BOResult(
            best_point=rs["best_point"], best_value=rs["best_value"],
            history=list(rs["history"]), values=list(rs["values"]),
            points=list(rs["points"]), n_infeasible=rs["n_infeasible"])
        self._elites = list(snap["elites"])
        self._observed = set(snap["observed"])
        self._window_pool = (None if snap["window_pool"] is None
                             else list(snap["window_pool"]))
        self._window_feats = (None if snap["window_feats"] is None
                              else np.array(snap["window_feats"]))
        self._fit = None if snap["fit"] is None else dict(snap["fit"])
        self._warmed = snap["warmed"]
        self._plan = None
        self._model = self._classifier = None
        if self._fit is not None:
            fit = self._fit
            n = fit["n_feas"]
            Xf = np.stack(self._X_feas[:n])
            yf = np.asarray(self._y_feas[:n])
            if self._prior_mean_fn is not None:
                yf = yf - np.asarray(self._m_feas[:n])
            self._model = self._make_model(fit["t"]).fit(Xf, yf)
            if fit["had_clf"]:
                self._classifier = GPClassifier(device=self.device).fit(
                    np.stack(self._X_all[:fit["n_all"]]),
                    np.asarray(self._feas_all[:fit["n_all"]]))
            # Feasible observations recorded after the fit boundary were
            # appended through rank-1 updates (only scored trials run once a
            # model exists, and only under gp_rank1): replay them.
            if self.gp_rank1 and isinstance(self._model, GP):
                for i, (row, v) in enumerate(
                        zip(self._X_feas[n:], self._y_feas[n:])):
                    if self._prior_mean_fn is not None:
                        v = v - self._m_feas[n + i]
                    self._model.append_observation(
                        np.asarray(row, np.float64), float(v))
        return self


def bo_maximize(
    space,
    config: SearchConfig | None = None,
    *,
    noisy: bool = False,
    seed: int = 0,
    gp_refit_every: int = 1,
    gp_rank1: bool = False,
    callback: Callable[[int, BOResult], None] | None = None,
    backend: str | None = None,
    device: str = "cuda",
    **overrides,
) -> BOResult:
    cfg = _resolve_search_config(config, overrides)
    if backend is not None:
        with _backend_override([space], backend):
            return bo_maximize(
                space, cfg, noisy=noisy, seed=seed,
                gp_refit_every=gp_refit_every, gp_rank1=gp_rank1,
                callback=callback, device=device,
            )
    with trace.span("inner.search") as sp:
        result = BOLoop(
            space, cfg, noisy=noisy, seed=seed, gp_refit_every=gp_refit_every,
            gp_rank1=gp_rank1, callback=callback, device=device,
        ).run()
        if sp:
            sp.set(runs=1, trials=len(result.points))
    return result


@dataclasses.dataclass
class _Cohort:
    """One stacked surrogate fit shared by a set of runs: the `GPStack` (and
    the classifier stack for the subset of its runs that have observed
    unknown-constraint violations), plus the absolute run indices in stack
    order.  With `gp_refit_every == 1` there is exactly one live cohort; with
    a larger stride, runs whose surrogate first became fittable off-schedule
    sit in their own cohort until the next aligned refit (mirroring the
    per-run `model is None or t % gp_refit_every == 0` schedule of
    `bo_maximize`)."""

    model: GPStack
    clf: GPClassifierStack | None
    runs: list[int]
    clf_runs: list[int]


def bo_maximize_many(
    spaces,
    config: SearchConfig | None = None,
    *,
    noisy: bool = False,
    seed: int | Sequence[int] = 0,
    gp_refit_every: int = 1,
    callback: Callable[[int, list[BOResult]], None] | None = None,
    backend: str | None = None,
    device: str = "cuda",
    **overrides,
) -> list[BOResult]:
    """Advance L independent BO runs in lockstep; returns one `BOResult` per
    space, matching ``[bo_maximize(s, ...) for s in spaces]`` run-for-run
    (each run draws from its own RNG stream, exactly as the sequential calls
    would).  `seed` is one shared seed (the layer-batched nested search: all
    per-layer runs of one probe are seeded alike) or a sequence of L per-run
    seeds (the probe-fanout search: runs belonging to different hardware
    probes keep their probes' distinct seeds).

    Per round, the L-fold repeated work becomes one batched program each:
    candidate pools are featurized by a single fused device dispatch when the
    spaces stack (`LayerStackSpace`; per-space batched calls otherwise), the
    per-run surrogates are refit as one batched `GPStack`, and the posterior /
    acquisition / feasibility-classifier scoring runs over the stacked pools
    at once (device-resident end-to-end on the torch engine).

    A run whose space proves empirically unsampleable finishes early with an
    empty `BOResult` (best_point None) instead of raising `InfeasibleSpace` --
    the other runs continue; this matches how the nested search treats a
    layer with no feasible mapping.  Tree surrogates and non-batched spaces
    fall back to sequential `bo_maximize` calls.

    `callback`, when given, receives `(trial_index, results_list)` once per
    lockstep round (not per run; on the sequential fallback it fires per
    advancing run, with empty placeholders for runs not yet started)."""
    cfg = _resolve_search_config(config, overrides)
    spaces = list(spaces)
    L = len(spaces)
    if L == 0:
        return []
    seeds = [seed] * L if isinstance(seed, (int, np.integer)) else list(seed)
    if len(seeds) != L:
        raise ValueError(f"seed sequence has {len(seeds)} entries "
                         f"for {L} spaces")
    if backend is not None:
        with _backend_override(spaces, backend):
            return bo_maximize_many(
                spaces, cfg, noisy=noisy, seed=seeds,
                gp_refit_every=gp_refit_every, callback=callback,
                device=device,
            )
    with trace.span("inner.search") as sp:
        results = _lockstep(spaces, cfg, noisy, seeds, gp_refit_every,
                            callback, device)
        if sp:
            sp.set(runs=L, trials=sum(len(r.points) for r in results))
    return results


def _lockstep(spaces, cfg, noisy, seeds, gp_refit_every, callback,
              device) -> list[BOResult]:
    """The body of `bo_maximize_many` for validated arguments."""
    L = len(spaces)
    n_trials, n_warmup, pool_size = cfg.n_trials, cfg.n_warmup, cfg.pool_size
    acquisition, lam, surrogate = cfg.acquisition, cfg.lam, cfg.surrogate

    stackable = (
        surrogate in ("gp_linear", "gp_se")
        and all(getattr(s, "supports_batch", False) for s in spaces)
        and L > 1
    )
    if not stackable:
        # Sequential fallback: tree surrogates are host-only (no stacked fit),
        # scalar-protocol spaces have nothing to stack, and a single run gains
        # nothing from lockstep.  Per-run infeasibility still maps to an empty
        # result so both paths have one contract.  The callback keeps its
        # (trial, results_list) shape -- runs advance one after another here,
        # so it fires once per (run, trial) with the completed runs' results,
        # the advancing run's live result, and empty placeholders for runs
        # not yet started.
        out: list[BOResult] = []
        for i, s in enumerate(spaces):
            cb = None
            if callback is not None:
                rest = [BOResult(None, -np.inf, [], [], [])
                        for _ in spaces[i + 1:]]
                cb = lambda t, r, _rest=rest: callback(t, out + [r] + _rest)
            try:
                out.append(bo_maximize(
                    s, cfg, noisy=noisy, seed=seeds[i],
                    gp_refit_every=gp_refit_every, callback=cb,
                    device=device))
            except InfeasibleSpace:
                out.append(BOResult(None, -np.inf, [], [], []))
        return out

    from repro_torch.core.swspace import LayerStackSpace

    resolve_device(device)
    stack = LayerStackSpace.maybe(spaces)
    use_device = (
        stack is not None
        and stack.supports_device
        and surrogate in ("gp_linear", "gp_se")
    )
    kind = {"gp_linear": "linear", "gp_se": "se"}[surrogate]

    rngs = [np.random.default_rng(s) for s in seeds]
    acq = make_acquisition(acquisition, lam)
    acq_dev = make_acquisition_device(acquisition, lam) if use_device else None

    results = [BOResult(None, -np.inf, [], [], []) for _ in spaces]
    X_feas: list[list[np.ndarray]] = [[] for _ in spaces]
    y_feas: list[list[float]] = [[] for _ in spaces]
    X_all: list[list[np.ndarray]] = [[] for _ in spaces]
    feas_all: list[list[bool]] = [[] for _ in spaces]
    alive = [True] * L
    cohort_of: list[_Cohort | None] = [None] * L

    def kill(k: int) -> None:
        """Early-stop mask: the run's space proved unsampleable -> finish it
        with an empty result (the sequential path's InfeasibleSpace outcome)."""
        alive[k] = False
        results[k] = BOResult(None, -np.inf, [], [], [])

    def observe(k: int, point, feats=None, outcome=None) -> None:
        feats = spaces[k].features(point) if feats is None else feats
        value, feasible = spaces[k].evaluate(point) if outcome is None else outcome
        X_all[k].append(feats)
        feas_all[k].append(feasible)
        r = results[k]
        r.points.append(point)
        if feasible:
            X_feas[k].append(feats)
            y_feas[k].append(value)
            if value > r.best_value:
                r.best_value, r.best_point = value, point
            r.values.append(value)
        else:
            r.n_infeasible += 1
            r.values.append(-np.inf)
        r.history.append(r.best_value)

    # --- warmup: one stacked evaluation over all runs' warmup pools -----------
    n_warm = min(n_warmup, n_trials)
    if n_warm:
        with trace.span("inner.sample") as sp:
            counted = tlb.pool_counts() if sp else None
            pools = []
            for k in range(L):
                p = spaces[k].sample_pool(rngs[k], n_warm)
                if p is None:
                    kill(k)
                    p = None
                pools.append(p)
            live = [k for k in range(L) if alive[k]]
            if live:
                if stack is not None:
                    full = [p if p is not None
                            else stack.placeholder_pool(n_warm)
                            for p in pools]
                    fwd = stack.forward_stacked(full, runs=live)
                    feats_w, vals_w, feas_w = (
                        fwd["features"], fwd["utility"], fwd["valid"])
                else:
                    d = spaces[0].feature_dim
                    feats_w = np.zeros((L, n_warm, d))
                    vals_w = np.full((L, n_warm), -np.inf)
                    feas_w = np.zeros((L, n_warm), dtype=bool)
                    for k in live:
                        feats_w[k] = spaces[k].features_batch(pools[k])
                        vals_w[k], feas_w[k] = spaces[k].evaluate_batch(
                            pools[k])
            if sp:
                sp.set(**tlb.pool_counts_since(counted))
        with trace.span("inner.observe"):
            for k in live:
                for i in range(n_warm):
                    observe(k, pools[k][i], feats=feats_w[k, i],
                            outcome=(vals_w[k, i], bool(feas_w[k, i])))

    # --- lockstep trials ------------------------------------------------------
    for t in range(n_warm, n_trials):
        if not any(alive):
            break
        # Refit cohort: every run whose surrogate is due this round, fit as
        # ONE batched GPStack (+ one classifier stack for the runs that have
        # seen unknown-constraint violations).
        need = [k for k in range(L)
                if alive[k] and len(y_feas[k]) >= 2
                and (cohort_of[k] is None or t % gp_refit_every == 0)]
        if need:
            gps = GPStack(kind=kind, noisy=noisy, device=device).fit(
                [np.stack(X_feas[k]) for k in need],
                [np.asarray(y_feas[k]) for k in need])
            clf_runs = [k for k in need if not all(feas_all[k])]
            clf = (GPClassifierStack(device=device).fit(
                       [np.stack(X_all[k]) for k in clf_runs],
                       [np.asarray(feas_all[k]) for k in clf_runs])
                   if clf_runs else None)
            cohort = _Cohort(gps, clf, need, clf_runs)
            for k in need:
                cohort_of[k] = cohort

        with trace.span("inner.sample") as sp:
            counted = tlb.pool_counts() if sp else None
            # Runs without a surrogate yet keep sampling (scalar, like the
            # sequential path: one candidate, scalar features + evaluation).
            for k in range(L):
                if alive[k] and cohort_of[k] is None:
                    p = spaces[k].sample_pool(rngs[k], 1)
                    if p is None:
                        kill(k)
                    else:
                        observe(k, p[0])

            scoring = [k for k in range(L)
                       if alive[k] and cohort_of[k] is not None]
            if scoring:
                pools = [None] * L
                for k in scoring:
                    pools[k] = spaces[k].sample_pool(rngs[k], pool_size)
                    if pools[k] is None:
                        kill(k)
                scoring = [k for k in scoring if alive[k]]
            if scoring:
                feats = feats_dev = None
                if stack is not None:
                    full = [p if p is not None
                            else stack.placeholder_pool(pool_size)
                            for p in pools]
                    if use_device:
                        feats_dev = stack.features_stacked_device(full)
                    else:
                        feats = stack.features_stacked(full, runs=scoring)
                else:
                    d = spaces[0].feature_dim
                    feats = np.zeros((L, pool_size, d))
                    for k in scoring:
                        feats[k] = spaces[k].features_batch(pools[k])
            if sp:
                sp.set(**tlb.pool_counts_since(counted))
        if scoring:
            scoring_set = set(scoring)
            cohorts = list({id(cohort_of[k]): cohort_of[k] for k in scoring}.values())
            for cohort in cohorts:
                runs = cohort.runs
                best = np.array([[results[k].best_value] for k in runs])
                if use_device:
                    dev = feats_dev.device
                    sub = feats_dev[torch.as_tensor(runs, device=dev)]
                    if cohort.clf is None:
                        # Hot case (the inner software searches sample
                        # input-valid pools, so no classifier ever fits):
                        # posterior + acquisition + argmax + winner gather
                        # in one chain; only indices and rows come back.
                        idx, rows = cohort.model.score_device(
                            sub, best, acquisition, lam)
                    else:
                        mu, var = cohort.model.posterior_device(sub)
                        # The incumbents enter as f64, like the sequential
                        # path's Python-float best.
                        util = acq_dev(mu, var, torch.as_tensor(
                            best, dtype=torch.float64, device=mu.device))
                        pos = torch.as_tensor(
                            [runs.index(k) for k in cohort.clf_runs],
                            device=mu.device)
                        probs = cohort.clf.prob_feasible_device(
                            feats_dev[torch.as_tensor(cohort.clf_runs,
                                                      device=dev)])
                        # Indexed multiply on a fresh tensor (the acquisition
                        # output is not modified in place).
                        util = util.clone()
                        util[pos] *= probs
                        idx_t = torch.argmax(util, dim=1)
                        idx = trace.host(idx_t)
                        rows = trace.host(torch.take_along_dim(
                            sub, idx_t.to(sub.device)[:, None, None],
                            dim=1)[:, 0, :]).astype(np.float64)
                else:
                    sub = feats[np.asarray(runs)]
                    mu, var = cohort.model.posterior(sub)
                    util = acq(mu, var, best)
                    if cohort.clf is not None:
                        pos = [runs.index(k) for k in cohort.clf_runs]
                        util[pos] = util[pos] * np.asarray(
                            cohort.clf.prob_feasible(
                                feats[np.asarray(cohort.clf_runs)]))
                    idx = np.argmax(util, axis=1)
                    rows = sub[np.arange(len(runs)), idx]
                with trace.span("inner.observe"):
                    for r, k in enumerate(runs):
                        if k in scoring_set:
                            observe(k, pools[k][int(idx[r])],
                                    feats=np.asarray(rows[r],
                                                     dtype=np.float64))
        if callback:
            callback(t, results)

    return results


@dataclasses.dataclass(frozen=True)
class FanoutSearchSpec:
    """A pickle-safe description of one stacked multi-item inner search.

    This is the unit of work the executor layer (`repro_torch.parallel`)
    moves between processes: exactly the `(hw, layer)` items a
    `SearchSession.pending()` emits, with their content-derived seeds, plus
    the two config sections that determine the search.  `run()` reproduces
    what the learner would have computed inline -- one
    `optimize_software_fanout` stacked dispatch on `engine.device` -- and
    reduces each item's `BOResult` to the `(mapping | None, edp)` cache
    entry, so the IPC payload back to the learner is a few floats per item
    instead of a full history.

    Everything here is a frozen dataclass of plain scalars, so the spec
    crosses a spawn boundary with the default pickler; unpickling it imports
    no evaluation engine (`timeloop.batch_torch`, the kernels) and opens no
    CUDA context -- a worker does both at its first `run()`.
    """

    items: tuple          # ((hw, layer), ...) pairs, order-significant
    seeds: tuple          # per-item content-derived seeds, len == len(items)
    sw: SWSearchConfig
    engine: Any           # EngineConfig (typed loosely: config imports no bo)
    pad_to: int | None = None

    def run(self) -> list:
        # Late import: the module attribute lookup keeps test spies on
        # `nested.optimize_software_fanout` effective under every executor.
        from repro_torch.core import nested

        results = nested.optimize_software_fanout(
            list(self.items), self.sw, seeds=list(self.seeds),
            engine=self.engine, pad_to=self.pad_to)
        return [nested._cache_entry(hw, layer, r)
                for (hw, layer), r in zip(self.items, results)]
