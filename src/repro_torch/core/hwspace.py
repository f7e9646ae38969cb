"""Hardware search space (paper §4.2).

Known constraints (mesh products, storage budget) are input constraints enforced
at sampling time; the *unknown* constraint -- "does a feasible software mapping
exist / can the inner optimizer find one" -- surfaces through evaluate() and is
modeled by the SE-kernel GP classifier in the BO loop.  Hardware evaluation is
noisy (the inner SW search is stochastic), so the objective GP keeps a learned
noise kernel.

The space implements the BO loop's *batched evaluation protocol*
(`supports_batch` / `sample_pool` / `features_batch` / `evaluate_batch`): the
150-candidate acquisition pools are drawn by the array-vectorized sampler
(`arch.sample_hardware_pool`) and featurized as one packed (n, 11) matrix
instead of one config at a time.  Evaluation stays scalar underneath --
scoring one hardware point *is* a full inner software search, so
`evaluate_batch` (used only for the handful of warmup points) simply loops;
the batching win is in pool construction and featurization, which run once
per outer BO trial.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.core.cache import SlotCache
from repro_torch.timeloop.arch import (HardwareConfig, hw_is_valid, sample_hardware,
                                 sample_hardware_pool)

HW_FEATURE_NAMES = (
    "mesh_x_ratio",       # PE mesh-X / GB mesh-X  (Fig. 13)
    "mesh_y_ratio",       # PE mesh-Y / GB mesh-Y  (Fig. 13)
    "log_pe_mesh_x",
    "log_pe_mesh_y",
    "lb_input_frac",
    "lb_weight_frac",
    "lb_output_frac",
    "log_gb_instances",
    "log_gb_bandwidth",
    "df_fw",
    "df_fh",
)


@dataclasses.dataclass
class HardwareSpace:
    num_pes: int = 168
    base: HardwareConfig | None = None
    # evaluate_fn(hw) -> (utility | None, feasible); injected by the nested search.
    evaluate_fn: Callable[[HardwareConfig], tuple[float | None, bool]] | None = None
    # prefetch_fn(pool): optional batch hook, called once with the whole pool
    # before evaluate_batch's scalar loop.  The nested search's probe-fanout
    # strategy injects it to run ALL warmup probes' inner software searches as
    # one stacked multi-run fan-out; the loop below then reads cache hits.
    prefetch_fn: Callable[[list[HardwareConfig]], None] | None = None
    # prefetch_topk_fn(cands): optional per-scored-trial hook -- the BO loop
    # hands it the pool's top-`prefetch_topk` candidates ranked by acquisition
    # utility (best first; entry 0 is the trial's own argmax) before the argmax
    # is evaluated.  The nested search's speculative strategy injects it to fan
    # the k probes' inner searches out as ONE stacked multi-run program: the
    # argmax probe's layers become cache hits for this trial's evaluation, the
    # k-1 speculative probes' for whichever later trial selects them.
    prefetch_topk_fn: Callable[[list[HardwareConfig]], None] | None = None
    prefetch_topk: int = 0
    # prune_fn(pool) -> pool: optional bound-and-prune hook applied to every
    # sampled candidate pool (warmup and scored trials alike).  The nested
    # search injects it when `HWSearchConfig.prune != "off"`: candidates whose
    # summed per-layer EDP lower bound (`timeloop.bounds`) already exceeds the
    # incumbent's true model EDP are dropped before featurization, so the
    # acquisition -- and the speculative prefetch riding on it -- only ever
    # spends inner searches on candidates that can still win.  Must return a
    # non-empty subset (the engine's guard keeps the lowest-bound candidate).
    prune_fn: Callable[[list[HardwareConfig]], list[HardwareConfig]] | None = None
    # Opt in to the BO loop's frozen refit windows (gp_refit_every > 1 reuses
    # one pool per refit window with consumed candidates masked -- batched
    # q-batch acquisition).  An outer-loop semantic: spaces without this stay
    # on per-trial resampling, and the lockstep multi-run engine (which the
    # hardware loop never uses) keeps its sequential-parity contract.
    supports_pool_freeze: bool = True
    name: str = "hardware"
    # Pool sampling + featurization take the packed-array protocol; evaluation
    # itself is the nested inner search and stays scalar (see module
    # docstring).  Set False to force the scalar reference path.
    supports_batch: bool = True

    def __post_init__(self) -> None:
        # Pool-identity memo (the `SoftwareSpace._fwd_cache` idiom): a frozen
        # refit window re-presents the SAME pool object across its trials,
        # and the prune pass featurizes pools the BO loop featurizes again --
        # deriving the packed (n, 11) matrix once per pool object makes every
        # repeat free.  A bounded, counted SlotCache (capacity 2: the frozen
        # window's pool plus the freshest draw) so long-lived service
        # processes never accumulate stale pool arrays.
        self._feat_cache = SlotCache("hw_feat", capacity=2)

    @property
    def feature_dim(self) -> int:
        return len(HW_FEATURE_NAMES)

    def sample(self, rng) -> HardwareConfig:
        while True:
            hw = sample_hardware(rng, num_pes=self.num_pes, base=self.base)
            if hw_is_valid(hw)[0]:
                return hw

    def is_valid(self, hw: HardwareConfig) -> bool:
        return hw_is_valid(hw)[0]

    def features(self, hw: HardwareConfig) -> np.ndarray:
        return np.array(
            [
                hw.pe_mesh_x / hw.gb_mesh_x,
                hw.pe_mesh_y / hw.gb_mesh_y,
                np.log1p(hw.pe_mesh_x),
                np.log1p(hw.pe_mesh_y),
                hw.lb_input / hw.lb_budget,
                hw.lb_weight / hw.lb_budget,
                hw.lb_output / hw.lb_budget,
                np.log1p(hw.gb_instances),
                np.log1p(hw.gb_bandwidth),
                float(hw.df_fw - 1),
                float(hw.df_fh - 1),
            ],
            dtype=np.float64,
        )

    def evaluate(self, hw: HardwareConfig) -> tuple[float | None, bool]:
        assert self.evaluate_fn is not None, "inject evaluate_fn (nested search)"
        return self.evaluate_fn(hw)

    # --- batched evaluation protocol --------------------------------------------

    def sample_pool(self, rng, n: int) -> list[HardwareConfig]:
        """n input-valid configs, array-vectorized draws (every draw satisfies
        the structural constraints by construction, so no rejection rounds).
        An injected `prune_fn` filters the draw afterwards -- it consumes no
        RNG, so runs with pruning off and on share the identical sample
        stream."""
        pool = sample_hardware_pool(rng, n, num_pes=self.num_pes, base=self.base)
        if self.prune_fn is not None:
            pool = self.prune_fn(pool)
        return pool

    def features_batch(self, pool) -> np.ndarray:
        """(n, 11) feature matrix computed as whole-array column ops, memoized
        per pool identity (see `__post_init__`)."""
        cached = self._feat_cache.get(pool)
        if cached is not None:
            return cached
        cols = np.array(
            [
                [hw.pe_mesh_x, hw.pe_mesh_y, hw.gb_mesh_x, hw.gb_mesh_y,
                 hw.lb_input, hw.lb_weight, hw.lb_output, hw.lb_budget,
                 hw.gb_instances, hw.gb_bandwidth, hw.df_fw, hw.df_fh]
                for hw in pool
            ],
            dtype=np.float64,
        ).T
        (mx, my, gx, gy, li, lw, lo, budget, gbi, gbbw, fw, fh) = cols
        feats = np.stack(
            [
                mx / gx,
                my / gy,
                np.log1p(mx),
                np.log1p(my),
                li / budget,
                lw / budget,
                lo / budget,
                np.log1p(gbi),
                np.log1p(gbbw),
                fw - 1.0,
                fh - 1.0,
            ],
            axis=1,
        )
        self._feat_cache.put(pool, feats)
        return feats

    def evaluate_batch(self, pool) -> tuple[np.ndarray, np.ndarray]:
        """Scalar evaluation per config (each is a full inner software search;
        only the BO warmup calls this, on a handful of points).  When a
        `prefetch_fn` is injected, the whole pool is handed to it first --
        the probe-fanout strategy fans the pool's inner searches out as one
        stacked multi-run program, and the loop below hits its cache."""
        if self.prefetch_fn is not None:
            self.prefetch_fn(list(pool))
        vals = np.full(len(pool), -np.inf)
        feas = np.zeros(len(pool), dtype=bool)
        for i, hw in enumerate(pool):
            v, ok = self.evaluate(hw)
            feas[i] = ok
            if ok:
                vals[i] = v
        return vals, feas
