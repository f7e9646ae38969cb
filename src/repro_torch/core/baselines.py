"""Search baselines from the paper's evaluation (§5.1 Baselines).

* constrained random search -- "repeatedly takes the first random sample in the
  design space that satisfies the constraints".
* relax-and-round BO        -- out-of-the-box BO in a continuous unit cube,
  rounded to the nearest valid discrete design point.
* TVM-style learned search  -- a gradient-boosted-trees cost model (XGBoost
  analogue) trained online, with epsilon-greedy batched candidate selection,
  mirroring Chen et al. (2018).

The searches are the reference's (`repro.core.baselines`), draw for draw.  On
a space with the batched protocol (`SoftwareSpace`), every evaluation and
featurization goes through it: one forward of the cost model per evaluated
point, and one per TVM candidate pool -- on `backend="torch"` that is kernel
K1b on the space's device.  A point's value is -log10 of that forward's EDP
taken on the host, as the reference's scalar `evaluate` takes it: the EDP
is the same bits on the card and the CPU, a device log10 is not, and the
TVM search's boosted trees turn a last-bit difference in the values into
another split.  relax-and-round's GP runs on the space's device.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.bo import BOResult
from repro_torch.core.gp import GP
from repro_torch.core.trees import GradientBoostedTrees
from repro_torch.timeloop.batch import pack
from repro_torch.timeloop.mapping import LEVELS, Mapping, _prod
from repro_torch.timeloop.workloads import DIMS, divisors


def _observe(space, p) -> tuple[float | None, bool, np.ndarray | None]:
    """(utility, feasible, features) of one point: through the batched
    protocol where the space has it (a one-row pool, one forward), else the
    scalar `evaluate`; features only from the batched forward (None
    otherwise: the caller featurizes)."""
    if not getattr(space, "supports_batch", False):
        value, feasible = space.evaluate(p)
        return value, feasible, None
    pool = pack([p])
    edp, valid = space.edp_batch(pool)
    feats = space.features_batch(pool)[0]
    if not bool(valid[0]):
        return None, False, feats
    return -float(np.log10(edp[0])), True, feats


def _pool_features(space, pool: list) -> np.ndarray:
    if getattr(space, "supports_batch", False):
        return space.features_batch(pack(pool))
    return np.stack([space.features(p) for p in pool])


def random_search(space, n_trials: int = 250, seed: int = 0) -> BOResult:
    rng = np.random.default_rng(seed)
    result = BOResult(None, -np.inf, [], [], [])
    for _ in range(n_trials):
        p = space.sample(rng)
        for _ in range(100_000):  # first sample satisfying the known constraints
            if space.is_valid(p):
                break
            p = space.sample(rng)
        value, feasible, _ = _observe(space, p)
        result.points.append(p)
        if feasible and value > result.best_value:
            result.best_value, result.best_point = value, p
        result.values.append(value if feasible else -np.inf)
        if not feasible:
            result.n_infeasible += 1
        result.history.append(result.best_value)
    return result


def tvm_style_search(
    space, n_trials: int = 250, n_warmup: int = 30, pool_size: int = 150,
    epsilon: float = 0.1, seed: int = 0,
) -> BOResult:
    """Learned-cost-model search: GBT regressor ranks a candidate pool; with
    probability epsilon explore randomly (TVM's exploration knob)."""
    rng = np.random.default_rng(seed)
    result = BOResult(None, -np.inf, [], [], [])
    X, y = [], []

    def observe(p):
        value, feasible, feats = _observe(space, p)
        result.points.append(p)
        if feasible:
            X.append(feats if feats is not None else space.features(p))
            y.append(value)
            if value > result.best_value:
                result.best_value, result.best_point = value, p
            result.values.append(value)
        else:
            result.n_infeasible += 1
            result.values.append(-np.inf)
        result.history.append(result.best_value)

    def sample_valid():
        while True:
            p = space.sample(rng)
            if space.is_valid(p):
                return p

    for _ in range(min(n_warmup, n_trials)):
        observe(sample_valid())
    model = None
    for t in range(len(result.history), n_trials):
        if len(y) >= 4:
            model = GradientBoostedTrees(seed=seed).fit(np.stack(X), np.asarray(y))
        if model is None or rng.random() < epsilon:
            observe(sample_valid())
            continue
        pool = [sample_valid() for _ in range(pool_size)]
        preds = model.predict(_pool_features(space, pool))
        observe(pool[int(np.argmax(preds))])
    return result


# --- relax-and-round BO ------------------------------------------------------


def _round_mapping(u: np.ndarray, space) -> Mapping:
    """Decode a continuous point in [0,1]^D to the nearest *valid* mapping
    (the paper's relax-and-round baseline): each dim's factor chain is picked
    by rounding into the capacity-admissible divisor lists (nearest-valid
    repair); loop orders come from argsorting continuous keys."""
    layer, hw = space.layer, space.hw
    idx = 0
    per_level = {lvl: [1] * len(DIMS) for lvl in LEVELS}

    def lb_ok(fl):
        r, s, p, q, c, k = fl
        return (r * s * c * k <= hw.lb_weight
                and layer.input_extent(p, r) * layer.input_extent(q, s) * c <= hw.lb_input
                and p * q * k <= hw.lb_output)

    for di, d in enumerate(DIMS):
        rem = layer.dim(d)
        for lvl in ("lb", "sx", "sy", "gb"):
            ds = divisors(rem)
            if lvl == "lb":
                cands = []
                for f in ds:
                    trial = list(per_level["lb"])
                    trial[di] = f
                    if lb_ok(trial):
                        cands.append(f)
                ds = cands or [1]
            elif lvl == "sx":
                cap = hw.pe_mesh_x // _prod(per_level["sx"])
                ds = [f for f in ds if f <= cap] or [1]
            elif lvl == "sy":
                cap = hw.pe_mesh_y // _prod(per_level["sy"])
                ds = [f for f in ds if f <= cap] or [1]
            f = ds[min(int(u[idx] * len(ds)), len(ds) - 1)]
            per_level[lvl][di] = f
            rem //= f
            idx += 1
        per_level["dram"][di] = rem
    orders = []
    for _ in range(3):
        keys = u[idx : idx + len(DIMS)]
        orders.append(tuple(DIMS[i] for i in np.argsort(keys)))
        idx += len(DIMS)
    return Mapping(
        factors=tuple(tuple(per_level[lvl]) for lvl in LEVELS),
        order_lb=orders[0],
        order_gb=orders[1],
        order_dram=orders[2],
    )


def relax_round_bo(
    space, n_trials: int = 250, n_warmup: int = 30, pool_size: int = 150,
    lam: float = 1.0, seed: int = 0,
) -> BOResult:
    """Out-of-the-box BO baseline: SE-kernel GP over the continuous relaxation,
    LCB acquisition over a random continuous pool, round to valid parameters.
    Infeasible rounded points score a large penalty (the standard treatment).
    The GP runs on the space's device ("cuda" for a space without one)."""
    device = getattr(space, "device", "cuda")
    rng = np.random.default_rng(seed)
    dim = 4 * len(DIMS) + 3 * len(DIMS)
    result = BOResult(None, -np.inf, [], [], [])
    U, y = [], []
    PENALTY = None

    def observe(u):
        nonlocal PENALTY
        m = _round_mapping(u, space)
        value, feasible, _ = _observe(space, m)
        result.points.append(m)
        if feasible:
            if value > result.best_value:
                result.best_value, result.best_point = value, m
            result.values.append(value)
            if PENALTY is None or value - 2.0 < PENALTY:
                PENALTY = value - 2.0
        else:
            result.n_infeasible += 1
            result.values.append(-np.inf)
        U.append(u)
        y.append(value if feasible else np.nan)
        result.history.append(result.best_value)

    for _ in range(min(n_warmup, n_trials)):
        observe(rng.random(dim))
    for _ in range(len(result.history), n_trials):
        yy = np.asarray(y, dtype=np.float64)
        fill = PENALTY if PENALTY is not None else -20.0
        yy = np.where(np.isnan(yy), fill, yy)
        gp = GP(kind="se", noisy=True, device=device).fit(np.stack(U), yy)
        pool = rng.random((pool_size, dim))
        mu, var = gp.posterior(pool)
        observe(pool[int(np.argmax(mu + lam * np.sqrt(var)))])
    return result
