"""Exact Gaussian processes in PyTorch (paper §3.2).

Kernels: squared-exponential (scalar lengthscale) and linear-on-features, plus
an additive noise kernel.  Hyperparameters live in log space in a plain dict
of tensors and are fit by full-batch Adam on the negative marginal
log-likelihood.  Datasets are tiny (<= a few hundred rows); X/y are padded to
bucketed sizes with masked-out rows, exactly as the reference pads them, so
the fitted state and every solve match it row for row.

Every function here works on a leading *run* axis: a single `GP` is a stack
of one, and `GPStack` / `GPClassifierStack` fit and query L independent GPs
as one batched program (batched `torch.linalg` Cholesky factors and solves,
one Adam loop whose elementwise updates act on every run at once).  Padding
is exactly zero-influence (masked kernel rows make the padded block of the
Cholesky factor decouple: alpha is exactly 0 on padded rows, and the NLL
masks their logdet terms), so each slice of a stack reproduces the
corresponding individual `GP` fit regardless of how runs are padded to the
shared bucket.

A Cholesky factor that fails (matrix not positive definite) is NaN, as in
the reference, not an exception: `torch.linalg.cholesky_ex` reports the
failure without a host synchronisation and the factor is masked to NaN.

All GP arithmetic is float64 on `device` ("cuda" unless the caller asks for
"cpu").  On the card a fit inside K4's caps with no early exit runs as one
launch of the hand-written kernel (`kernels.gp_fit`, same objective, same
Adam, gradient in closed form); every other fit, and every fit on the CPU,
runs the eager `_fit` (`kernels.gp_fit.fit_path` decides, and the `gp.fit`
span's `path` says which ran).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from scipy.special import erf as _erf

from repro_torch import trace
from repro_torch.device import resolve_device

_JITTER = 1e-6
_PAD_NOISE = 1e6  # effective infinite noise on padded rows -> zero influence
# Stacked linear-kernel fits switch to the O(n d^2) Woodbury NLL above this
# many (padded) data rows; below it the O(n^3) Cholesky NLL is cheap and keeps
# the stacked fit bit-identical to the sequential one (see `_fit_stack`).
_LOWRANK_MIN_ROWS = 32
_F64 = torch.float64


def _k4():
    """The K4 module, imported at the first fit: importing `repro_torch.
    kernels` loads the cost model's kernels too, which a spec unpickled in a
    spawned worker must not."""
    from repro_torch.kernels import gp_fit

    return gp_fit


def _bucket(n: int) -> int:
    b = 8
    while b < n:
        b *= 2
    return b


def _col(v):
    """(L,) per-run scalar -> (L, 1, 1) for broadcasting against matrices."""
    return v[:, None, None]


def se_kernel(params, x1, x2):
    """Squared exponential with scalar lengthscale (paper's constraint GP).
    x1 (L, n, d), x2 (L, m, d) -> (L, n, m)."""
    alpha = torch.exp(params["log_alpha"])
    ell = torch.exp(params["log_ell"])
    d2 = ((x1[:, :, None, :] - x2[:, None, :, :]) ** 2).sum(dim=-1)
    return _col(alpha) ** 2 * torch.exp(-d2 / (_col(ell) ** 2))


def linear_kernel(params, x1, x2):
    """Linear kernel on explicit features with learned per-feature scales
    (paper §3.2: "a linear kernel on top of explicit features")."""
    w = torch.exp(params["log_w"])[:, None, :]
    return (x1 * w) @ (x2 * w).transpose(-1, -2) + _col(
        torch.exp(params["log_bias"])) ** 2


KERNELS = {"se": se_kernel, "linear": linear_kernel}


def _kernel_diag(params, Xs, kind):
    """k(x, x) for every row of Xs (L, P, d) -> (L, P): the diagonal the
    reference computes as k(params, x[None], x[None])[0, 0] per row."""
    if kind == "se":
        d2 = ((Xs - Xs) ** 2).sum(dim=-1)
        return (torch.exp(params["log_alpha"])[:, None] ** 2
                * torch.exp(-d2 / (torch.exp(params["log_ell"])[:, None] ** 2)))
    v = Xs * torch.exp(params["log_w"])[:, None, :]
    return ((v[..., None, :] @ v[..., :, None])[..., 0, 0]
            + torch.exp(params["log_bias"])[:, None] ** 2)


def _init_params(kind: str, L: int, dim: int, device) -> dict:
    z = torch.zeros((L,), dtype=_F64, device=device)
    if kind == "se":
        return {"log_alpha": z.clone(), "log_ell": z.clone()}
    if kind == "linear":
        return {"log_w": torch.zeros((L, dim), dtype=_F64, device=device),
                "log_bias": z.clone()}
    raise ValueError(kind)


def cholesky(K):
    """Lower Cholesky factor; NaN where the factor fails (the reference's
    convention), with no host synchronisation."""
    L, info = torch.linalg.cholesky_ex(K)
    return torch.where((info > 0)[..., None, None], torch.nan, L)


def _masked_kernel(params, X, mask, kind):
    noise = torch.exp(2.0 * params["log_tau"])
    diag = torch.where(mask > 0.5, noise[:, None] + _JITTER, _PAD_NOISE)
    K = (KERNELS[kind](params, X, X) * (mask[:, :, None] * mask[:, None, :])
         + torch.diag_embed(diag))
    return K, diag


def _nll(params, X, y, mask, kind):
    """(L,) negative marginal log-likelihoods, Cholesky form."""
    K, _ = _masked_kernel(params, X, mask, kind)
    c = params["mean_const"]
    r = torch.where(mask > 0.5, y - c[:, None], 0.0)
    L = cholesky(K)
    alpha = torch.cholesky_solve(r[..., None], L)[..., 0]
    quad = (r[..., None, :] @ alpha[..., :, None])[..., 0, 0]
    logdet = 2.0 * torch.where(
        mask > 0.5, torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), 0.0
    ).sum(dim=-1)
    n_eff = mask.sum(dim=-1)
    return 0.5 * (quad + logdet + n_eff * math.log(2.0 * math.pi))


def _nll_linear_lowrank(params, X, y, mask):
    """`_nll(kind="linear")` via Woodbury -- same value, O(n d^2) not O(n^3).

    The linear kernel is rank d+1: K = (M V0)(M V0)^T + bias^2 (M 1)(M 1)^T
    + D with V0 = X * w, M = diag(mask), D the masked noise/pad diagonal.
    With V = M [V0, bias 1] (n, d+1) and A = I + V^T D^-1 V:

      quad            r^T K^-1 r = r^T D^-1 r - u^T A^-1 u,  u = V^T D^-1 r
      masked logdet   sum_masked log D_ii + logdet A

    (pad rows have V = 0 and r = 0, so they drop out of both terms exactly,
    matching the masked Cholesky logdet of `_nll`)."""
    Lr, n, _ = X.shape
    noise = torch.exp(2.0 * params["log_tau"])
    diag = torch.where(mask > 0.5, noise[:, None] + _JITTER, _PAD_NOISE)
    w = torch.exp(params["log_w"])[:, None, :]
    bias = torch.exp(params["log_bias"])[:, None, None].expand(Lr, n, 1)
    V = torch.cat([X * w, bias], dim=-1) * mask[..., None]
    r = torch.where(mask > 0.5, y - params["mean_const"][:, None], 0.0)
    Vd = V / diag[..., None]
    A = (torch.eye(V.shape[-1], dtype=X.dtype, device=X.device)
         + V.transpose(-1, -2) @ Vd)
    La = cholesky(A)
    u = (Vd.transpose(-1, -2) @ r[..., None])[..., 0]
    sol = torch.cholesky_solve(u[..., None], La)[..., 0]
    quad = (((r / diag)[..., None, :] @ r[..., :, None])[..., 0, 0]
            - (u[..., None, :] @ sol[..., :, None])[..., 0, 0])
    logdet = (torch.where(mask > 0.5, torch.log(diag), 0.0).sum(dim=-1)
              + 2.0 * torch.log(torch.diagonal(La, dim1=-2, dim2=-1)).sum(dim=-1))
    n_eff = mask.sum(dim=-1)
    return 0.5 * (quad + logdet + n_eff * math.log(2.0 * math.pi))


def _fit(params, X, y, mask, kind, steps=80, lr=0.05, train_tau=True,
         lowrank=False, tol=0.0) -> dict:
    """Adam on the NLL, written out by hand (not `torch.optim.Adam`, whose
    epsilon placement and update rounding differ from the reference): 80
    steps, betas 0.9/0.999, eps 1e-8 outside the square root, step count `t`
    as a float.  Every tensor carries the leading run axis; the runs are
    independent, so the gradient of the summed NLL is each run's own.

    lowrank: optimize the Woodbury form of the linear-kernel NLL (same
    function to f64 roundoff, O(n d^2) per step) -- the stacked multi-run fit
    uses it above `_LOWRANK_MIN_ROWS`.  tol > 0: stop once the global
    gradient norm of the step just applied drops below `tol` (a host loop)."""
    if lowrank and kind != "linear":
        raise ValueError("lowrank NLL exists for the linear kernel")
    keys = sorted(params)
    p = {k: params[k].detach().clone().requires_grad_(True) for k in keys}
    m = {k: torch.zeros_like(p[k]) for k in keys}
    v = {k: torch.zeros_like(p[k]) for k in keys}
    t = 0.0
    for _ in range(steps):
        nll = (_nll_linear_lowrank(p, X, y, mask) if lowrank
               else _nll(p, X, y, mask, kind))
        grads = dict(zip(keys, torch.autograd.grad(nll.sum(),
                                                   [p[k] for k in keys])))
        if not train_tau:
            # Deterministic evaluator: the noise level is pinned, so it is
            # excluded from the update entirely.
            grads["log_tau"] = torch.zeros_like(grads["log_tau"])
        if tol > 0.0:
            gn = math.sqrt(sum(float((g ** 2).sum()) for g in grads.values()))
        t = t + 1
        bc1 = 1 - 0.9 ** t
        bc2 = 1 - 0.999 ** t
        with torch.no_grad():
            for k in keys:
                g = grads[k]
                m[k] = 0.9 * m[k] + 0.1 * g
                v[k] = 0.999 * v[k] + 0.001 * g * g
                mh = m[k] / bc1
                vh = v[k] / bc2
                # In place on the leaf: the same value as p - update.
                p[k].sub_(lr * mh / (torch.sqrt(vh) + 1e-8))
        if tol > 0.0 and gn < tol:
            break
    return {k: p[k].detach() for k in keys}


def _posterior(params, X, y, mask, Xs, kind, L=None):
    """(mu, var), each (L, P), for the stacked candidate pools Xs (L, P, d).
    `L`: a precomputed Cholesky factor of the masked kernel matrix (the
    incremental path); None refactorizes."""
    if L is None:
        L = cholesky(_masked_kernel(params, X, mask, kind)[0])
    c = params["mean_const"]
    r = torch.where(mask > 0.5, y - c[:, None], 0.0)
    alpha = torch.cholesky_solve(r[..., None], L)
    Ks = KERNELS[kind](params, Xs, X) * mask[:, None, :]
    mu = (Ks @ alpha)[..., 0] + c[:, None]
    v = torch.linalg.solve_triangular(L, Ks.transpose(-1, -2), upper=False)
    kss = _kernel_diag(params, Xs, kind)
    var = torch.clamp(kss - (v ** 2).sum(dim=-2), min=1e-10)
    return mu, var


def _append_row(params, L, X, y, mask, n, x, val, kind):
    """Rank-1 border update of a single GP (run axis of 1): append one
    observation into the first padded slot `n`, updating the cached factor in
    O(n^2).  Returns new (L, X, y, mask) tensors."""
    k = KERNELS[kind]
    kv = k(params, X, x[None, None, :])[..., 0] * mask  # zero on padded rows
    w = torch.linalg.solve_triangular(L, kv[..., None], upper=False)[..., 0]
    noise = torch.exp(2.0 * params["log_tau"])
    xx = x[None, None, :]
    knn = k(params, xx, xx)[:, 0, 0] + noise + _JITTER
    row = w.clone()
    row[:, n] = torch.sqrt(knn - (w[:, None, :] @ w[:, :, None])[:, 0, 0])
    L, X, y, mask = L.clone(), X.clone(), y.clone(), mask.clone()
    L[:, n, :] = row
    X[:, n, :] = x
    y[:, n] = val
    mask[:, n] = 1.0
    return L, X, y, mask


def apply_prior_mean(mu, ms):
    """Add an externally supplied prior-mean offset `ms` to posterior means
    `mu` (variances are untouched).

    Residual prior-mean contract: the caller fits the GP on residuals
    y - m(x) and adds m back at query time via this helper."""
    return np.asarray(mu) + np.asarray(ms, dtype=np.float64)


def _probit(mu, var):
    """P(feasible) from the latent posterior (device twin of the scipy erf
    on the host paths)."""
    z = mu / torch.sqrt(1.0 + var)
    return 0.5 * (1.0 + torch.special.erf(z / math.sqrt(2.0)))


def _pad_one(X, y) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    X = np.asarray(X, np.float64)
    y = np.asarray(y, np.float64)
    n, d = X.shape
    b = _bucket(n)
    Xp = np.zeros((1, b, d))
    yp = np.zeros((1, b))
    mask = np.zeros((1, b))
    Xp[0, :n], yp[0, :n], mask[0, :n] = X, y, 1.0
    return Xp, yp, mask


def _to(dev, *arrays):
    return tuple(torch.as_tensor(a, dtype=_F64).to(dev) for a in arrays)


@dataclasses.dataclass
class GP:
    """Exact GP regressor.

    kind:        'se' or 'linear'
    noisy:       if False, the noise is pinned tiny (deterministic evaluator,
                 paper §4.3); if True it is a learned hyperparameter (paper §4.2).
    fit_tol:     gradient-norm early-exit tolerance for the hyperparameter fit
                 (0.0 = off: the fixed 80-step fit).
    device:      where the fitted state and every posterior live.

    The state is a stack of one: params leaves and data lead with a run axis
    of length 1 (see the module docstring).
    """

    kind: str = "linear"
    noisy: bool = True
    steps: int = 80
    fit_tol: float = 0.0
    device: str = "cuda"
    _state: tuple | None = None
    # Cached Cholesky factor of the data kernel matrix, maintained by
    # `append_observation` between aligned refits (None: every posterior
    # refactorizes).
    _fac: torch.Tensor | None = None

    def fit(self, X: np.ndarray, y: np.ndarray) -> "GP":
        with trace.span("gp.fit") as sp:
            dev = resolve_device(self.device)
            y = np.asarray(y, np.float64)
            Xp, yp, mask = _to(dev, *_pad_one(X, y))
            path = _k4().fit_path(dev, self.fit_tol, self.kind, False,
                                  len(y), Xp.shape[2], Xp.dtype)
            if sp:
                sp.set(runs=1, rows=Xp.shape[1], d=Xp.shape[2],
                       steps=self.steps, kind=self.kind, path=path)
            # K4 takes its initial parameters packed from the host.
            pdev = dev if path == "eager" else "cpu"
            params = _init_params(self.kind, 1, Xp.shape[-1], pdev)
            params["mean_const"] = torch.tensor([float(y.mean())],
                                                dtype=_F64, device=pdev)
            params["log_tau"] = torch.tensor(
                [np.log(max(y.std(), 1e-3) * 0.1) if self.noisy else -6.0],
                dtype=_F64, device=pdev)
            # With noisy=False the pinned log_tau is frozen *during* the fit
            # (zeroed gradient), so the remaining hyperparameters are trained
            # against the true fixed noise level.
            if path == "kernel":
                params = _k4().gp_fit(params, Xp, yp, mask, self.kind,
                                      self.steps, train_tau=self.noisy,
                                      rows=len(y))
            else:
                params = _fit(params, Xp, yp, mask, self.kind, self.steps,
                              train_tau=self.noisy, tol=self.fit_tol)
            self._state = (params, Xp, yp, mask)
            self._fac = None  # a full refit invalidates any incremental factor
        return self

    def posterior(self, Xs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        with trace.span("gp.score") as sp:
            if sp:
                sp.set(runs=1, pool=len(Xs))
            mu, var = self.posterior_device(Xs)
            return trace.host(mu), trace.host(var)

    def posterior_device(self, Xs) -> tuple[torch.Tensor, torch.Tensor]:
        """Posterior as device tensors -- lets the device-engine acquisition
        scoring stay device-resident (no host round-trip per BO trial).  With
        an incremental factor cached (`append_observation`), reuses it."""
        if self._state is None:
            raise RuntimeError("fit() first")
        with trace.span("gp.score") as sp:
            if sp:
                sp.set(runs=1, pool=len(Xs))
            params, Xp, yp, mask = self._state
            Xs = torch.as_tensor(Xs).to(device=Xp.device, dtype=_F64)
            mu, var = _posterior(params, Xp, yp, mask, Xs[None], self.kind,
                                 L=self._fac)
            return mu[0], var[0]

    def append_observation(self, x: np.ndarray, y: float) -> "GP":
        """Fold one observation into the posterior WITHOUT refitting
        hyperparameters: an O(n^2) rank-1 border update of the cached Cholesky
        factor (built lazily on first append).  Parity: matches `with_data`
        (frozen-hyperparameter refit from scratch) to <= 1e-8."""
        if self._state is None:
            raise RuntimeError("fit() first")
        with trace.span("gp.update") as sp:
            params, Xp, yp, mask = self._state
            n = int(trace.host(mask.sum()))
            b = Xp.shape[1]
            if n >= b:
                # Bucket overflow: repad to the next bucket (zero rows, as
                # padding trails) and refactorize -- O(n^3), but only at
                # power-of-two boundaries.
                grow = _bucket(n + 1) - b
                Xp = torch.nn.functional.pad(Xp, (0, 0, 0, grow))
                yp = torch.nn.functional.pad(yp, (0, grow))
                mask = torch.nn.functional.pad(mask, (0, grow))
                self._fac = None
            if sp:
                sp.set(rows=Xp.shape[1])
            if self._fac is None:
                self._fac = cholesky(
                    _masked_kernel(params, Xp, mask, self.kind)[0])
            x_t = torch.as_tensor(np.asarray(x, np.float64)).to(Xp.device)
            self._fac, Xp, yp, mask = _append_row(
                params, self._fac, Xp, yp, mask, n, x_t, float(y), self.kind)
            self._state = (params, Xp, yp, mask)
        return self

    def with_data(self, X: np.ndarray, y: np.ndarray) -> "GP":
        """A new GP with THIS model's (frozen) hyperparameters and the given
        dataset, state rebuilt from scratch -- the refit-from-scratch parity
        reference for `append_observation`."""
        if self._state is None:
            raise RuntimeError("fit() first")
        params = self._state[0]
        other = GP(kind=self.kind, noisy=self.noisy, steps=self.steps,
                   fit_tol=self.fit_tol, device=self.device)
        other._state = (params, *_to(self._state[1].device, *_pad_one(X, y)))
        return other

    @property
    def params(self):
        return self._state[0] if self._state else None


@dataclasses.dataclass
class GPClassifier:
    """GP "classifier" for unknown (output) constraints (paper §3.4): GP
    regression on +/-1 labels with a probit link on the latent posterior --
    the standard cheap approximation used in constrained BO."""

    steps: int = 80
    device: str = "cuda"
    _gp: GP | None = None

    def fit(self, X: np.ndarray, feasible: np.ndarray) -> "GPClassifier":
        y = np.where(np.asarray(feasible), 1.0, -1.0)
        self._gp = GP(kind="se", noisy=True, steps=self.steps,
                      device=self.device).fit(X, y)
        return self

    def prob_feasible(self, Xs: np.ndarray) -> np.ndarray:
        """Host-side P(feasible) as a plain NumPy array (scipy erf)."""
        with trace.span("gp.score") as sp:
            if sp:
                sp.set(runs=1, pool=len(Xs))
            if self._gp is None:
                return np.ones(len(Xs))
            mu, var = self._gp.posterior(Xs)
            z = mu / np.sqrt(1.0 + var)
            return 0.5 * (1.0 + _erf(z / np.sqrt(2.0)))

    def prob_feasible_device(self, Xs) -> torch.Tensor:
        """Device twin of `prob_feasible` for the fused scoring path
        (`torch.special.erf`; host and device probabilities agree to ~1e-16
        relative, far below anything the acquisition argmax resolves)."""
        with trace.span("gp.score") as sp:
            if sp:
                sp.set(runs=1, pool=len(Xs))
            if self._gp is None:
                return torch.ones(len(Xs), dtype=_F64,
                                  device=resolve_device(self.device))
            return _probit(*self._gp.posterior_device(Xs))


# --- stacked (multi-run) GPs ----------------------------------------------------

def _fit_stack(params, X, y, mask, kind, steps, train_tau):
    """Batched `_fit` over the leading run axis: one Adam loop, batched
    Cholesky factors and solves (not a loop per run).

    Above `_LOWRANK_MIN_ROWS` data rows the linear kernel (the objective
    surrogate) fits through the Woodbury NLL: it computes the same NLL to f64
    roundoff, but its gradients drift from the Cholesky path's by ~1e-8
    relative, which after 80 Adam steps perturbs the posterior at the ~1e-7
    level -- not the bit-identical-to-sequential regime the small buckets
    keep."""
    return _fit(params, X, y, mask, kind, steps, 0.05, train_tau,
                lowrank=_stack_lowrank(kind, X.shape[1]))


def _stack_lowrank(kind: str, rows: int) -> bool:
    """Whether a stacked fit of `rows` padded rows takes the Woodbury NLL."""
    return kind == "linear" and rows > _LOWRANK_MIN_ROWS


def _bucket_stack(n: int) -> int:
    """Finer-grained buckets for the stacked fit: multiples of 8 up to 64
    rows, multiples of 32 beyond (padding rows are exactly zero-influence,
    so the bucket choice cannot change results)."""
    if n <= 8:
        return 8
    step = 8 if n <= 64 else 32
    return -(-n // step) * step


def _pad_runs(Xs, ys) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stack ragged per-run datasets to (L, b, d)/(L, b) with (L, b) masks,
    b = shared fine-grained bucket over the largest run."""
    L = len(Xs)
    d = Xs[0].shape[1]
    b = _bucket_stack(max(len(y) for y in ys))
    X = np.zeros((L, b, d))
    y = np.zeros((L, b))
    mask = np.zeros((L, b))
    for k, (Xk, yk) in enumerate(zip(Xs, ys)):
        n = len(yk)
        X[k, :n], y[k, :n], mask[k, :n] = Xk, yk, 1.0
    return X, y, mask


def _score_stack(params, X, y, mask, feats, best, kind, acq_fn):
    """Fused multi-run pool scoring: stacked posterior + acquisition + per-run
    argmax + winner-row gather.  The acquisition is the
    `make_acquisition_device` closure itself, so the fused path computes
    exactly what the op-by-op paths compute."""
    mu, var = _posterior(params, X, y, mask, feats, kind)
    util = acq_fn(mu, var, best)
    idx = torch.argmax(util, dim=1)
    rows = torch.take_along_dim(feats, idx[:, None, None], dim=1)[:, 0, :]
    return idx, rows


@dataclasses.dataclass
class GPStack:
    """L independent exact GP regressors, fit and queried as one batched
    program.  Per-slice numerics match the individual `GP` (the same
    functions; padding is exactly zero-influence), so a stacked multi-run BO
    engine reproduces L sequential runs.

    kind / noisy / steps / device: as on `GP`, shared across the stack.
    """

    kind: str = "linear"
    noisy: bool = True
    steps: int = 80
    device: str = "cuda"
    _state: tuple | None = None

    def fit(self, Xs, ys) -> "GPStack":
        """Fit from per-run datasets: Xs[k] is (n_k, d), ys[k] is (n_k,)."""
        with trace.span("gp.fit") as sp:
            dev = resolve_device(self.device)
            Xs = [np.asarray(Xk, np.float64) for Xk in Xs]
            ys = [np.asarray(yk, np.float64) for yk in ys]
            X, y, mask = _to(dev, *_pad_runs(Xs, ys))
            L, b, d = X.shape
            rows = max(len(yk) for yk in ys)
            lowrank = _stack_lowrank(self.kind, b)
            path = _k4().fit_path(dev, 0.0, self.kind, lowrank, rows, d,
                                  X.dtype)
            if sp:
                sp.set(runs=L, rows=b, d=d, steps=self.steps, kind=self.kind,
                       path=path)
            pdev = dev if path == "eager" else "cpu"
            params = _init_params(self.kind, L, d, pdev)
            params["mean_const"] = torch.tensor(
                [float(yk.mean()) for yk in ys], dtype=_F64, device=pdev)
            params["log_tau"] = torch.tensor(
                [np.log(max(yk.std(), 1e-3) * 0.1) for yk in ys]
                if self.noisy else [-6.0] * L, dtype=_F64, device=pdev)
            if path == "kernel":
                params = _k4().gp_fit(params, X, y, mask, self.kind,
                                      self.steps, train_tau=self.noisy,
                                      lowrank=lowrank, rows=rows)
            else:
                params = _fit_stack(params, X, y, mask, self.kind,
                                    self.steps, self.noisy)
            self._state = (params, X, y, mask)
        return self

    def __len__(self) -> int:
        return int(self._state[1].shape[0]) if self._state else 0

    def posterior(self, Xs) -> tuple[np.ndarray, np.ndarray]:
        with trace.span("gp.score") as sp:
            if sp:
                sp.set(runs=len(Xs), pool=np.shape(Xs)[1])
            mu, var = self.posterior_device(Xs)
            return trace.host(mu), trace.host(var)

    def posterior_device(self, Xs) -> tuple[torch.Tensor, torch.Tensor]:
        """Stacked posterior: Xs is (L, P, d) -- one candidate pool per run --
        returning (L, P) device tensors (the fused multi-run scoring path)."""
        if self._state is None:
            raise RuntimeError("fit() first")
        with trace.span("gp.score") as sp:
            params, Xp, yp, mask = self._state
            Xs = torch.as_tensor(Xs).to(device=Xp.device, dtype=_F64)
            if sp:
                sp.set(runs=Xs.shape[0], pool=Xs.shape[1])
            return _posterior(params, Xp, yp, mask, Xs, self.kind)

    def score_device(
        self, feats, best, acquisition: str = "lcb", lam: float = 1.0,
    ) -> tuple[np.ndarray, np.ndarray]:
        """One-dispatch pool scoring for the multi-run BO trial: stacked
        posterior, acquisition (vs per-run incumbents `best`, shape (L, 1)),
        per-run argmax, and the winners' feature rows -- only the (L,) indices
        and (L, d) rows return to the host."""
        from repro_torch.core.acquisition import make_acquisition_device

        if self._state is None:
            raise RuntimeError("fit() first")
        with trace.span("gp.score") as sp:
            if sp:
                sp.set(runs=len(feats), pool=np.shape(feats)[1])
            params, Xp, yp, mask = self._state
            idx, rows = _score_stack(
                params, Xp, yp, mask,
                torch.as_tensor(feats).to(device=Xp.device, dtype=_F64),
                torch.as_tensor(np.asarray(best, np.float64)).to(Xp.device),
                self.kind, make_acquisition_device(acquisition, lam))
            return trace.host(idx), trace.host(rows)


@dataclasses.dataclass
class GPClassifierStack:
    """Stacked twin of `GPClassifier`: L per-run feasibility classifiers
    (SE-kernel GP regression on +/-1 labels, probit link) fit as one batched
    program for the multi-run BO engine's unknown-constraint weighting."""

    steps: int = 80
    device: str = "cuda"
    _stack: GPStack | None = None

    def fit(self, Xs, feas) -> "GPClassifierStack":
        ys = [np.where(np.asarray(f), 1.0, -1.0) for f in feas]
        self._stack = GPStack(kind="se", noisy=True, steps=self.steps,
                              device=self.device).fit(Xs, ys)
        return self

    def prob_feasible(self, Xs) -> np.ndarray:
        """Host-side (L, P) P(feasible) -- NumPy + scipy erf, mirroring
        `GPClassifier.prob_feasible` exactly so the multi-run host scoring
        path picks the same candidates as L sequential runs."""
        if self._stack is None:
            raise RuntimeError("fit() first")
        with trace.span("gp.score") as sp:
            if sp:
                sp.set(runs=len(Xs), pool=np.shape(Xs)[1])
            mu, var = self._stack.posterior(Xs)
            z = mu / np.sqrt(1.0 + var)
            return 0.5 * (1.0 + _erf(z / np.sqrt(2.0)))

    def prob_feasible_device(self, Xs) -> torch.Tensor:
        """(L, P) P(feasible) as device tensors."""
        if self._stack is None:
            raise RuntimeError("fit() first")
        with trace.span("gp.score") as sp:
            if sp:
                sp.set(runs=len(Xs), pool=np.shape(Xs)[1])
            return _probit(*self._stack.posterior_device(Xs))
