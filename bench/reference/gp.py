"""A plain NumPy float64 Gaussian process: the semantics the search's GP
surrogates state, worked out again from the data they were handed.

Kernels: linear on explicit features with a learned scale per feature and a
bias, or squared-exponential with one lengthscale; an additive noise term
with a fixed jitter.  Hyperparameters live in log space and start from the
stated initial point (scales 1, the mean at the data's mean, the noise at a
tenth of the data's spread, or pinned at exp(-6) for a deterministic
evaluator); they are fit by Adam on the negative marginal log-likelihood:
80 steps, rate 0.05, betas 0.9 and 0.999, epsilon 1e-8 outside the square
root.  The gradient is the closed form 0.5 tr((K^-1 - a a^T) dK), a = K^-1 r.

Imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np

JITTER = 1e-6
STEPS = 80
LR = 0.05
BETA1, BETA2, EPS = 0.9, 0.999, 1e-8
PINNED_LOG_TAU = -6.0


def _kernel(kind: str, p: dict, x1: np.ndarray, x2: np.ndarray):
    """k(x1, x2) and, for the gradient, its parts."""
    if kind == "linear":
        w = np.exp(p["log_w"])
        return (x1 * w) @ (x2 * w).T + math.exp(p["log_bias"]) ** 2
    d2 = ((x1[:, None, :] - x2[None, :, :]) ** 2).sum(axis=-1)
    return (math.exp(p["log_alpha"]) ** 2
            * np.exp(-d2 / math.exp(p["log_ell"]) ** 2))


def _diag(kind: str, p: dict, xs: np.ndarray) -> np.ndarray:
    if kind == "linear":
        v = xs * np.exp(p["log_w"])
        return (v * v).sum(axis=1) + math.exp(p["log_bias"]) ** 2
    return np.full(len(xs), math.exp(p["log_alpha"]) ** 2)


def _solve_lower(L: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.linalg.solve(L, b)


def _factor(kind: str, p: dict, X: np.ndarray):
    noise = math.exp(2.0 * p["log_tau"])
    K = _kernel(kind, p, X, X) + np.eye(len(X)) * (noise + JITTER)
    return K, np.linalg.cholesky(K)


def nll_and_grad(kind: str, p: dict, X: np.ndarray, y: np.ndarray):
    """The negative marginal log-likelihood and its gradient in every
    hyperparameter."""
    n = len(y)
    K, L = _factor(kind, p, X)
    r = y - p["mean_const"]
    Linv = _solve_lower(L, np.eye(n))
    Kinv = Linv.T @ Linv
    a = Kinv @ r
    nll = 0.5 * (r @ a + 2.0 * np.log(np.diag(L)).sum()
                 + n * math.log(2.0 * math.pi))
    W = Kinv - np.outer(a, a)
    g = {"mean_const": -a.sum(),
         "log_tau": math.exp(2.0 * p["log_tau"]) * np.trace(W)}
    if kind == "linear":
        w2 = np.exp(2.0 * p["log_w"])
        g["log_w"] = w2 * np.einsum("ij,ik,kj->j", X, W, X)
        g["log_bias"] = math.exp(2.0 * p["log_bias"]) * W.sum()
    else:
        d2 = ((X[:, None, :] - X[None, :, :]) ** 2).sum(axis=-1)
        Kse = K - np.eye(n) * (math.exp(2.0 * p["log_tau"]) + JITTER)
        g["log_alpha"] = (W * Kse).sum()
        g["log_ell"] = (W * Kse * d2).sum() / math.exp(p["log_ell"]) ** 2
    return nll, g


def init(kind: str, noisy: bool, X, y) -> dict:
    """The stated initial point of the fit for data (X, y)."""
    X = np.asarray(X, np.float64)
    y = np.asarray(y, np.float64)
    p = ({"log_w": np.zeros(X.shape[1]), "log_bias": 0.0} if kind == "linear"
         else {"log_alpha": 0.0, "log_ell": 0.0})
    p["mean_const"] = float(y.mean())
    p["log_tau"] = (math.log(max(float(y.std()), 1e-3) * 0.1) if noisy
                    else PINNED_LOG_TAU)
    return p


def fit(kind: str, noisy: bool, X, y, steps: int = STEPS) -> dict:
    """The fitted hyperparameters for data (X, y)."""
    X = np.asarray(X, np.float64)
    y = np.asarray(y, np.float64)
    p = init(kind, noisy, X, y)
    m = {k: np.zeros_like(np.asarray(v)) for k, v in p.items()}
    v = {k: np.zeros_like(np.asarray(v)) for k, v in p.items()}
    for t in range(1, steps + 1):
        _, g = nll_and_grad(kind, p, X, y)
        if not noisy:
            g["log_tau"] = 0.0
        for k in p:
            m[k] = BETA1 * m[k] + (1 - BETA1) * g[k]
            v[k] = BETA2 * v[k] + (1 - BETA2) * g[k] * g[k]
            mh = m[k] / (1 - BETA1 ** t)
            vh = v[k] / (1 - BETA2 ** t)
            p[k] = p[k] - LR * mh / (np.sqrt(vh) + EPS)
    return p


def posterior(kind: str, p: dict, X, y, Xs) -> tuple[np.ndarray, np.ndarray]:
    """Posterior mean and variance (floored at 1e-10) over the rows of Xs."""
    X = np.asarray(X, np.float64)
    Xs = np.asarray(Xs, np.float64)
    _, L = _factor(kind, p, X)
    r = np.asarray(y, np.float64) - p["mean_const"]
    a = _solve_lower(L.T, _solve_lower(L, r))
    Ks = _kernel(kind, p, Xs, X)
    mu = Ks @ a + p["mean_const"]
    v = _solve_lower(L, Ks.T)
    var = np.maximum(_diag(kind, p, Xs) - (v * v).sum(axis=0), 1e-10)
    return mu, var


def acquisition(name: str, mu, var, best: float, lam: float):
    """The maximised acquisition: mu + lam sigma (the paper's LCB in the
    maximising convention), or expected improvement over `best`."""
    sigma = np.sqrt(var)
    if name == "lcb":
        return mu + lam * sigma
    z = (mu - best) / np.maximum(sigma, 1e-12)
    cdf = 0.5 * (1.0 + np.vectorize(math.erf)(z / math.sqrt(2.0)))
    pdf = np.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)
    return (mu - best) * cdf + sigma * pdf
