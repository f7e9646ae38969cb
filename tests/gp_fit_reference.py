"""K4's algorithm in plain PyTorch: what `csrc/gp_fit.cu` computes, step for
step, on any device.

`gp_fit_ref` fits each run of a stack on its real rows by `_fit`'s Adam with
the NLL's gradient in closed form (the same forms as the kernel: Cholesky
with L^-1 [X, 1] for the linear kernel, Woodbury for a stacked linear fit
over the switch, K^-1 = Z^T Z for SE).  The CPU tests
(`test_torch_gp_fit_kernel.py`) hold it against the autograd fit and the JAX
reference's fits; on the card, the tests and `chip_smoke.py` hold K4 against
it on the same operands.

Not a test module: pytest collects `test_*.py` only.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.gp import _JITTER
from repro_torch.kernels.gp_fit import bias_corrections, layout

_F64 = torch.float64


def _nan_like(p: dict) -> dict:
    return {k: torch.full_like(v, math.nan) for k, v in p.items()}


def _grads(p, X, y, kind, lowrank):
    """Closed-form NLL gradient of one run on its n real rows (X (n, d),
    y (n,)); NaN everywhere where the factor fails."""
    n = X.shape[0]
    noise = torch.exp(2.0 * p["log_tau"])
    r = y - p["mean_const"]
    if kind == "linear":
        w = torch.exp(p["log_w"])
        b = torch.exp(p["log_bias"])
    if lowrank:
        # V^T alpha = A^-1 V^T r / D (= sol) and v_j^T K^-1 v_j = (I - A^-1)_jj
        # = (G - G A^-1 G)_jj, each form of the latter taken where its
        # subtraction is of small terms.
        dg = noise + _JITTER
        V = torch.cat([X * w, b.expand(n, 1)], dim=1)
        G = (V.T @ V) / dg
        eye = torch.eye(V.shape[1], dtype=_F64, device=X.device)
        La, info = torch.linalg.cholesky_ex(eye + G)
        if int(info):
            return _nan_like(p)
        Li = torch.linalg.solve_triangular(La, eye, upper=False)
        sol = Li.T @ (Li @ ((V.T @ r) / dg))
        S = Li @ G
        gd = torch.diagonal(G)
        h = torch.where(gd >= 1.0, 1.0 - (Li * Li).sum(dim=0),
                        gd - (S * S).sum(dim=0))
        gv = h - sol * sol
        alpha = (r - V @ sol) / dg
        tr_kinv = (n - (Li * S).sum()) / dg
        return {"log_w": gv[:-1], "log_bias": gv[-1],
                "log_tau": noise * (tr_kinv - alpha @ alpha),
                "mean_const": -sol[-1] / b}
    if kind == "se":
        a2 = torch.exp(p["log_alpha"]) ** 2
        ell2 = torch.exp(p["log_ell"]) ** 2
        d2 = ((X[:, None, :] - X[None, :, :]) ** 2).sum(dim=-1)
        kern = a2 * torch.exp(-d2 / ell2)
    else:
        V = X * w
        kern = V @ V.T + b * b
    eye = torch.eye(n, dtype=_F64, device=X.device)
    Lc, info = torch.linalg.cholesky_ex(kern + (noise + _JITTER) * eye)
    if int(info):
        return _nan_like(p)
    Z = torch.linalg.solve_triangular(Lc, eye, upper=False)
    q = Z @ r
    alpha = Z.T @ q
    if kind == "se":
        W = Z.T @ Z - alpha[:, None] * alpha[None, :]
        return {"log_alpha": (W * kern).sum(),
                "log_ell": (W * kern * d2).sum() / ell2,
                "log_tau": noise * torch.trace(W), "mean_const": -alpha.sum()}
    # x^T K^-1 x' = (L^-1 x)^T (L^-1 x'): never K^-1 itself, whose entries
    # reach 1 / noise while these products stay of order one.
    Y = Z @ torch.cat([X, torch.ones_like(X[:, :1])], dim=1)
    s1 = (Y * Y).sum(dim=0)
    s2 = Y.T @ q
    gv = s1 - s2 * s2
    return {"log_w": w * w * gv[:-1], "log_bias": b * b * gv[-1],
            "log_tau": noise * ((Z * Z).sum() - alpha @ alpha),
            "mean_const": -s2[-1]}


def gp_fit_ref(params, X, y, mask, kind, steps=80, lr=0.05, train_tau=True,
               lowrank=False) -> dict:
    """K4's algorithm in plain PyTorch: each run on its real rows, the
    closed-form gradient, `_fit`'s Adam.  Arguments and result as `_fit`'s
    (params (L,)- or (L, d)-leaved, X (L, b, d), y and mask (L, b))."""
    keys = [k for k, _ in layout(kind, X.shape[-1])]
    bc = bias_corrections(steps)
    out = {k: params[k].detach().to(_F64).clone() for k in keys}
    for run in range(X.shape[0]):
        n = int((mask[run] > 0.5).sum())
        Xr, yr = X[run, :n], y[run, :n]
        p = {k: out[k][run].clone() for k in keys}
        m = {k: torch.zeros_like(p[k]) for k in keys}
        v = {k: torch.zeros_like(p[k]) for k in keys}
        for t in range(steps):
            g = _grads(p, Xr, yr, kind, lowrank)
            if not train_tau:
                g["log_tau"] = torch.zeros_like(g["log_tau"])
            for k in keys:
                m[k] = 0.9 * m[k] + 0.1 * g[k]
                v[k] = 0.999 * v[k] + 0.001 * g[k] * g[k]
                mh = m[k] / bc[t]
                vh = v[k] / bc[steps + t]
                p[k] = p[k] - lr * mh / (torch.sqrt(vh) + 1e-8)
        for k in keys:
            out[k][run] = p[k]
    return out
