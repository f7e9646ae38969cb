"""Acquisition functions (paper §3.3) in the *maximization* convention.

The optimizer maximizes utility = normalized reciprocal EDP (equivalently we fit
the GP on -log EDP).  LCB here follows the paper's formula a = mu + lambda*sigma
(an upper bound in maximize convention; the paper keeps the LCB name).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _norm_pdf(z):
    return np.exp(-0.5 * z * z) / np.sqrt(2.0 * np.pi)


def _norm_cdf(z):
    # Standard normal CDF: Phi(z) = (1 + erf(z / sqrt(2))) / 2.
    from scipy.special import erf

    z = np.asarray(z, dtype=np.float64)
    return 0.5 * (1.0 + erf(z / np.sqrt(2.0)))


def expected_improvement(mu: np.ndarray, var: np.ndarray, best: float) -> np.ndarray:
    sigma = np.sqrt(var)
    z = (mu - best) / np.maximum(sigma, 1e-12)
    return (mu - best) * _norm_cdf(z) + sigma * _norm_pdf(z)


def lcb(mu: np.ndarray, var: np.ndarray, lam: float = 1.0) -> np.ndarray:
    return mu + lam * np.sqrt(var)


def make_acquisition(name: str, lam: float = 1.0):
    if name == "ei":
        return lambda mu, var, best: expected_improvement(mu, var, best)
    if name == "lcb":
        return lambda mu, var, best: lcb(mu, var, lam)
    raise ValueError(name)


def make_acquisition_device(name: str, lam: float = 1.0):
    """Tensor twins of the acquisitions, for the device-resident pool-scoring
    path (torch evaluation engine + GP posterior, no host round-trip).  They
    compute in the posterior's dtype (float64) on its device; `best` is a
    Python float or a tensor broadcastable against `mu`."""

    def ei(mu, var, best):
        sigma = torch.sqrt(var)
        z = (mu - best) / torch.clamp(sigma, min=1e-12)
        pdf = torch.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)
        cdf = 0.5 * (1.0 + torch.special.erf(z / math.sqrt(2.0)))
        return (mu - best) * cdf + sigma * pdf

    def lcb_device(mu, var, best):
        return mu + lam * torch.sqrt(var)

    if name == "ei":
        return ei
    if name == "lcb":
        return lcb_device
    raise ValueError(name)
