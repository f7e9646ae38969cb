"""The yardstick's arithmetic: the H100's peaks, and the operations and bytes
that kernel K1b (`cost_forward_kernel`) and the GP surrogates need for the
shapes a run hands them.  Counted from shapes and data as the algorithm
needs them, never from what a kernel happens to do.

K1b reads each input byte of a row once and writes each output byte once
(the five operands of `kernels/cost_forward.py`, and `valid`, four scalars
and fourteen features out): 665 B a row in float64, 381 in float32.  Its
operations a row are `FORWARD_ROW_FLOPS` of tiles, validity, features and
utility, the 63 of the reduction's accumulation, energy, delay and EDP, and
the trip and pass products the row's factors and loop orders need.

The GP counts follow the algorithm on each run's true data rows `n`, `d`
features and a pool of `P` candidates: a fit is `steps` Adam steps, each a
negative log-likelihood forward and its backward (twice the forward); a
posterior factors the data kernel, solves and scores the pool.
"""

from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12}   # outside the tensor cores
PEAK_FLOPS_F64_TENSOR = 67e12                       # the card's f64 peak

ITEM = {"float64": 8, "float32": 4}
# Per row: factors (5 x 6), hardware (15) and layer (8) in the dtype, two
# int64 loop orders (6 each); out `valid` (1 byte), energy, delay, EDP,
# utility and 14 features in the dtype.
N_FLOAT_IN, N_INT64_IN, N_FLOAT_OUT = 30 + 15 + 8, 12, 4 + 14
FORWARD_ROW_FLOPS = 116
REDUCE_ROW_FLOPS = 63
# Relevance of each dim (R, S, P, Q, C, K) to W, I and O.
REL = np.array([[1, 1, 0, 0, 1, 1],
                [1, 1, 1, 1, 1, 0],
                [0, 0, 1, 1, 0, 1]], dtype=bool)
L_GB, L_DRAM = 3, 4


def k1b_bytes(rows: int, dtype: str) -> int:
    item = ITEM[dtype]
    return rows * (N_FLOAT_IN * item + N_INT64_IN * 8 + 1
                   + N_FLOAT_OUT * item)


def k1b_flops(factors: np.ndarray, order_gb: np.ndarray,
              order_dram: np.ndarray) -> int:
    """Operations K1b needs on these rows: factors (N, 5, 6), loop orders
    (N, 6) as dim indices, outermost first."""
    n = factors.shape[0]
    pos = np.arange(6)
    flops = (FORWARD_ROW_FLOPS + REDUCE_ROW_FLOPS) * n
    for level, order in ((L_GB, order_gb), (L_DRAM, order_dram)):
        f = np.take_along_axis(factors[:, level], order, axis=1)
        for ti in range(3):
            rel = REL[ti][order]
            active = rel & (f > 1.0)
            inner = np.where(active, pos, -1).max(axis=1)
            inc = (rel | (pos < inner[:, None])).sum(axis=1)
            flops += int(np.where(active.any(axis=1), inc - 1, 0).sum())
        rel = REL[2][order]
        anchor = np.where(rel & (f > 1.0), pos, 6).min(axis=1)
        inc = ((~rel) & (pos < anchor[:, None])).sum(axis=1)
        flops += int(np.clip(inc - 1, 0, None).sum()) + 2 * n
    return flops


def k1b_bound_s(n_bytes: int, flops: int, dtype: str) -> float:
    """The least time the card could take: bytes at HBM bandwidth or
    operations at the dtype's peak, whichever is longer."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def _nll_flops(n: int, d: int, kind: str) -> float:
    """One negative log-likelihood of an exact GP on n rows: the kernel
    matrix, its Cholesky factor, the solve and the quadratic form; for the
    linear kernel the rank-(d+1) Woodbury form where that needs fewer."""
    kern = (2 * d + 1) * n * n if kind == "linear" else (3 * d + 2) * n * n
    chol = kern + n ** 3 / 3 + 2 * n * n + 3 * n
    if kind != "linear":
        return chol
    r = d + 1
    wood = 2 * n * r * r + r ** 3 / 3 + 4 * n * r + 2 * r * r + 4 * n
    return min(chol, wood)


def gp_fit_flops(ns, d: int, steps: int, kind: str) -> float:
    """Adam's `steps` forward and backward passes of every run's NLL."""
    return float(sum(3 * steps * _nll_flops(n, d, kind) for n in ns))


def gp_posterior_flops(ns, pool: int, d: int, kind: str) -> float:
    """Every run's posterior mean and variance over a pool of `pool`."""
    per = 2 * d if kind == "linear" else 3 * d
    return float(sum(n ** 3 / 3 + 2 * n * n + per * pool * n
                     + pool * n * n + 4 * pool * n + 2 * pool * d
                     for n in ns))
