"""Tree ensembles in pure numpy.

RandomForestSurrogate  -- the RF surrogate from the paper's ablation (Fig. 5b):
                          mean/variance across trees drive the acquisition.
GradientBoostedTrees   -- the learned cost model for the TVM-style baseline
                          (Chen et al. 2018 use XGBoost; we implement equivalent
                          least-squares gradient boosting on shallow CARTs).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class _Node:
    feature: int = -1
    threshold: float = 0.0
    left: "_Node | None" = None
    right: "_Node | None" = None
    value: float = 0.0


def _build_tree(X, y, rng, max_depth, min_leaf, n_feat_try) -> _Node:
    node = _Node(value=float(y.mean()))
    if max_depth == 0 or len(y) < 2 * min_leaf or np.allclose(y, y[0]):
        return node
    n, d = X.shape
    feats = rng.choice(d, size=min(n_feat_try, d), replace=False)
    best = (0.0, -1, 0.0)  # (gain, feature, threshold)
    base = ((y - y.mean()) ** 2).sum()
    for f in feats:
        xs = X[:, f]
        order = np.argsort(xs)
        ys = y[order]
        csum = np.cumsum(ys)
        csq = np.cumsum(ys**2)
        tot, totsq = csum[-1], csq[-1]
        for i in range(min_leaf, n - min_leaf):
            if xs[order[i]] == xs[order[i - 1]]:
                continue
            nl = i
            sse_l = csq[i - 1] - csum[i - 1] ** 2 / nl
            nr = n - i
            sse_r = (totsq - csq[i - 1]) - (tot - csum[i - 1]) ** 2 / nr
            gain = base - (sse_l + sse_r)
            if gain > best[0]:
                best = (gain, f, 0.5 * (xs[order[i]] + xs[order[i - 1]]))
    if best[1] < 0:
        return node
    _, f, thr = best
    mask = X[:, f] <= thr
    node.feature, node.threshold = int(f), float(thr)
    node.left = _build_tree(X[mask], y[mask], rng, max_depth - 1, min_leaf, n_feat_try)
    node.right = _build_tree(X[~mask], y[~mask], rng, max_depth - 1, min_leaf, n_feat_try)
    return node


def _predict_tree(node: _Node, X) -> np.ndarray:
    out = np.empty(len(X))
    for i, x in enumerate(X):
        n = node
        while n.left is not None:
            n = n.left if x[n.feature] <= n.threshold else n.right
        out[i] = n.value
    return out


@dataclasses.dataclass
class RandomForestSurrogate:
    n_trees: int = 30
    max_depth: int = 8
    min_leaf: int = 2
    seed: int = 0
    _trees: list | None = None

    def fit(self, X, y):
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.float64)
        rng = np.random.default_rng(self.seed)
        n, d = X.shape
        self._trees = []
        for _ in range(self.n_trees):
            idx = rng.integers(n, size=n)
            self._trees.append(
                _build_tree(X[idx], y[idx], rng, self.max_depth, self.min_leaf,
                            max(1, int(np.ceil(d / 3))))
            )
        return self

    def posterior(self, Xs):
        Xs = np.asarray(Xs, np.float64)
        preds = np.stack([_predict_tree(t, Xs) for t in self._trees])
        return preds.mean(0), np.maximum(preds.var(0), 1e-10)


@dataclasses.dataclass
class GradientBoostedTrees:
    n_rounds: int = 40
    max_depth: int = 4
    lr: float = 0.2
    seed: int = 0
    _trees: list | None = None
    _base: float = 0.0

    def fit(self, X, y):
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.float64)
        rng = np.random.default_rng(self.seed)
        self._base = float(y.mean())
        resid = y - self._base
        self._trees = []
        d = X.shape[1]
        for _ in range(self.n_rounds):
            t = _build_tree(X, resid, rng, self.max_depth, 2, d)
            resid = resid - self.lr * _predict_tree(t, X)
            self._trees.append(t)
        return self

    def predict(self, Xs):
        Xs = np.asarray(Xs, np.float64)
        out = np.full(len(Xs), self._base)
        for t in self._trees:
            out += self.lr * _predict_tree(t, Xs)
        return out
