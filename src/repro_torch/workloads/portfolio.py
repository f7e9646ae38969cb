"""Portfolio co-design: one hardware config for a weighted mix of workloads.

A `PortfolioConfig` names member workload sets (paper or zoo) and their
traffic weights; a `PortfolioSession` scores each outer hardware trial
against ALL members at once -- the union of every member's layers rides the
existing stacked inner-search machinery (`SearchSession.pending()` emits the
whole union, so fused service dispatch and the process executor come along
for free) -- with the trial utility

    u(hw) = -sum_m  w_m * log10(EDP_m(hw))        (w normalized to sum 1)

i.e. the weighted-sum log-EDP = -log10 of the weighted *geometric mean* of
member EDPs, which is what `best_model_edp` reports.  A hardware point with
no feasible mapping for any layer of a positive-weight member is an unknown-
constraint violation (exactly the single-workload rule); zero-weight members
are still searched (they are part of the union stack -- useful for "measure
but don't optimize" traffic) but cannot veto feasibility.  Every feasible
trial's per-member EDP vector is kept, and the non-dominated (Pareto) subset
ships in `CoDesignResult.stats["portfolio_pareto"]`.

Parity contract: with one-hot weights the utility stream collapses to the
single-workload `-log10(total_edp)` bit-for-bit (content-derived probe seeds
make the extra zero-weight members' inner searches trajectory-neutral), so a
one-hot portfolio finds the standalone search's `best_hw` exactly -- pinned
in tests/test_torch_portfolio.py.

Two engine-config restrictions, enforced loudly: `hw.prune` must be "off"
(the EDP lower-bound gate is keyed on a summed-EDP incumbent, which has no
meaning under the weighted objective), and the "sequential" probe strategy is
upgraded to the bit-identical "layer_batched" (`make_portfolio_engine`) --
sequential stops a probe at its first infeasible layer, which would leave
later members' cache entries unevaluated and mis-attribute feasibility.
"""

from __future__ import annotations

import dataclasses
import json
import math

import numpy as np

from repro_torch.core.config import CodesignConfig
from repro_torch.core.nested import (CodesignEngine, CoDesignResult, SearchSession)
from repro_torch.workloads.zoo import resolve_workload


@dataclasses.dataclass(frozen=True)
class PortfolioConfig:
    """Named workload sets + traffic weights (JSON round-trip like the other
    frozen configs).  Empty `weights` means uniform."""

    workloads: tuple[str, ...]
    weights: tuple[float, ...] = ()

    def __post_init__(self) -> None:
        object.__setattr__(self, "workloads", tuple(self.workloads))
        object.__setattr__(
            self, "weights", tuple(float(w) for w in self.weights))
        if not self.workloads:
            raise ValueError("portfolio needs at least one workload")
        if len(set(self.workloads)) != len(self.workloads):
            raise ValueError(
                f"duplicate portfolio workloads: {list(self.workloads)}")
        for name in self.workloads:
            resolve_workload(name)  # raises ValueError listing known names
        if self.weights:
            if len(self.weights) != len(self.workloads):
                raise ValueError(
                    f"{len(self.weights)} weights for "
                    f"{len(self.workloads)} workloads")
            if any(w < 0 or not math.isfinite(w) for w in self.weights):
                raise ValueError(
                    f"weights must be finite and >= 0: {list(self.weights)}")
            if not any(w > 0 for w in self.weights):
                raise ValueError("at least one weight must be positive")

    def normalized_weights(self) -> tuple[float, ...]:
        ws = self.weights or tuple(1.0 for _ in self.workloads)
        total = sum(ws)
        return tuple(w / total for w in ws)

    def to_dict(self) -> dict:
        return {"workloads": list(self.workloads),
                "weights": list(self.weights)}

    @classmethod
    def from_dict(cls, d: dict) -> "PortfolioConfig":
        d = dict(d)
        workloads = d.pop("workloads")
        weights = d.pop("weights", ()) or ()
        if d:
            raise ValueError(f"unknown portfolio keys: {sorted(d)}")
        return cls(workloads=tuple(workloads), weights=tuple(weights))

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def from_json(cls, s: str) -> "PortfolioConfig":
        return cls.from_dict(json.loads(s))


class PortfolioSession(SearchSession):
    """A `SearchSession` over the union of all members' layers whose outer
    objective is the weighted-sum log-EDP across members."""

    def __init__(self, engine: CodesignEngine, portfolio: PortfolioConfig,
                 hw_callback=None):
        if engine.config.hw.prune != "off":
            raise ValueError(
                "portfolio search requires hw.prune='off': the EDP "
                "lower-bound gate censors against a summed-EDP incumbent, "
                "which is meaningless under the weighted member objective")
        if engine.strategy_name == "sequential":
            raise ValueError(
                "portfolio search cannot use the 'sequential' probe "
                "strategy (it stops at the first infeasible layer, leaving "
                "later members unevaluated); use make_portfolio_engine(), "
                "which upgrades it to the bit-identical 'layer_batched'")
        self.portfolio = portfolio
        self._member_layers = tuple(
            tuple(resolve_workload(w)) for w in portfolio.workloads)
        self._weights = portfolio.normalized_weights()
        self._front: list[tuple[tuple[float, ...], float]] = []
        union = [l for ls in self._member_layers for l in ls]
        super().__init__(engine, union, hw_callback=hw_callback)
        self.best["objective"] = -np.inf
        self.best["member_edps"] = None

    def _eval_hw(self, hw):
        engine, best = self.engine, self.best
        engine.strategy.evaluate_probe(engine, hw, engine.probe_seed(hw))
        member_edps: list[float] = []
        maps, per_layer = {}, {}
        for layers, w in zip(self._member_layers, self._weights):
            total = 0.0
            for layer in layers:
                m, edp = engine.cache.get((hw, layer), (None, float("inf")))
                if m is None:
                    if w > 0.0:
                        return None, False  # unknown-constraint violation
                    total = float("inf")
                    break
                total += edp
                maps[layer.name] = m
                per_layer[layer.name] = edp
            member_edps.append(total)
        # One-hot parity: the w > 0 filter keeps the sum a single
        # 1.0 * log10(edp) term, bitwise equal to the standalone utility
        # (and avoids 0 * log10(inf) = nan from zero-weight members).
        utility = -float(sum(w * np.log10(e)
                             for w, e in zip(self._weights, member_edps)
                             if w > 0.0))
        self._front.append((tuple(member_edps), utility))
        if utility > best["objective"]:
            best.update(edp=float(10.0 ** -utility), hw=hw, maps=maps,
                        per_layer=per_layer, objective=utility,
                        member_edps=tuple(member_edps))
        if engine.config.verbose:
            edps = ", ".join(f"{e:.3e}" for e in member_edps)
            print(f"  hw {hw.pe_mesh_x}x{hw.pe_mesh_y} -> member EDPs "
                  f"[{edps}]  weighted geomean {10.0 ** -utility:.3e}")
        return utility, True

    def _pareto_front(self) -> list[dict]:
        """Non-dominated per-member EDP vectors (positive-weight members,
        minimization) among all feasible scored probes, JSON-friendly."""
        pos = [i for i, w in enumerate(self._weights) if w > 0.0]
        names = [self.portfolio.workloads[i] for i in pos]
        pts: dict[tuple[float, ...], float] = {}
        for edps, utility in self._front:
            pts.setdefault(tuple(edps[i] for i in pos), utility)
        keys = list(pts)
        front = [
            v for v in keys
            if not any(o != v and all(a <= b for a, b in zip(o, v))
                       for o in keys)
        ]
        front.sort(key=lambda v: -pts[v])
        return [{"member_edps": dict(zip(names, v)), "objective": pts[v]}
                for v in front]

    def result(self) -> CoDesignResult:
        res = super().result()
        res.stats["portfolio_workloads"] = list(self.portfolio.workloads)
        res.stats["portfolio_weights"] = list(self._weights)
        res.stats["portfolio_member_edps"] = (
            dict(zip(self.portfolio.workloads, self.best["member_edps"]))
            if self.best["member_edps"] is not None else None)
        res.stats["portfolio_pareto"] = self._pareto_front()
        return res

    def snapshot(self) -> dict:
        snap = super().snapshot()
        snap["front"] = [[list(edps), utility] for edps, utility in self._front]
        return snap

    def restore(self, snap: dict) -> "PortfolioSession":
        super().restore(snap)
        self._front = [(tuple(edps), float(utility))
                       for edps, utility in snap.get("front", [])]
        return self


def make_portfolio_engine(config: CodesignConfig | None = None,
                          executor=None) -> CodesignEngine:
    """`CodesignEngine` prepared for portfolio search: validates
    `hw.prune == "off"` and upgrades a resolved "sequential" strategy to the
    bit-identical "layer_batched" (see module docstring)."""
    cfg = config if config is not None else CodesignConfig()
    if cfg.hw.prune != "off":
        raise ValueError(
            f"portfolio search requires hw.prune='off', got "
            f"{cfg.hw.prune!r}")
    if cfg.engine.resolve_strategy() == "sequential":
        cfg = dataclasses.replace(
            cfg, engine=dataclasses.replace(cfg.engine,
                                            strategy="layer_batched"))
    return CodesignEngine(cfg, executor=executor)


def portfolio_session(portfolio: PortfolioConfig,
                      config: CodesignConfig | None = None,
                      executor=None, hw_callback=None) -> PortfolioSession:
    engine = make_portfolio_engine(config, executor=executor)
    return PortfolioSession(engine, portfolio, hw_callback=hw_callback)


def portfolio_codesign(portfolio: PortfolioConfig,
                       config: CodesignConfig | None = None,
                       executor=None) -> CoDesignResult:
    """Run a portfolio search to completion (the stepwise form is
    `portfolio_session`)."""
    session = portfolio_session(portfolio, config, executor=executor)
    while session.step():
        pass
    return session.result()
