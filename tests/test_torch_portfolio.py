"""Portfolio co-design on the port (`repro_torch.workloads.portfolio`), on the
CPU: config validation/round-trip, one-hot parity with the standalone
single-workload search (the acceptance contract), the weighted objective
math, Pareto-front sanity, and the service integration (portfolio requests +
store_max_entries pruning) -- the reference's tests/test_portfolio.py, run on
`repro_torch`."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.core import (CodesignConfig, CodesignEngine, EngineConfig,
                        HWSearchConfig, ServiceConfig, SWSearchConfig)
from repro_torch.service import CodesignService, DesignStore, ServiceRequest
from repro_torch.timeloop import MODEL_LAYERS
from repro_torch.workloads import (PortfolioConfig, PortfolioSession,
                             make_portfolio_engine, portfolio_codesign,
                             portfolio_session)


def tiny_config(seed=0, prune="off", backend="numpy") -> CodesignConfig:
    return CodesignConfig(
        sw=SWSearchConfig(n_trials=10, n_warmup=5, pool_size=15),
        hw=HWSearchConfig(n_trials=3, n_warmup=2, pool_size=12, prune=prune),
        engine=EngineConfig(backend=backend, device="cpu"),
        seed=seed,
    )


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the GP's matrices are tiny, and test workers run
    side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- PortfolioConfig ------------------------------------------------------------

def test_portfolio_config_roundtrip():
    pf = PortfolioConfig(workloads=("dqn", "qwen3_14b"), weights=(2.0, 1.0))
    assert PortfolioConfig.from_json(pf.to_json()) == pf
    assert PortfolioConfig.from_dict(pf.to_dict()) == pf
    # uniform default weights
    uni = PortfolioConfig(workloads=("dqn", "mlp"))
    assert uni.normalized_weights() == (0.5, 0.5)
    assert pf.normalized_weights() == (2 / 3, 1 / 3)


def test_portfolio_config_validation():
    with pytest.raises(ValueError, match="at least one workload"):
        PortfolioConfig(workloads=())
    with pytest.raises(ValueError, match="duplicate"):
        PortfolioConfig(workloads=("dqn", "dqn"))
    with pytest.raises(ValueError) as ei:
        PortfolioConfig(workloads=("dqn", "nope"))
    assert "resnet" in str(ei.value) and "qwen3_14b" in str(ei.value)
    with pytest.raises(ValueError, match="weights"):
        PortfolioConfig(workloads=("dqn", "mlp"), weights=(1.0,))
    with pytest.raises(ValueError, match="finite"):
        PortfolioConfig(workloads=("dqn",), weights=(-1.0,))
    with pytest.raises(ValueError, match="positive"):
        PortfolioConfig(workloads=("dqn", "mlp"), weights=(0.0, 0.0))
    with pytest.raises(ValueError, match="unknown portfolio keys"):
        PortfolioConfig.from_dict({"workloads": ["dqn"], "bogus": 1})


# --- engine restrictions --------------------------------------------------------

def test_portfolio_requires_prune_off():
    pf = PortfolioConfig(workloads=("dqn",))
    with pytest.raises(ValueError, match="prune"):
        make_portfolio_engine(tiny_config(prune="safe"))
    engine = CodesignEngine(tiny_config(prune="safe"))
    with pytest.raises(ValueError, match="prune"):
        PortfolioSession(engine, pf)


def test_portfolio_upgrades_sequential_strategy():
    # tiny_config resolves strategy "auto" -> "sequential" on numpy; the
    # factory upgrades it to the bit-identical layer_batched...
    engine = make_portfolio_engine(tiny_config())
    assert engine.strategy_name == "layer_batched"
    # ...and the session refuses a sequential engine outright.
    seq_cfg = dataclasses.replace(
        tiny_config(), engine=EngineConfig(backend="numpy", device="cpu",
                                           strategy="sequential"))
    with pytest.raises(ValueError, match="sequential"):
        PortfolioSession(CodesignEngine(seq_cfg),
                         PortfolioConfig(workloads=("dqn",)))


# --- one-hot parity (the acceptance contract) -----------------------------------

@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_one_hot_parity_with_standalone(backend):
    """With one-hot weights the portfolio search must find the standalone
    search's best_hw exactly (identical utility stream -> identical outer
    trajectory); per-layer EDPs are bitwise equal, the geomean objective
    equal to the standalone sum up to log/exp rounding."""
    cfg = tiny_config(seed=0, backend=backend)
    standalone = CodesignEngine(cfg).run(MODEL_LAYERS["dqn"])
    pf = PortfolioConfig(workloads=("dqn", "mlp"), weights=(1.0, 0.0))
    res = portfolio_codesign(pf, cfg)
    assert res.best_hw == standalone.best_hw
    for name, edp in standalone.layer_edps.items():
        assert res.layer_edps[name] == edp
    assert res.stats["portfolio_member_edps"]["dqn"] \
        == standalone.best_model_edp
    assert res.best_model_edp == pytest.approx(standalone.best_model_edp,
                                               rel=1e-12)
    # the zero-weight member is still searched and reported
    assert math.isfinite(res.stats["portfolio_member_edps"]["mlp"])


def test_weighted_objective_math_and_pareto():
    cfg = tiny_config(seed=0)
    pf = PortfolioConfig(workloads=("dqn", "mlp"), weights=(2.0, 1.0))
    res = portfolio_codesign(pf, cfg)
    edps = res.stats["portfolio_member_edps"]
    want = 10.0 ** ((2 * np.log10(edps["dqn"]) + np.log10(edps["mlp"])) / 3)
    assert res.best_model_edp == pytest.approx(want, rel=1e-12)
    assert res.stats["portfolio_weights"] == pytest.approx([2 / 3, 1 / 3])
    front = res.stats["portfolio_pareto"]
    assert len(front) >= 1
    # the winner's member vector is on the front (weighted geomean argmin is
    # never dominated), and no front point dominates another
    assert any(p["member_edps"] == edps for p in front)
    for p in front:
        for q in front:
            if p is q:
                continue
            assert not all(q["member_edps"][w] <= p["member_edps"][w]
                           for w in pf.workloads)


def test_portfolio_session_snapshot_restore():
    cfg = tiny_config(seed=0)
    pf = PortfolioConfig(workloads=("dqn", "mlp"), weights=(2.0, 1.0))
    ref = portfolio_codesign(pf, cfg)

    sess = portfolio_session(pf, cfg)
    sess.step()
    snap = sess.snapshot()
    resumed = portfolio_session(pf, cfg).restore(snap)
    while resumed.step():
        pass
    res = resumed.result()
    assert res.best_hw == ref.best_hw
    assert res.best_model_edp == ref.best_model_edp
    assert res.stats["portfolio_pareto"] == ref.stats["portfolio_pareto"]


# --- service integration --------------------------------------------------------

def test_service_portfolio_request_parity(tmp_path):
    cfg = tiny_config(seed=0)
    pf = PortfolioConfig(workloads=("dqn", "mlp"), weights=(2.0, 1.0))
    standalone = portfolio_codesign(pf, cfg)

    svc = CodesignService(ServiceConfig(store_dir=str(tmp_path / "store")))
    req = ServiceRequest.from_dict({"portfolio": pf.to_dict(),
                                    "config": cfg.to_dict(), "rid": "p0"})
    assert ServiceRequest.from_json(req.to_json()) == req
    svc.submit(req)
    resp = svc.run()["p0"]
    svc.close()
    assert resp.result.best_hw == standalone.best_hw
    assert resp.result.best_model_edp == standalone.best_model_edp
    assert resp.result.stats["portfolio_member_edps"] \
        == standalone.stats["portfolio_member_edps"]


def test_service_request_portfolio_validation():
    pf = PortfolioConfig(workloads=("dqn",))
    with pytest.raises(ValueError, match="not both"):
        ServiceRequest(layers=tuple(MODEL_LAYERS["dqn"]), portfolio=pf)
    with pytest.raises(ValueError, match="no layers"):
        ServiceRequest(layers=())
    with pytest.raises(ValueError, match="prune"):
        ServiceRequest(portfolio=pf, config=tiny_config(prune="safe"))
    with pytest.raises(ValueError, match="PortfolioConfig"):
        ServiceRequest(portfolio="dqn")
    # zoo model names resolve on the JSON layers surface
    req = ServiceRequest.from_dict({"layers": "qwen3_14b"})
    assert len(req.layers) == 5
    with pytest.raises(ValueError) as ei:
        ServiceRequest.from_dict({"layers": "nope"})
    assert "qwen3_14b" in str(ei.value) and "resnet" in str(ei.value)


def test_store_max_entries_prunes(tmp_path):
    store_dir = str(tmp_path / "store")
    sc = ServiceConfig(store_dir=store_dir, store_max_entries=4)
    svc = CodesignService(sc)
    svc.submit(ServiceRequest(layers=tuple(MODEL_LAYERS["dqn"]),
                              config=tiny_config(), rid="r0"))
    svc.run()
    svc.close()
    assert 0 < len(DesignStore(store_dir)) <= 4


def test_store_max_entries_validation():
    with pytest.raises(ValueError):
        ServiceConfig(store_max_entries=-1)
    sc = ServiceConfig(store_max_entries=7)
    assert ServiceConfig.from_dict(sc.to_dict()) == sc
