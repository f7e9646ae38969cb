"""The executor layer on the port (`repro_torch.parallel`), on the CPU: process
fan-out of stacked inner searches -- the reference's tests/test_executor.py,
run on `repro_torch`.

The load-bearing claims:

  * worker-count invariance -- `strategy="speculative"` under
    `ExecutorConfig(kind="process")` reproduces `tests/goldens/codesign.json`
    on all four workloads (backend="numpy", as the port reproduces it
    inline), for n_workers in {1, 2, 4}: content-derived probe seeds make
    placement a free variable;
  * chunking invariance -- splitting one stacked dispatch into per-worker
    chunks only regroups which runs share a stacked fit, so entries match
    the unsplit dispatch exactly;
  * spawn hygiene -- a freshly spawned worker boots with no `jax` module, no
    module of the reference package `repro` (both loaded in this process)
    and no CUDA context, and reports its K1b launches; unpickling a search
    spec imports no evaluation engine;
  * worker failures re-raise in the learner with the worker traceback.

Bars: exact equality.
"""

import dataclasses
import hashlib
import json
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import (CodesignConfig, CodesignEngine, EngineConfig,
                              ExecutorConfig, FanoutSearchSpec,
                              HWSearchConfig, ServiceConfig, SWSearchConfig)
from repro_torch.parallel import workers
from repro_torch.parallel.executor import (InlineExecutor, ProcessExecutor,
                                           _chunk_spec, make_executor)
from repro_torch.timeloop import MODEL_LAYERS, eyeriss_168

GOLDEN_PATH = Path(__file__).parent / "goldens" / "codesign.json"
MODELS = ("resnet", "dqn", "mlp", "transformer")
SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread here, and so one in each worker (a worker takes
    its share of the learner's): test workers run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- config plumbing --------------------------------------------------------------


def test_executor_config_validation():
    assert ExecutorConfig() == ExecutorConfig(kind="inline", n_workers=0,
                                              chunk_items=0)
    assert ExecutorConfig().resolve_workers() >= 1
    assert ExecutorConfig(n_workers=3).resolve_workers() == 3
    with pytest.raises(ValueError, match="kind"):
        ExecutorConfig(kind="threads")
    with pytest.raises(ValueError, match="n_workers"):
        ExecutorConfig(n_workers=-1)
    with pytest.raises(ValueError, match="n_workers"):
        ExecutorConfig(n_workers=True)
    with pytest.raises(ValueError, match="chunk_items"):
        ExecutorConfig(chunk_items=-2)


def test_executor_config_json_roundtrip():
    """The executor section rides the existing config JSON surfaces: dicts
    coerce to ExecutorConfig on the way in, round-trip equality holds."""
    eng = EngineConfig(executor=ExecutorConfig(kind="process", n_workers=2))
    cfg = CodesignConfig(engine=eng)
    assert CodesignConfig.from_json(cfg.to_json()) == cfg
    assert EngineConfig(executor={"kind": "process"}).executor == \
        ExecutorConfig(kind="process")
    with pytest.raises(ValueError, match="executor"):
        EngineConfig(executor={"kind": "process", "bogus": 1})
    with pytest.raises(ValueError, match="executor"):
        EngineConfig(executor=7)
    sc = ServiceConfig(executor=ExecutorConfig(kind="process", n_workers=4))
    assert ServiceConfig.from_dict(sc.to_dict()) == sc


def test_make_executor_kinds_and_engine_takes_the_process_kind():
    assert isinstance(make_executor(), InlineExecutor)
    assert isinstance(make_executor(ExecutorConfig(kind="inline")),
                      InlineExecutor)
    ex = make_executor(ExecutorConfig(kind="process", n_workers=3))
    try:
        assert isinstance(ex, ProcessExecutor)
        assert ex.n_workers == 3 and not ex._procs  # nothing started yet
    finally:
        ex.close()
    # The engine builds its executor lazily from the config and owns it.
    engine = CodesignEngine(CodesignConfig(engine=EngineConfig(
        device="cpu", executor=ExecutorConfig(kind="process", n_workers=2))))
    assert isinstance(engine.executor, ProcessExecutor)
    engine.close()
    assert engine._executor is None


# --- spec + chunking --------------------------------------------------------------


def _tiny_spec(n_items: int = 3, sw=None, backend="numpy") -> FanoutSearchSpec:
    hw = eyeriss_168()
    layers = (list(MODEL_LAYERS["dqn"]) * n_items)[:n_items]
    items = tuple((hw, layer) for layer in layers)
    cfg = CodesignConfig(engine=EngineConfig(backend=backend, device="cpu"))
    engine = CodesignEngine(cfg)
    seeds = tuple(engine.probe_seed(hw) + i for i in range(n_items))
    return FanoutSearchSpec(
        items=items, seeds=seeds,
        sw=sw or SWSearchConfig(n_trials=6, n_warmup=3, pool_size=10),
        engine=cfg.engine)


def test_chunk_spec_partitions_in_item_order():
    spec = _tiny_spec(5)
    assert _chunk_spec(spec, n_workers=1, chunk_items=0) == [spec]
    chunks = _chunk_spec(spec, n_workers=2, chunk_items=0)
    assert [len(c.items) for c in chunks] == [3, 2]
    chunks = _chunk_spec(spec, n_workers=4, chunk_items=1)
    assert [len(c.items) for c in chunks] == [1] * 5
    assert sum((list(c.items) for c in chunks), []) == list(spec.items)
    assert sum((list(c.seeds) for c in chunks), []) == list(spec.seeds)
    padded = dataclasses.replace(spec, pad_to=6)
    assert _chunk_spec(padded, 1, 0) == [padded]
    assert all(c.pad_to is None for c in _chunk_spec(padded, 2, 2))


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_process_entries_match_inline_across_chunkings(backend):
    """The same spec returns identical entries inline, split evenly across
    two workers, and split down to one item per chunk."""
    spec = _tiny_spec(4, backend=backend)
    want = InlineExecutor().run(spec)
    for chunk_items in (0, 1):
        ex = ProcessExecutor(n_workers=2, chunk_items=chunk_items)
        try:
            assert ex.run(spec) == want, f"chunk_items={chunk_items}"
        finally:
            ex.close()


def test_worker_error_propagates_with_traceback():
    bad = dataclasses.replace(_tiny_spec(3), seeds=(0,))  # len mismatch
    ex = ProcessExecutor(n_workers=1)
    try:
        with pytest.raises(RuntimeError, match="worker traceback"):
            ex.run(bad)
        # the pool survives a failed task and keeps serving
        assert ex.run(_tiny_spec(2)) == InlineExecutor().run(_tiny_spec(2))
    finally:
        ex.close()


# --- spawn hygiene ----------------------------------------------------------------


def test_spawned_worker_has_no_jax_no_repro_and_no_cuda_context():
    """A freshly spawned worker must not inherit this process's modules or
    CUDA state (fork would copy both): at boot it has no `jax` and no
    `repro` module and `torch.cuda.is_initialized()` is False, and a
    torch-engine search inside it loads neither.  Its K1b count stays 0 on
    the CPU, where the wrapper runs the plain version (the count moves only
    where the kernel launches; chip_smoke.py reads it on the card)."""
    import jax  # noqa: F401  (the learner HAS jax and repro loaded)
    import repro.timeloop  # noqa: F401

    assert "jax" in sys.modules and "repro" in sys.modules
    ex = ProcessExecutor(n_workers=2)
    try:
        fresh = ex.probe_all()
        assert len(fresh) == 2 and len({p["pid"] for p in fresh}) == 2
        for report in fresh:
            assert report["boot"] == {"forked": False, "jax_modules": [],
                                      "repro_modules": [],
                                      "cuda_initialized": False}
            assert report["cost_forward_launches"] == 0

        spec = _tiny_spec(2, backend="torch")
        assert ex.run(spec) == InlineExecutor().run(spec)
        after = ex.probe_all()
        for report in after:
            assert report["cost_forward_launches"] == 0
            assert report["jax_modules"] == [] == report["repro_modules"]
            assert report["cuda_initialized"] is False  # device="cpu"
    finally:
        ex.close()

    # The fork tripwire: a worker whose boot state says it was fork-started
    # refuses to search.
    with pytest.raises(RuntimeError, match="fork-started"):
        workers._run_search(_tiny_spec(1), {"forked": True})


def test_unpickling_a_spec_imports_no_engine_and_opens_no_cuda(tmp_path):
    """A spec crosses the spawn boundary as plain data: unpickling it in a
    fresh interpreter loads neither cost-model engine's device module nor a
    kernel, and opens no CUDA context."""
    blob = tmp_path / "spec.pkl"
    blob.write_bytes(pickle.dumps(_tiny_spec(2, backend="torch")))
    code = (
        "import pickle, sys, torch\n"
        f"spec = pickle.loads(open({str(blob)!r}, 'rb').read())\n"
        "assert len(spec.items) == 2\n"
        "bad = [m for m in sys.modules if m in ("
        "'repro_torch.timeloop.batch_torch', "
        "'repro_torch.kernels.cost_forward', "
        "'repro_torch.kernels.edp_reduce') or m == 'jax' "
        "or m.startswith(('jax.', 'repro.'))]\n"
        "assert not bad, bad\n"
        "assert not torch.cuda.is_initialized()\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0 and out.stdout.strip() == "clean", out.stderr


# --- golden worker-count invariance -----------------------------------------------


def _golden_config(model: str, n_workers: int) -> CodesignConfig:
    """test_golden's exact budgets, with the speculative strategy routed
    through a process executor."""
    return CodesignConfig(
        sw=SWSearchConfig(n_trials=10, n_warmup=5, pool_size=15),
        hw=HWSearchConfig(n_trials=3, n_warmup=2, pool_size=12,
                          num_pes=256 if model == "transformer" else 168),
        engine=EngineConfig(backend="numpy", strategy="speculative",
                            device="cpu",
                            executor=ExecutorConfig(kind="process",
                                                    n_workers=n_workers)),
        seed=0,
    )


def _canonical(result) -> str:
    hw = dataclasses.astuple(result.best_hw)
    maps = sorted((name, dataclasses.astuple(m))
                  for name, m in result.best_mappings.items())
    return repr((hw, maps))


def _record(result) -> dict:
    return {
        "design_sha256": hashlib.sha256(
            _canonical(result).encode()).hexdigest(),
        "best_log10_edp": round(float(np.log10(result.best_model_edp)), 6),
        "n_trials": len(result.hw_result.history),
    }


@pytest.fixture(scope="module", params=[1, 2, 4])
def worker_pool(request):
    """One pool per width, shared by the four workloads (spawn + import cost
    is paid once per worker)."""
    ex = ProcessExecutor(n_workers=request.param)
    yield ex
    ex.close()


@pytest.mark.parametrize("model", MODELS)
def test_worker_count_invariance(model, worker_pool):
    """Every pool width reproduces the golden record through the process
    executor, with the inline run's outer history."""
    goldens = json.loads(GOLDEN_PATH.read_text())
    cfg = _golden_config(model, worker_pool.n_workers)
    result = CodesignEngine(cfg, executor=worker_pool).run(MODEL_LAYERS[model])
    assert _record(result) == goldens[model]
    inline = CodesignEngine(dataclasses.replace(
        cfg, engine=dataclasses.replace(cfg.engine,
                                        executor=ExecutorConfig()))
    ).run(MODEL_LAYERS[model])
    assert result.hw_result.history == inline.hw_result.history
    assert result.best_mappings == inline.best_mappings
