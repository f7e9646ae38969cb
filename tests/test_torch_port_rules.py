"""Rules the PyTorch port keeps, checked in fresh interpreters.

  * importing and running `repro_torch` (an engine built, the device cost
    model driven on the CPU, the LM served and trained and the LM kernels'
    entry points called on the CPU, a service request, the zoo, a portfolio
    config, a baseline and a process-executor search) loads no `jax`,
    `repro` or `repro.*` module;
  * no module of the port, and not `chip_smoke.py`, has an import of `jax`
    or `repro` anywhere in its source (lazy imports included);
  * the default device is the card: without CUDA it raises a RuntimeError
    that names the device, at every entry point, instead of running on the
    CPU;
  * the process executor is ported: an engine configured for it builds a
    worker pool lazily;
  * enumerated config values are validated.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.core import (CodesignConfig, CodesignEngine, EngineConfig,
                              ExecutorConfig)

REPO = Path(__file__).resolve().parents[1]

_HYGIENE = r"""
import sys
import numpy as np
import repro_torch
from repro_torch.core import CodesignConfig, CodesignEngine, EngineConfig
from repro_torch.timeloop import MODEL_LAYERS, eyeriss_168
from repro_torch.timeloop import batch as tlb, batch_torch as ttlb
engine = CodesignEngine(CodesignConfig(engine=EngineConfig(device="cpu")))
assert engine.strategy_name == "layer_batched", engine.strategy_name
layer = MODEL_LAYERS["dqn"][0]
pool = tlb.sample_valid_pool(np.random.default_rng(0), eyeriss_168(), layer, 20)
out = ttlb.forward_device(eyeriss_168(), pool, layer, device="cpu")
assert out["valid"].all()
import torch
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models.model import build_model
from repro_torch.configs.base import get_smoke_config
done = serve.main(["--arch", "smollm-360m", "--smoke", "--requests", "2",
                   "--batch", "2", "--prompt-len", "8", "--gen-len", "2",
                   "--device", "cpu"])
assert [len(r.out_tokens) for r in done] == [2, 2]
model = build_model(get_smoke_config("qwen3-14b"), "cpu")
logits, _ = model.prefill({"tokens": torch.zeros((1, 64), dtype=torch.long)})
assert logits.shape == (1, 1, 512)
assert ops.matmul(np.ones((64, 32), np.float32), np.ones((32, 64), np.float32),
                  device="cpu").sum() == 64 * 32 * 64
q = torch.ones((1, 64, 2, 8))
assert ops.attention(q, q, q).shape == (1, 64, 2, 8)
import tempfile
from repro_torch.launch import train
with tempfile.TemporaryDirectory() as ckpt_dir:
    losses = train.main(["--arch", "smollm-360m", "--smoke", "--steps", "2",
                         "--batch", "2", "--seq", "16", "--device", "cpu",
                         "--ckpt-dir", ckpt_dir])
assert len(losses) == 2
from repro_torch.core import (CodesignConfig, ExecutorConfig, HWSearchConfig,
                              SoftwareSpace, SWSearchConfig, random_search)
from repro_torch.service import CodesignService, ServiceConfig, ServiceRequest
from repro_torch.workloads import PortfolioConfig, zoo_workload
assert zoo_workload("llama4-maverick-400b-a17b").layers
PortfolioConfig(("resnet", "dqn"))
space = SoftwareSpace(eyeriss_168(), layer, device="cpu")
assert len(random_search(space, n_trials=3).history) == 3
tiny = CodesignConfig(
    sw=SWSearchConfig(n_trials=4, n_warmup=2, pool_size=8),
    hw=HWSearchConfig(n_trials=2, n_warmup=2, pool_size=8),
    engine=EngineConfig(device="cpu", strategy="speculative",
                        executor=ExecutorConfig(kind="process", n_workers=1)))
with CodesignService(ServiceConfig(executor=tiny.engine.executor)) as svc:
    rid = svc.submit(ServiceRequest(layers=tuple(MODEL_LAYERS["dqn"]),
                                    config=tiny))
    assert svc.run()[rid].result.best_hw is not None
    worker = svc.executor.probe()
    assert worker["jax_modules"] == [] == worker["repro_modules"], worker
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("LOADED", bad)
"""


def test_port_loads_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", _HYGIENE], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "LOADED []" in proc.stdout, proc.stdout


_NO_CUDA = r"""
import numpy as np
import torch
from repro_torch.core import (GP, CodesignConfig, CodesignEngine,
                              SoftwareSpace, optimize_software)
from repro_torch.timeloop import MODEL_LAYERS, eyeriss_168
from repro_torch.timeloop import batch as tlb, batch_torch as ttlb
from repro_torch.configs.base import get_smoke_config
from repro_torch.kernels import ops
from repro_torch.launch import serve, train
from repro_torch.models.lm import LM
from repro_torch.core import relax_round_bo
from repro_torch.service import CodesignService, ServiceRequest
assert not torch.cuda.is_available()


def _serve_default():
    svc = CodesignService()
    svc.submit(ServiceRequest(layers=tuple(MODEL_LAYERS["dqn"])))
    svc.run()


layer = MODEL_LAYERS["dqn"][0]
pool = tlb.sample_valid_pool(np.random.default_rng(0), eyeriss_168(), layer, 8)
calls = {
    "engine": lambda: CodesignEngine(CodesignConfig()),
    "space": lambda: SoftwareSpace(eyeriss_168(), layer),
    "search": lambda: optimize_software(eyeriss_168(), layer, n_trials=2,
                                        n_warmup=1, pool_size=4),
    "gp": lambda: GP().fit(np.zeros((3, 2)), np.zeros(3)),
    "forward": lambda: ttlb.forward_device(eyeriss_168(), pool, layer),
    "lm": lambda: LM(get_smoke_config("smollm-360m")),
    "serve": lambda: serve.main(["--arch", "smollm-360m", "--smoke"]),
    "train": lambda: train.main(["--arch", "smollm-360m", "--smoke",
                                 "--steps", "1"]),
    "train_lm": lambda: LM(get_smoke_config("smollm-360m"), train=True),
    "matmul": lambda: ops.matmul(np.ones((8, 8)), np.ones((8, 8))),
    "attention": lambda: ops.attention(*[np.ones((1, 64, 2, 8))] * 3),
    "service": lambda: _serve_default(),
    "baseline": lambda: relax_round_bo(
        SoftwareSpace(eyeriss_168(), layer, backend="numpy"), n_trials=2,
        n_warmup=1),
}
for name, call in calls.items():
    try:
        call()
    except RuntimeError as e:
        assert "'cuda'" in str(e), (name, e)
        print("RAISED", name)
    else:
        print("RAN", name)
"""


def test_default_device_raises_without_cuda():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", _NO_CUDA], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    for name in ("engine", "space", "search", "gp", "forward", "lm", "serve",
                 "train", "train_lm", "matmul", "attention", "service",
                 "baseline"):
        assert f"RAISED {name}" in proc.stdout, proc.stdout


def test_process_executor_is_not_ported_yet():
    # It is ported now: the engine takes the process kind and builds its
    # pool lazily, at the first fan-out.
    from repro_torch.parallel import ProcessExecutor

    cfg = CodesignConfig(engine=EngineConfig(
        device="cpu", executor=ExecutorConfig(kind="process", n_workers=2)))
    engine = CodesignEngine(cfg)
    assert isinstance(engine.executor, ProcessExecutor)
    assert engine.executor.n_workers == 2 and not engine.executor._procs
    engine.close()


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_module_of_the_port_imports_jax_or_repro():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    subpackages = {p.parent.name for p in files}
    assert {"core", "kernels", "parallel", "service", "workloads",
            "timeloop", "models", "launch", "configs", "data", "optim",
            "checkpoint", "runtime"} <= subpackages
    for path in [*files, REPO / "chip_smoke.py"]:
        bad = _imported_roots(path) & {"jax", "jaxlib", "repro"}
        assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


@pytest.mark.parametrize("field,value", [
    ("backend", "jax"), ("device", "tpu"), ("device", "cuda:x"),
    ("strategy", "auto2")])
def test_engine_config_validates(field, value):
    with pytest.raises(ValueError, match=field):
        EngineConfig(**{field: value})


def test_auto_strategy_resolves_by_backend():
    assert EngineConfig(backend="torch").resolve_strategy() == "layer_batched"
    assert EngineConfig(backend="numpy").resolve_strategy() == "sequential"
    assert EngineConfig().backend == "torch"
    assert EngineConfig().device == "cuda"
