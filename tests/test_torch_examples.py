"""The port's drivers for `examples/` (`examples/*_torch.py`) against the
original scripts.

Each twin runs in a subprocess on the CPU (`--device cpu`, one thread) at
its smoke size; the original runs through the reference shim
(`tests/torch_port_reference.py`, task "examples") at the same size, and
what each prints as its result is compared:

  * quickstart (`--tiny`: 30 trials, 10 warm-up, pools of 30; the
    original's budgets cut to the same): the random search's and the BO's
    EDP lines and the best mapping, equal;
  * codesign_dqn, codesign_service, codesign_portfolio (`--tiny`; the
    portfolio over dqn and mlp): the port's torch backend against the
    reference's jax backend -- the co-designed EDPs and hardware, each
    request's model EDP, the best chip, member EDPs and Pareto front,
    equal;
  * train_100m (`--tiny`: 2 layers, d_model 64, f32, 12 steps of batch 2 x
    32; the original's configuration cut to the same): the twin starts from
    the original's own initial weights (`--init-from`) and its mean losses
    of the first and last ten steps equal the original's printed ones to
    their last printed digit (1e-3).

Also: without CUDA every twin refuses the default device, exit code 1 with
the reason on stderr (no fall back to the CPU).
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from torch_port_reference import run_reference

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = REPO / "examples"
TRAIN_ARGV = ["--steps", "12", "--batch", "2", "--seq", "32",
              "--inject-fault", "-1"]
TRAIN_TINY = {"name": "repro-100m-tiny", "num_layers": 2, "d_model": 64,
              "num_heads": 4, "num_kv_heads": 2, "d_ff": 128,
              "vocab_size": 256, "compute_dtype": "float32"}

# name: (twin argv, original argv, extra fields of the reference case)
CASES = {
    "quickstart": (["--tiny"], [],
                   {"budget": {"n_trials": 30, "n_warmup": 10,
                               "pool_size": 30}}),
    "codesign_dqn": (["--tiny"], ["--tiny", "--backend", "jax"], {}),
    "codesign_service": (["--tiny"], ["--tiny", "--backend", "jax"], {}),
    "codesign_portfolio": (["--tiny", "--workloads", "dqn,mlp"],
                           ["--tiny", "--workloads", "dqn,mlp",
                            "--backend", "jax"], {}),
    "train_100m": (["--tiny", *TRAIN_ARGV], TRAIN_ARGV,
                   {"config": TRAIN_TINY}),
}


def _env(**extra) -> dict:
    return dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1",
                MKL_NUM_THREADS="1", **extra)


def _twin(name: str, argv: list) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, str(EXAMPLES / f"{name}_torch.py"), *argv,
         "--device", "cpu"], env=_env(), cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _finish(proc: subprocess.Popen) -> str:
    out, err = proc.communicate(timeout=900)
    assert proc.returncode == 0, err[-4000:]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{name: (twin stdout, original stdout)}: the co-design twins start
    first and run beside the reference; the training twin starts from the
    weights the reference run reports."""
    d = tmp_path_factory.mktemp("examples")
    procs = {n: _twin(n, CASES[n][0]) for n in CASES if n != "train_100m"}
    cases = [{"name": n, "script": f"{n}.py", "argv": orig, **extra}
             for n, (_, orig, extra) in CASES.items()]
    try:
        ref = run_reference({"task": "examples", "cases": cases}, {}, d,
                            timeout=1200)
    finally:
        stdout = {n: _finish(p) for n, p in procs.items()}
    init = {k[len("train_100m_init/"):]: v for k, v in ref.items()
            if k.startswith("train_100m_init/")}
    np.savez(d / "init.npz", **init)
    stdout["train_100m"] = _finish(_twin("train_100m", [
        *CASES["train_100m"][0], "--init-from", str(d / "init.npz")]))
    return {n: (stdout[n], str(ref[n + "_stdout"])) for n in CASES}


def _lines(text: str, pattern: str) -> list[str]:
    found = [ln.rstrip() for ln in text.splitlines() if re.match(pattern, ln)]
    assert found, (pattern, text[-2000:])
    return found


def _after(text: str, marker: str) -> list[str]:
    lines = text.splitlines()
    i = next(i for i, ln in enumerate(lines) if ln.startswith(marker))
    return lines[i:]


def test_quickstart(runs):
    twin, orig = runs["quickstart"]
    pat = r"^(random|constrained BO)\s*:"
    assert _lines(twin, pat) == _lines(orig, pat)
    assert _after(twin, "best mapping") == _after(orig, "best mapping")


def test_codesign_dqn(runs):
    twin, orig = runs["codesign_dqn"]
    for pat in (r"^Eyeriss baseline", r"^co-designed:", r"^best hardware:",
                r"^  DQN-"):
        assert _lines(twin, pat) == _lines(orig, pat), pat


def test_codesign_service(runs):
    twin, orig = runs["codesign_service"]

    def edps(text):
        return re.findall(r"^\s+(\S+): model EDP (\S+)", text, re.M)

    assert edps(twin) == edps(orig) and len(edps(twin)) == 8


def test_codesign_portfolio(runs):
    twin, orig = runs["codesign_portfolio"]
    for pat in (r"^  best chip:", r"^  weighted-geomean EDP",
                r"^    (dqn|mlp): EDP", r"^  pareto front:",
                r"^    dqn=.* mlp="):
        assert _lines(twin, pat) == _lines(orig, pat), pat


def test_train_100m(runs):
    twin, orig = runs["train_100m"]

    def done(text):
        m = re.search(r"^done: loss (\S+) -> (\S+) ", text, re.M)
        assert m, text[-2000:]
        return float(m.group(1)), float(m.group(2))

    (a, b), (c, e) = done(twin), done(orig)
    assert b < a
    assert abs(a - c) <= 1e-3 and abs(b - e) <= 1e-3, ((a, b), (c, e))


@pytest.mark.parametrize("name", list(CASES))
def test_twin_refuses_a_missing_card(name):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, str(EXAMPLES / f"{name}_torch.py"),
                           *CASES[name][0]], env=_env(), cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1
    assert "CUDA is not available" in proc.stderr, proc.stderr[-2000:]
    assert "Traceback" not in proc.stderr


@pytest.mark.parametrize("name", list(CASES))
def test_twin_imports_no_jax_or_repro(name):
    from test_torch_port_rules import _imported_roots

    bad = _imported_roots(EXAMPLES / f"{name}_torch.py") & {"jax", "jaxlib",
                                                             "repro"}
    assert not bad, bad
    assert "repro_torch" in _imported_roots(EXAMPLES / f"{name}_torch.py")
