"""Run the JAX reference (`repro`) on inputs a port test made, in a process
of its own.

    python tests/torch_port_reference.py in.npz out.npz

`in.npz` holds a JSON `spec` (a task name and its cases) beside the arrays the
cases name; `out.npz` receives the reference's outputs as plain arrays.  The
tests of the PyTorch port (`tests/test_torch_*.py`) call `run_reference`,
which starts this script with `PYTHONPATH=src` and `JAX_PLATFORMS=cpu`, once
per test module.

This jax release spells the scoped x64 switch `jax.enable_x64`, while the
reference imports `jax.experimental.enable_x64`.  The alias is installed by
`main`, in the script's own process only and only when the attribute is
missing, so the reference runs unchanged and the pytest process never sees
the alias: importing this module (for `run_reference`) imports no jax.

Not a test module: pytest collects `test_*.py` only.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]


def run_reference(spec: dict, arrays: dict, workdir, timeout: int = 600) -> dict:
    """Run one task of this script on `arrays` in a fresh interpreter and
    return its outputs.  Raises with the child's stderr if it fails."""
    workdir = Path(workdir)
    src, dst = workdir / "ref_in.npz", workdir / "ref_out.npz"
    np.savez(src, spec=np.array(json.dumps(spec)), **arrays)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, __file__, str(src), str(dst)],
                          env=env, capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"reference run failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    with np.load(dst) as data:
        return {k: data[k] for k in data.files}


def _layer(ref):
    from repro.timeloop import MODEL_LAYERS

    model, i = ref
    return MODEL_LAYERS[model][i]


def _pool(arrays, key):
    from repro.timeloop.batch import MappingBatch

    f = arrays[key + "_factors"]
    arange = np.tile(np.arange(6, dtype=np.int64), (len(f), 1))
    return MappingBatch(factors=f, order_lb=arange,
                        order_gb=arrays[key + "_order_gb"],
                        order_dram=arrays[key + "_order_dram"])


def task_batch(spec, arrays) -> dict:
    """Cost-model engine: forward_device / forward_device_stacked /
    edp_lower_bounds_device on the given pools and hardware."""
    from repro.timeloop import batch_jax as jtlb
    from repro.timeloop.arch import hw_from_tuple

    out = {}
    for case in spec["cases"]:
        name, dtype = case["name"], case["dtype"]
        hws = [hw_from_tuple(t) for t in case["hw"]]
        layers = [_layer(r) for r in case["layers"]]
        if case["kind"] == "bounds":
            out[name + "_lb"] = jtlb.edp_lower_bounds_device(hws, layers,
                                                             dtype=dtype)
            continue
        if case["kind"] == "forward":
            res = jtlb.forward_device(hws[0], _pool(arrays, case["pools"][0]),
                                      layers[0], dtype=dtype)
        else:
            hw = hws[0] if len(hws) == 1 else hws
            res = jtlb.forward_device_stacked(
                hw, [_pool(arrays, k) for k in case["pools"]], layers,
                dtype=dtype)
        for k, v in res.items():
            out[f"{name}_{k}"] = np.asarray(v)
    return out


def _gp_state(prefix, state) -> dict:
    params, X, y, mask = state
    out = {f"{prefix}_param_{k}": np.asarray(v) for k, v in params.items()}
    out.update({f"{prefix}_X": np.asarray(X), f"{prefix}_y": np.asarray(y),
                f"{prefix}_mask": np.asarray(mask)})
    return out


def task_gp(spec, arrays) -> dict:
    """GP fits from scratch: fitted state, posteriors on a query pool, the
    fused stacked scoring, and the rank-1 append."""
    from repro.core import GP, GPClassifier, GPClassifierStack, GPStack

    out = {}
    for case in spec["cases"]:
        name, cls = case["name"], case["cls"]
        if cls in ("GP", "GPClassifier"):
            X, y = arrays[name + "_X"], arrays[name + "_y"]
            Xs = arrays[name + "_Xs"]
            if cls == "GP":
                gp = GP(kind=case["kind"], noisy=case["noisy"],
                        fit_tol=case.get("fit_tol", 0.0)).fit(X, y)
            else:
                clf = GPClassifier().fit(X, y > 0)
                gp = clf._gp
                out[name + "_prob"] = np.asarray(clf.prob_feasible_device(Xs))
            out.update(_gp_state(name, gp._state))
            mu, var = gp.posterior(Xs)
            out[name + "_mu"], out[name + "_var"] = mu, var
            if case.get("append"):
                Xa, ya = arrays[name + "_Xa"], arrays[name + "_ya"]
                for x, v in zip(Xa, ya):
                    gp.append_observation(x, float(v))
                out[name + "_mu_append"], out[name + "_var_append"] = (
                    gp.posterior(Xs))
            continue
        n_runs = case["runs"]
        Xs_list = [arrays[f"{name}_X{k}"] for k in range(n_runs)]
        ys_list = [arrays[f"{name}_y{k}"] for k in range(n_runs)]
        Xq = arrays[name + "_Xs"]
        if cls == "GPStack":
            st = GPStack(kind=case["kind"], noisy=case["noisy"]).fit(
                Xs_list, ys_list)
            best = arrays[name + "_best"]
            for acq in ("lcb", "ei"):
                idx, rows = st.score_device(Xq, best, acq, 1.0)
                out[f"{name}_idx_{acq}"], out[f"{name}_rows_{acq}"] = idx, rows
        else:
            clf = GPClassifierStack().fit(Xs_list, [y > 0 for y in ys_list])
            st = clf._stack
            out[name + "_prob"] = np.asarray(clf.prob_feasible_device(Xq))
        out.update(_gp_state(name, st._state))
        mu, var = st.posterior(Xq)
        out[name + "_mu"], out[name + "_var"] = mu, var
    return out


def _canonical(result) -> str:
    """The golden test's design text: hardware fields plus every layer's
    mapping fields (tests/test_golden.py)."""
    hw = dataclasses.astuple(result.best_hw)
    maps = sorted((n, dataclasses.astuple(m))
                  for n, m in result.best_mappings.items())
    return repr((hw, maps))


def task_codesign(spec, arrays) -> dict:
    """The nested search end to end on the named workloads with the given
    config dict (`CodesignConfig.from_dict`), num_pes per workload."""
    from repro.core import CodesignConfig, CodesignEngine
    from repro.timeloop import MODEL_LAYERS

    out = {}
    for model in spec["models"]:
        d = json.loads(json.dumps(spec["config"]))
        d["hw"]["num_pes"] = spec["num_pes"][model]
        result = CodesignEngine(CodesignConfig.from_dict(d)).run(
            MODEL_LAYERS[model])
        text = _canonical(result)
        out[model + "_sha256"] = np.array(
            hashlib.sha256(text.encode()).hexdigest())
        out[model + "_log10_edp"] = np.array(np.log10(result.best_model_edp))
        out[model + "_history"] = np.asarray(result.hw_result.history)
        out[model + "_design"] = np.array(json.dumps({
            "hw": dataclasses.astuple(result.best_hw),
            "maps": {n: dataclasses.astuple(m)
                     for n, m in result.best_mappings.items()},
            "layer_edps": result.layer_edps}))
    return out


def _mapping_tuple(m) -> list:
    return [[[int(f) for f in level] for level in m.factors],
            [str(d) for d in m.order_lb], [str(d) for d in m.order_gb],
            [str(d) for d in m.order_dram]]


def task_baselines(spec, arrays) -> dict:
    """The paper's baselines (`repro.core.baselines`) on one layer's
    `SoftwareSpace` on Eyeriss-168: every visited point, the values and the
    best-so-far history of each case."""
    from repro.core import SoftwareSpace, baselines
    from repro.timeloop import eyeriss_168

    out = {}
    for case in spec["cases"]:
        space = SoftwareSpace(eyeriss_168(), _layer(case["layer"]),
                              backend="numpy")
        res = getattr(baselines, case["baseline"])(space, **case["kwargs"])
        name = case["name"]
        out[name + "_history"] = np.asarray(res.history, np.float64)
        out[name + "_values"] = np.asarray(res.values, np.float64)
        out[name + "_points"] = np.array(json.dumps(
            [_mapping_tuple(p) for p in res.points]))
        out[name + "_best"] = np.array(json.dumps(
            _mapping_tuple(res.best_point) if res.best_point else None))
        out[name + "_n_infeasible"] = np.array(res.n_infeasible)
    return out


def task_train(spec, arrays) -> dict:
    """Whole training steps of the reference (`repro.launch.steps`'
    `make_train_step` under `jax.jit`, `repro.launch.train`'s
    AdamW config and `SyntheticSource` batches) on a config of
    `get_smoke_config(arch)` with `overrides`: each step's loss, grad norm
    and learning rate, and the initial parameters (`param/<path>` keys)."""
    import jax

    from repro.configs.base import ShapeConfig, get_smoke_config
    from repro.data.pipeline import DataConfig, SyntheticSource
    from repro.launch import steps
    from repro.optim import adamw

    cfg = dataclasses.replace(get_smoke_config(spec["arch"]),
                              **spec.get("overrides", {}))
    n = spec["steps"]
    opt_cfg = adamw.AdamWConfig(lr=spec["lr"], total_steps=n,
                                warmup_steps=max(n // 20, 10),
                                state_dtype=cfg.optimizer_dtype)
    model, train_step = steps.make_train_step(cfg, opt_cfg)
    jstep = jax.jit(train_step)
    state = steps.init_train_state(model, cfg, opt_cfg,
                                   jax.random.key(spec["seed"]))
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(state["params"])[0]:
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        out["param/" + key] = np.asarray(leaf)
    source = SyntheticSource(cfg, ShapeConfig("t", spec["seq"], spec["batch"],
                                              "train"),
                             DataConfig(seed=spec["seed"]))
    metrics = {"loss": [], "grad_norm": [], "lr": []}
    for step in range(n):
        state, m = jstep(state, source.batch(step))
        for k in metrics:
            metrics[k].append(float(m[k]))
    out.update({k: np.asarray(v, np.float64) for k, v in metrics.items()})
    return out


TASKS = {"batch": task_batch, "gp": task_gp, "codesign": task_codesign,
         "baselines": task_baselines, "train": task_train}


def main(argv) -> int:
    import jax
    import jax.experimental

    if not hasattr(jax.experimental, "enable_x64"):
        jax.experimental.enable_x64 = jax.enable_x64
    src, dst = argv[1], argv[2]
    with np.load(src) as data:
        arrays = {k: data[k] for k in data.files}
    spec = json.loads(str(arrays.pop("spec")))
    out = TASKS[spec["task"]](spec, arrays)
    np.savez(dst, **out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
