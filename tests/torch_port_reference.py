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


def run_reference(spec: dict, arrays: dict, workdir, timeout: int = 600,
                  host_devices: int | None = None) -> dict:
    """Run one task of this script on `arrays` in a fresh interpreter and
    return its outputs.  `host_devices` sets XLA's host device count in the
    child only (`--xla_force_host_platform_device_count`), for the tasks
    that build meshes.  Raises with the child's stderr if it fails."""
    workdir = Path(workdir)
    src, dst = workdir / "ref_in.npz", workdir / "ref_out.npz"
    np.savez(src, spec=np.array(json.dumps(spec)), **arrays)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    if host_devices:
        env["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count="
                            f"{host_devices}")
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


def pack(obj) -> np.ndarray:
    """A pickle of plain data (a session snapshot's image) as a uint8 array,
    for the npz files this script reads and writes."""
    import pickle

    return np.frombuffer(pickle.dumps(obj), dtype=np.uint8)


def unpack(a: np.ndarray):
    import pickle

    return pickle.loads(np.asarray(a, np.uint8).tobytes())


def _codesign_outputs(result, name: str, out: dict) -> dict:
    out[name + "_sha256"] = np.array(
        hashlib.sha256(_canonical(result).encode()).hexdigest())
    out[name + "_log10_edp"] = np.array(np.log10(result.best_model_edp))
    out[name + "_history"] = np.asarray(result.hw_result.history)
    return out


def task_session(spec, arrays) -> dict:
    """`SearchSession` snapshots across the packages.  Case mode "take":
    the search stepped `steps` times, its snapshot's plain image
    (`repro_torch.convert.map_session_snapshot` with `astuple`, pickled)
    and the uninterrupted run's design hash, log10 EDP and history.  Mode
    "finish": a session restored from the image in `<name>_snapshot`
    (hardware, mappings and layers rebuilt as reference objects), run to
    its end, and the same three outputs."""
    from repro.core import CodesignConfig, CodesignEngine
    from repro.timeloop import MODEL_LAYERS
    from repro.timeloop.arch import hw_from_tuple
    from repro.timeloop.mapping import Mapping
    from repro.timeloop.workloads import ConvLayer
    from repro_torch.convert import map_session_snapshot

    out = {}
    for case in spec["cases"]:
        name, layers = case["name"], MODEL_LAYERS[case["model"]]
        cfg = CodesignConfig.from_dict(case["config"])
        session = CodesignEngine(cfg).session(layers)
        if case["mode"] == "take":
            for _ in range(case["steps"]):
                session.step()
            image = map_session_snapshot(
                session.snapshot(), *(dataclasses.astuple,) * 3)
            out[name + "_snapshot"] = pack(image)
            _codesign_outputs(CodesignEngine(cfg).run(layers), name, out)
        else:
            snap = map_session_snapshot(
                unpack(arrays[name + "_snapshot"]), hw_from_tuple,
                lambda t: Mapping(*t), lambda t: ConvLayer(*t))
            session.restore(snap)
            while session.step():
                pass
            _codesign_outputs(session.result(), name, out)
    return out


def task_examples(spec, arrays) -> dict:
    """The original example scripts (`examples/<script>`) run in this
    process with each case's argv, their standard output captured.  A case
    may cut the quickstart's budgets ("budget": the BO's and random
    search's trial counts, warm-up and pool) or replace fields of
    train_100m's configuration ("config"); a train case also returns the
    weights the script starts from (its `init_train_state` draw) under
    `<name>_init/<path>`."""
    import contextlib
    import importlib.util
    import io

    out = {}
    for case in spec["cases"]:
        name = case["name"]
        path = REPO / "examples" / case["script"]
        mspec = importlib.util.spec_from_file_location(f"example_{name}",
                                                       path)
        mod = importlib.util.module_from_spec(mspec)
        mspec.loader.exec_module(mod)
        if "budget" in case:
            b = case["budget"]
            bo, rs = mod.bo_maximize, mod.random_search
            mod.bo_maximize = lambda space, bo=bo, b=b, **kw: bo(
                space, **dict(kw, n_trials=b["n_trials"],
                              n_warmup=b["n_warmup"],
                              pool_size=b["pool_size"]))
            mod.random_search = lambda space, rs=rs, b=b, **kw: rs(
                space, **dict(kw, n_trials=b["n_trials"]))
        if "config" in case:
            import jax

            from repro.launch import steps as RS
            from repro.optim import adamw

            mod.CFG_100M = dataclasses.replace(mod.CFG_100M,
                                               **case["config"])
            model, _ = RS.make_train_step(mod.CFG_100M, adamw.AdamWConfig())
            state = RS.init_train_state(model, mod.CFG_100M,
                                        adamw.AdamWConfig(),
                                        jax.random.key(0))
            _flat(state["params"], f"{name}_init", out)
        buf, argv = io.StringIO(), sys.argv
        sys.argv = [str(path), *case["argv"]]
        try:
            with contextlib.redirect_stdout(buf):
                mod.main()
        finally:
            sys.argv = argv
        out[name + "_stdout"] = np.array(buf.getvalue())
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


def unflat(out: dict, prefix: str) -> dict:
    """The nested dict `_flat` wrote under `prefix` (indices stay string
    keys)."""
    tree: dict = {}
    for key, a in out.items():
        if not key.startswith(prefix + "/"):
            continue
        *path, leaf = key[len(prefix) + 1:].split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = a
    return tree


def _flat(tree, prefix: str, out: dict) -> dict:
    """Nested dicts, tuples and lists of arrays as `prefix/<path>` keys
    (tuple and list items by index)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flat(v, f"{prefix}/{k}", out)
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            _flat(v, f"{prefix}/{i}", out)
    else:
        a = np.asarray(tree)
        out[prefix] = a.astype(np.float32) if a.dtype.name == "bfloat16" else a
    return out


def _lm_config(case):
    from repro.configs.base import get_smoke_config

    return dataclasses.replace(get_smoke_config(case["arch"]),
                               **case.get("overrides", {}))


def _inputs(arrays, name: str, keys) -> dict:
    import jax.numpy as jnp

    return {k: jnp.asarray(arrays[f"{name}_{k}"]) for k in keys
            if f"{name}_{k}" in arrays}


_BATCH_KEYS = ("tokens", "embeddings", "src_embeddings", "positions",
               "labels")


def _case_arch(case, arrays) -> dict:
    """`build_model(cfg)` from `jax.random.key(seed)`: its parameters, the
    prefill's logits and cache, one decode step (its logits and cache), and
    the loss with its gradients."""
    import jax
    import jax.numpy as jnp

    from repro.models.model import build_model

    name = case["name"]
    cfg = _lm_config(case)
    model = build_model(cfg)
    params = model.init(jax.random.key(case["seed"]))
    batch = _inputs(arrays, name, _BATCH_KEYS)
    out = _flat(params, f"{name}/param", {})
    prefill = {k: v for k, v in batch.items() if k != "labels"}
    logits, cache = jax.jit(model.prefill)(params, prefill)
    out[f"{name}/logits"] = np.asarray(logits)
    _flat(cache, f"{name}/cache", out)
    step = {k[5:]: v for k, v in _inputs(
        arrays, name, ("step_tokens", "step_embeddings")).items()}
    logits, cache = jax.jit(model.decode_step)(
        params, cache, step, jnp.asarray(case["pos"], jnp.int32))
    out[f"{name}/decode_logits"] = np.asarray(logits)
    _flat(cache, f"{name}/decode_cache", out)
    loss, grads = jax.jit(jax.value_and_grad(model.loss))(params, batch)
    out[f"{name}/loss"] = np.asarray(loss)
    return _flat(grads, f"{name}/grad", out)


def _case_moe(case, arrays) -> dict:
    """`moe._moe_block_local` (no mesh) on x with `init_moe`'s weights, and
    the gradients of sum(out * g) in the weights and x."""
    import jax
    import jax.numpy as jnp

    from repro.models import moe

    name = case["name"]
    cfg = _lm_config(case)
    p = moe.init_moe(jax.random.key(case["seed"]), cfg, jnp.float32)
    x, g = jnp.asarray(arrays[name + "_x"]), jnp.asarray(arrays[name + "_g"])
    y = moe._moe_block_local(p, cfg, x)
    grads = jax.grad(lambda p, x: jnp.sum(moe._moe_block_local(p, cfg, x)
                                          * g), argnums=(0, 1))(p, x)
    out = _flat(p, f"{name}/param", {})
    out[f"{name}/out"] = np.asarray(y)
    return _flat(grads, f"{name}/grad", out)


def _case_rglru(case, arrays) -> dict:
    """`rglru_block` over the whole sequence (with its state; also from a
    given initial state) and step by step through `rglru_block_decode`."""
    import jax

    from repro.models import rglru

    name = case["name"]
    cfg = _lm_config(case)
    p = rglru.init_rglru_block(jax.random.key(case["seed"]), cfg, "float32")
    x = arrays[name + "_x"]
    out = _flat(p, f"{name}/param", {})
    full, state = rglru.rglru_block(p, cfg, x, return_state=True)
    out[f"{name}/full"] = np.asarray(full)
    _flat(state, f"{name}/state", out)
    h0 = {"h": arrays[name + "_h0"], "conv": arrays[name + "_conv0"]}
    out[f"{name}/from_state"] = np.asarray(
        rglru.rglru_block(p, cfg, x, state=h0))
    st = rglru.init_rglru_state(cfg, x.shape[0])
    steps = []
    for t in range(x.shape[1]):
        o, st = rglru.rglru_block_decode(p, cfg, x[:, t:t + 1], st)
        steps.append(np.asarray(o))
    out[f"{name}/steps"] = np.concatenate(steps, axis=1)
    return _flat(st, f"{name}/step_state", out)


def _case_mlstm(case, arrays) -> dict:
    """`mlstm_chunkwise` at each chunk length, and the recurrent steps."""
    from repro.models import xlstm

    name = case["name"]
    q, k, v, ig, fg = (arrays[f"{name}_{t}"] for t in ("q", "k", "v", "ig",
                                                        "fg"))
    out = {}
    for chunk in case["chunks"]:
        o, st = xlstm.mlstm_chunkwise(q, k, v, ig, fg, chunk)
        out[f"{name}/chunk{chunk}"] = np.asarray(o)
        _flat(st, f"{name}/chunk{chunk}_state", out)
    B, S, H, dh = q.shape
    st = (np.zeros((B, H, dh, dh), np.float32), np.zeros((B, H, dh),
                                                         np.float32),
          np.full((B, H), -1e30, np.float32))
    steps = []
    for t in range(S):
        o, st = xlstm.mlstm_recurrent_step(q[:, t], k[:, t], v[:, t],
                                           ig[:, t], fg[:, t], st)
        steps.append(np.asarray(o))
    out[f"{name}/steps"] = np.stack(steps, axis=1)
    return _flat(st, f"{name}/steps_state", out)


def _case_xlstm_blocks(case, arrays) -> dict:
    """The mLSTM block (full, prefill with state, one decode step) and the
    sLSTM block (the scan with its state, one decode step)."""
    import jax

    from repro.models import xlstm

    name = case["name"]
    cfg = _lm_config(case)
    km, ks = jax.random.split(jax.random.key(case["seed"]))
    pm = xlstm.init_mlstm_block(km, cfg, "float32")
    ps = xlstm.init_slstm_block(ks, cfg, "float32")
    x, x1 = arrays[name + "_x"], arrays[name + "_x1"]
    out = _flat(pm, f"{name}/mparam", {})
    _flat(ps, f"{name}/sparam", out)
    out[f"{name}/mlstm"] = np.asarray(xlstm.mlstm_block(pm, cfg, x))
    o, st = xlstm.mlstm_block_prefill(pm, cfg, x)
    _flat(st, f"{name}/mlstm_state", out)
    o, st = xlstm.mlstm_block_decode(pm, cfg, x1, st)
    out[f"{name}/mlstm_decode"] = np.asarray(o)
    _flat(st, f"{name}/mlstm_decode_state", out)
    o, st = xlstm.slstm_block(ps, cfg, x, return_state=True)
    out[f"{name}/slstm"] = np.asarray(o)
    _flat(st, f"{name}/slstm_state", out)
    o, st = xlstm.slstm_block_decode(ps, cfg, x1, st)
    out[f"{name}/slstm_decode"] = np.asarray(o)
    return _flat(st, f"{name}/slstm_decode_state", out)


def _case_slstm_scan(case, arrays) -> dict:
    """The sLSTM's scan as `slstm_block` runs it (`jax.lax.scan` of
    `_slstm_step`) on given gate pre-activations, recurrent weights and
    carry, with its VJP for given cotangents (`jax.vjp`); and the whole
    block from a zero state with the gradient of sum(out * w) over its
    parameters and input."""
    import jax
    import jax.numpy as jnp

    from repro.models import xlstm

    name = case["name"]
    cfg = _lm_config(case)
    g = {k: jnp.asarray(arrays[f"{name}_g{k}"]) for k in "ifzo"}
    r = {k: jnp.asarray(arrays[f"{name}_r{k}"]) for k in "ifzo"}
    c0 = {k: jnp.asarray(arrays[f"{name}_{k}0"]) for k in "hcnm"}

    def scan(g, r, c0):
        p = {f"r_{k}": v for k, v in r.items()}

        def step(c, xs):
            new = xlstm._slstm_step(p, cfg, c, xs)
            return new, new["h"]

        carry, hs = jax.lax.scan(step, c0, jax.tree.map(
            lambda a: a.swapaxes(0, 1), g))
        B, S = g["i"].shape[:2]
        return hs.swapaxes(0, 1).reshape(B, S, cfg.num_heads, -1), carry

    (hs, last), vjp = jax.vjp(scan, g, r, c0)
    dg, dr, dc = vjp((jnp.asarray(arrays[name + "_dhs"]),
                      {k: jnp.asarray(arrays[f"{name}_d{k}"])
                       for k in "hcnm"}))
    out = {f"{name}/hs": np.asarray(hs)}
    _flat(last, f"{name}/last", out)
    _flat({"g": dg, "r": dr, "c": dc}, f"{name}/grad", out)
    ps = xlstm.init_slstm_block(jax.random.key(case["seed"]), cfg, "float32")
    x, w = jnp.asarray(arrays[name + "_x"]), jnp.asarray(arrays[name + "_w"])

    def block(ps, x):
        return jnp.sum(xlstm.slstm_block(ps, cfg, x) * w)

    out[f"{name}/block"] = np.asarray(xlstm.slstm_block(ps, cfg, x))
    gp, gx = jax.grad(block, argnums=(0, 1))(ps, x)
    _flat(ps, f"{name}/param", out)
    _flat(gp, f"{name}/block_grad", out)
    out[f"{name}/block_grad_x"] = np.asarray(gx)
    return out


def _case_window(case, arrays) -> dict:
    """Local attention: the windowed prefill (flash and naive) with its
    rolling cache, then rolling-window decode steps from it; and windowed
    `attention_decode` over a full cache."""
    import jax
    import jax.numpy as jnp

    from repro.models import layers as L

    name = case["name"]
    cfg = _lm_config(case)
    W = case["window"]
    p = L.init_attention(jax.random.key(case["seed"]), cfg, jnp.float32)
    x, xs = arrays[name + "_x"], arrays[name + "_steps"]
    B, S, _ = x.shape
    positions = np.broadcast_to(np.arange(S)[None], (B, S))
    spec = L.CacheSpec(S, cfg.kv_cache_dtype)
    out = _flat(p, f"{name}/param", {})
    o, cache = L.attention_prefill(p, cfg, x, positions, W, spec)
    out[f"{name}/prefill"] = np.asarray(o)
    _flat(cache, f"{name}/prefill_cache", out)
    naive = dataclasses.replace(cfg, attn_impl="naive")
    out[f"{name}/prefill_naive"] = np.asarray(
        L.attention(p, naive, x, positions, W))
    steps = []
    for t in range(xs.shape[1]):
        o, cache = L.attention_decode_windowed(p, cfg, xs[:, t:t + 1], cache,
                                               jnp.asarray(S + t, jnp.int32))
        steps.append(np.asarray(o))
    out[f"{name}/steps"] = np.concatenate(steps, axis=1)
    _flat(cache, f"{name}/steps_cache", out)
    _, full = L.attention_prefill(p, cfg, x, positions, 0,
                                  L.CacheSpec(S, cfg.kv_cache_dtype))
    full = {k: jnp.concatenate([v, jnp.zeros_like(v[:, :1])], axis=1)
            for k, v in full.items()}
    o, _ = L.attention_decode(p, cfg, xs[:, :1], full,
                              jnp.asarray(S, jnp.int32), W)
    out[f"{name}/decode_window"] = np.asarray(o)
    return out


def _case_mrope(case, arrays) -> dict:
    from repro.models import layers as L

    name = case["name"]
    return {f"{name}/out": np.asarray(L.apply_mrope(
        arrays[name + "_x"], arrays[name + "_positions"]))}


def _case_serve(case, arrays) -> dict:
    """`repro.launch.serve.main(argv)` on the smoke config with
    `overrides`: every request's tokens, and the weights it drew."""
    import jax

    from repro.launch import serve
    from repro.models.model import build_model

    name = case["name"]
    cfg = _lm_config(case)
    serve.get_smoke_config = lambda arch: cfg
    done = serve.main(case["argv"])
    out = {f"{name}/tokens": np.asarray([r.out_tokens for r in done]),
           f"{name}/rids": np.asarray([r.rid for r in done])}
    seed = int(case["argv"][case["argv"].index("--seed") + 1])
    return _flat(build_model(cfg).init(jax.random.key(seed)),
                 f"{name}/param", out)


_MODEL_CASES = {"arch": _case_arch, "moe": _case_moe, "rglru": _case_rglru,
                "mlstm": _case_mlstm, "xlstm_blocks": _case_xlstm_blocks,
                "slstm_scan": _case_slstm_scan,
                "window": _case_window, "mrope": _case_mrope,
                "serve": _case_serve}


def task_models(spec, arrays) -> dict:
    """The LM stack's modules and models (`repro.models`, `repro.launch.
    serve`) on the CPU in f32, one entry of `_MODEL_CASES` a case; outputs
    under `<case name>/...` keys (nested trees flattened by `_flat`)."""
    out = {}
    for case in spec["cases"]:
        out.update(_MODEL_CASES[case["kind"]](case, arrays))
    return out


def _spec_json(spec) -> list:
    """A PartitionSpec's entries as JSON: None, a name, or a list of names
    (a tuple entry, kept even with one name)."""
    return [list(a) if isinstance(a, tuple) else a for a in tuple(spec)]


def _jmesh(shape):
    import jax

    names = ("pod", "data", "model")[-len(shape):]
    return jax.make_mesh(tuple(shape), names,
                         axis_types=(jax.sharding.AxisType.Auto,) * len(shape))


def _rules(kw):
    from repro.parallel.sharding import AxisRules

    return AxisRules(**kw)


def task_sharding(spec, arrays) -> dict:
    """`repro.parallel.sharding` and `repro.launch.steps`' specs, as JSON:
    every parameter leaf's spec of each arch under each (mesh, rules), the
    batch and decode-cache specs of each applicable cell, `_filter_spec` and
    `batch_axes_for` on the given cases, and `make_mesh_for`'s shapes."""
    import jax

    from repro.configs.base import SHAPES, cell_is_applicable, get_config
    from repro.launch import steps
    from repro.launch.mesh import make_mesh_for
    from repro.models.model import build_model
    from repro.parallel import sharding

    res: dict = {"params": {}, "batch": {}, "cache": {}, "filter": [],
                 "batch_axes": [], "mesh_for": {}}

    def path_str(path):
        return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)

    meshes = {tuple(m): _jmesh(m) for m in spec["meshes"]}
    for arch in spec["archs"]:
        cfg = get_config(arch)
        shapes = build_model(cfg).param_shapes()
        flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
        for mshape, mesh in meshes.items():
            for ri, kw in enumerate(spec["rules"]):
                rules = _rules(kw)
                res["params"][f"{arch}|{mshape}|{ri}"] = {
                    path_str(p): _spec_json(sharding.param_spec(
                        path_str(p), leaf.shape, mesh, rules))
                    for p, leaf in flat}
    for arch, shape_name, mshape, ri in spec["cells"]:
        cfg, shape = get_config(arch), SHAPES[shape_name]
        assert cell_is_applicable(cfg, shape)[0]
        mesh, rules = meshes[tuple(mshape)], _rules(spec["rules"][ri])
        key = f"{arch}|{shape_name}|{tuple(mshape)}|{ri}"
        res["batch"][key] = {k: _spec_json(v.spec) for k, v in
                             steps.batch_sharding(cfg, shape, mesh,
                                                  rules).items()}
        cache = steps.cache_sharding(cfg, shape, mesh, rules)
        res["cache"][key] = {path_str(p): _spec_json(v.spec) for p, v in
                             jax.tree_util.tree_flatten_with_path(cache)[0]}
    for mshape, ri, axes in spec["filter"]:
        mesh = meshes[tuple(mshape)]
        axes = tuple(tuple(a) if isinstance(a, list) else a for a in axes)
        res["filter"].append(_spec_json(sharding._filter_spec(mesh, axes)))
    for mshape, ri, size in spec["batch_axes"]:
        with sharding.use_mesh(meshes[tuple(mshape)],
                               _rules(spec["rules"][ri])):
            a = sharding.batch_axes_for(size)
        res["batch_axes"].append(list(a) if isinstance(a, tuple) else a)
    for n in spec["mesh_for"]:
        res["mesh_for"][str(n)] = list(make_mesh_for(n).devices.shape)
    return {"json": np.array(json.dumps(res))}


def task_sharded(spec, arrays) -> dict:
    """The reference's mesh branches on a (2, 2) ("data", "model") mesh of
    4 host devices: `embed`, `softmax_xent` (value and gradients in x and
    the table), `moe_block`'s shard_map and a jitted train step of a 2-layer
    smoke config (FSDP on), with that config's initial parameters."""
    import jax
    import jax.numpy as jnp

    from repro.configs.base import ShapeConfig, get_smoke_config
    from repro.launch import steps
    from repro.models import layers as L
    from repro.models import moe as MOE
    from repro.optim import adamw
    from repro.parallel import sharding

    mesh = _jmesh((2, 2))
    out = {}
    with sharding.use_mesh(mesh, sharding.AxisRules()):
        table = jnp.asarray(arrays["table"])
        tokens = jnp.asarray(arrays["tokens"])
        out["embed"] = np.asarray(jax.jit(
            lambda t, k: L.embed({"embedding": t}, k))(table, tokens))
        x, labels = jnp.asarray(arrays["x"]), jnp.asarray(arrays["labels"])
        V = spec["vocab_size"]
        loss, (gx, gt) = jax.jit(jax.value_and_grad(
            lambda x, t: L.softmax_xent({"embedding": t}, x, labels, V),
            argnums=(0, 1)))(x, table)
        out.update(xent=np.asarray(loss), xent_gx=np.asarray(gx),
                   xent_gt=np.asarray(gt))
        mcfg = dataclasses.replace(get_smoke_config("moonshot-v1-16b-a3b"),
                                   **spec["moe_overrides"])
        mp = {k: jnp.asarray(arrays["moe_" + k]) for k in
              ("ln", "router", "expert_wi", "expert_wo")}
        out["moe"] = np.asarray(jax.jit(
            lambda p, x: MOE.moe_block(p, mcfg, x))(
                mp, jnp.asarray(arrays["moe_x"])))

    cfg = dataclasses.replace(get_smoke_config("smollm-360m"),
                              **spec["train_overrides"])
    shape = ShapeConfig("t", spec["seq"], spec["batch"], "train")
    rules = sharding.AxisRules()
    opt_cfg = adamw.AdamWConfig(state_dtype=cfg.optimizer_dtype)
    model, train_step = steps.make_train_step(cfg, opt_cfg)
    state = steps.init_train_state(model, cfg, opt_cfg,
                                   jax.random.key(spec["seed"]))
    _flat(state["params"], "param", out)
    batch = {"tokens": jnp.asarray(arrays["train_tokens"]),
             "labels": jnp.asarray(arrays["train_labels"])}
    with sharding.use_mesh(mesh, rules):
        state_shd = steps.state_shardings(model, mesh, rules)
        batch_shd = steps.batch_sharding(cfg, shape, mesh, rules)
        jf = jax.jit(train_step, in_shardings=(state_shd, batch_shd),
                     out_shardings=(state_shd, None))
        _, m = jf(jax.device_put(state, state_shd),
                  jax.device_put(batch, batch_shd))
    out["train_loss"] = np.asarray(m["loss"])
    out["train_grad_norm"] = np.asarray(m["grad_norm"])
    return out


def task_dryrun(spec, arrays) -> dict:
    """`repro.launch.dryrun`'s analytic part for every arch and shape:
    `count_params`, `model_flops` and `_depth_variant`, as JSON."""
    from repro.configs.base import SHAPES, get_config
    from repro.launch import dryrun as DR

    res = {}
    for arch in spec["archs"]:
        cfg = get_config(arch)
        res[arch] = {
            "count_params": list(DR.count_params(cfg)),
            "model_flops": {s: DR.model_flops(cfg, SHAPES[s])
                            for s in SHAPES},
            "depth": [[v.num_layers, v.encoder_layers, list(v.block_pattern)]
                      for v in (DR._depth_variant(cfg, n) for n in (1, 2, 3))],
        }
    return {"json": np.array(json.dumps(res))}


def task_autotune(spec, arrays) -> dict:
    """`repro.core.autotune`: `TuneSpace.sample`, `is_valid` and `features`
    from NumPy seeds, and `autotune` with `TuneSpace.evaluate` replaced by
    the fixed objective `autotune_objective` (every evaluated point in order
    and the best one), as JSON."""
    from repro.configs.base import SHAPES, get_config
    from repro.core import autotune as AT

    res = {"samples": [], "runs": []}
    cfg, shape = get_config(spec["arch"]), SHAPES[spec["shape"]]
    space = AT.TuneSpace(cfg, shape)
    for seed in spec["sample_seeds"]:
        rng = np.random.default_rng(seed)
        for _ in range(spec["n_samples"]):
            t = space.sample(rng)
            res["samples"].append([list(dataclasses.astuple(t)),
                                   bool(space.is_valid(t)),
                                   space.features(t).tolist()])
    AT.TuneSpace.evaluate = lambda self, t: autotune_objective(
        self.features(t))
    for seed in spec["bo_seeds"]:
        best, result = AT.autotune(cfg, shape, seed=seed, **spec["bo_kw"])
        res["runs"].append({"best": list(dataclasses.astuple(best)),
                            "points": [list(dataclasses.astuple(p))
                                       for p in result.points]})
    return {"json": np.array(json.dumps(res))}


def autotune_objective(f) -> tuple:
    """A fixed objective of the tune features for holding the two BO loops
    to each other: infeasible at the widest model axis (the unknown
    constraint), else a smooth function of every feature."""
    f = np.asarray(f, np.float64)
    if f[1] >= 6:
        return None, False
    w = np.array([0.3, -0.2, 0.25, -0.15, 0.05, -0.07, 0.11])
    return float(w @ f - 0.02 * (f[0] - 4.0) ** 2), True


TASKS = {"batch": task_batch, "gp": task_gp, "codesign": task_codesign,
         "baselines": task_baselines, "train": task_train,
         "models": task_models, "sharding": task_sharding,
         "sharded": task_sharded, "dryrun": task_dryrun,
         "autotune": task_autotune, "session": task_session,
         "examples": task_examples}


# ------------------------------------------------- the port's side of a case
# Used by the tests in their own process: torch and repro_torch only.

F32 = {"compute_dtype": "float32", "kv_cache_dtype": "float32"}


def port_config(arch: str, overrides: dict | None = None):
    from repro_torch.configs.base import get_smoke_config

    return dataclasses.replace(get_smoke_config(arch), **(overrides or {}))


def arch_case(name: str, arch: str, rng, B: int = 2, S: int = 32,
              overrides: dict | None = None):
    """(case, arrays) of an "arch" case: the smoke config in f32, a batch of
    its inputs and labels, a decode step at S - 1 (the reference's smoke
    test), M-RoPE positions in three distinct sections."""
    overrides = dict(F32, **(overrides or {}))
    cfg = port_config(arch, overrides)
    D = cfg.d_model
    arrays = {}
    if cfg.family == "encdec":
        arrays[name + "_src_embeddings"] = rng.normal(
            size=(B, 8, D)).astype(np.float32)
    if cfg.input_mode == "embeddings" and cfg.family != "encdec":
        arrays[name + "_embeddings"] = rng.normal(
            size=(B, S, D)).astype(np.float32)
        arrays[name + "_step_embeddings"] = rng.normal(
            size=(B, 1, D)).astype(np.float32)
    else:
        arrays[name + "_tokens"] = rng.integers(0, cfg.vocab_size,
                                                (B, S)).astype(np.int32)
        arrays[name + "_step_tokens"] = rng.integers(
            0, cfg.vocab_size, (B, 1)).astype(np.int32)
    if cfg.mrope:
        t = np.arange(S)
        arrays[name + "_positions"] = np.broadcast_to(
            np.stack([t, t // 4, t % 4])[:, None], (3, B, S)).astype(np.int32)
    arrays[name + "_labels"] = rng.integers(0, cfg.vocab_size,
                                            (B, S)).astype(np.int32)
    case = {"kind": "arch", "name": name, "arch": arch,
            "overrides": overrides, "seed": 0, "pos": S - 1}
    return case, arrays


def assert_close(got, want, bar: float, what: str = "",
                 scale: float | None = None) -> float:
    """max|got - want| <= bar * scale, the scale max|want| by default (1
    where want is all zero); returns the error as that share."""
    import torch

    if isinstance(got, torch.Tensor):
        got = got.detach().float().cpu().numpy()
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    if scale is None:
        scale = (np.abs(want).max() if want.size and np.abs(want).max() > 0
                 else 1.0)
    err = float(np.abs(got - want).max() / scale) if want.size else 0.0
    assert err <= bar, (what, err, bar)
    return err


def assert_cache(got: dict, want: dict, bar: float, what: str) -> None:
    """One cache entry (KV cache or recurrent state): integer leaves equal,
    float leaves within `bar` of their largest magnitude."""
    assert sorted(got) == sorted(want), (what, sorted(got), sorted(want))
    for key, a in want.items():
        g = got[key]
        if np.asarray(a).dtype.kind in "iu":
            np.testing.assert_array_equal(g.cpu().numpy(), a,
                                          err_msg=f"{what} {key}")
        else:
            assert_close(g, a, bar, f"{what} {key}")


# Leaves whose gradient is zero in exact arithmetic, so what either package
# computes for them is rounding noise that no relative bar can hold:
# - a top-1 router (llama4): the routing weight w / (w + 1e-9) is 1 whatever
#   w is; the smoke config's largest reference router gradient is 4.6e-10
#   against a largest model gradient near 5e-2;
# - the sLSTM input-gate bias: h = o * c / n, and c and n both sum the same
#   input-gate weights from a zero state, so a shift of b_i cancels; the
#   largest reference b_i gradient is 2.0e-10.
NOISE_BAR = 1e-6


def zero_gradient_leaves(cfg) -> tuple:
    """The name suffixes of `cfg`'s leaves whose gradient is exactly zero."""
    return ("slstm.b_i",) + (("router",) if cfg.top_k == 1 else ())


def assert_grads(got: dict, want: dict, bar: float = 1e-4,
                 zero: tuple = ()) -> float:
    """Each gradient leaf within `bar` of its own largest reference value.
    The leaves named in `zero` (a suffix of the name) have a gradient that
    is zero in exact arithmetic: both packages must then keep it below
    `NOISE_BAR` of the largest gradient of the whole tree.  Returns the
    largest error of the other leaves."""
    assert sorted(want) == sorted(got), (sorted(want), sorted(got))
    top = max(float(np.abs(w).max()) for w in want.values())
    errs = [0.0]
    for k, w in want.items():
        if any(k.endswith(z) for z in zero):
            noise = max(float(np.abs(w).max()),
                        float(got[k].detach().abs().max()))
            assert noise <= NOISE_BAR * top, (f"grad {k}", noise, top)
        else:
            errs.append(assert_close(got[k], w, bar, f"grad {k}"))
    return max(errs)


def port_params(out: dict, name: str, cfg):
    """The port state dict of the reference's `<name>/param` tree."""
    from repro_torch import convert

    tree = unflat(out, f"{name}/param")
    if cfg.family == "encdec":
        return convert.encdec_params_from_reference(tree)
    return convert.lm_params_from_reference(tree)


def check_arch(out: dict, arrays: dict, case: dict, bar: float = 1e-5,
               grad_bar: float = 1e-4) -> dict:
    """The port against an "arch" case's reference outputs: prefill logits
    and cache, one decode step (logits and cache; the decoder-only models
    also from the reference's cache, carried over by `convert`) and the
    loss within `bar`
    of their largest magnitude; every gradient leaf as `assert_grads` holds
    it.  Returns the largest errors."""
    import torch

    from repro_torch import convert
    from repro_torch.models.model import build_model

    name = case["name"]
    cfg = port_config(case["arch"], case["overrides"])
    state = port_params(out, name, cfg)
    model = build_model(cfg, "cpu").load_params(state)
    batch = {k: arrays[f"{name}_{k}"] for k in _BATCH_KEYS
             if f"{name}_{k}" in arrays}
    inputs = {k: v for k, v in batch.items() if k != "labels"}
    logits, cache = model.prefill(inputs)
    errs = {"logits": assert_close(logits, out[f"{name}/logits"], bar,
                                   "prefill")}
    step = {k[5:]: arrays[f"{name}_{k}"] for k in ("step_tokens",
                                                   "step_embeddings")
            if f"{name}_{k}" in arrays}
    for tag in ("cache", "decode_cache"):
        ref = unflat(out, f"{name}/{tag}")
        if cfg.family == "encdec":
            caches, enc = cache
            got = {k: torch.stack([c["self"][k] for c in caches])
                   for k in caches[0]["self"]}
            assert_cache(got, ref["0"]["self"], bar, tag)
            assert_close(enc, ref["1"], bar, "encoder output")
        else:
            got = convert.lm_cache_to_reference(cache, len(cfg.block_pattern))
            assert sorted(got) == sorted(ref)
            for pos, leaves in ref.items():
                assert_cache({k: torch.from_numpy(v) for k, v in
                              got[pos].items()}, leaves, bar, f"{tag} {pos}")
        if tag == "cache":
            if cfg.family != "encdec":
                # the decode step also runs from the reference's own cache
                theirs = convert.lm_cache_from_reference(ref, cfg.num_layers)
                assert_close(model.decode_step(theirs, step, case["pos"])[0],
                             out[f"{name}/decode_logits"], bar,
                             "decode from the reference's cache")
            logits, cache = model.decode_step(cache, step, case["pos"])
            errs["decode"] = assert_close(
                logits, out[f"{name}/decode_logits"], bar, "decode")
    trainer = build_model(cfg, "cpu", train=True)
    params = {k: v.clone().requires_grad_() for k, v in state.items()}
    loss = trainer.loss(batch, params)
    errs["loss"] = assert_close(loss, out[f"{name}/loss"], bar, "loss")
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    tree = unflat(out, f"{name}/grad")
    want = (convert.encdec_params_from_reference(tree)
            if cfg.family == "encdec"
            else convert.lm_params_from_reference(tree))
    errs["grad"] = assert_grads(grads, {k: w.numpy() for k, w in
                                        want.items()}, grad_bar,
                                zero_gradient_leaves(cfg))
    return errs


def serve_case(name: str, arch: str, argv: list) -> dict:
    return {"kind": "serve", "name": name, "arch": arch, "overrides": F32,
            "argv": ["--arch", arch, "--smoke", *argv]}


def check_serve(out: dict, case: dict) -> list:
    """`repro_torch.launch.serve.main` on the reference's weights: the
    reference's request ids and tokens.  Returns the tokens."""
    from repro_torch.launch import serve

    name = case["name"]
    cfg = port_config(case["arch"], case["overrides"])
    done = serve.main([*case["argv"], "--device", "cpu"], config=cfg,
                      params=port_params(out, name, cfg))
    assert [r.rid for r in done] == out[f"{name}/rids"].tolist()
    tokens = [r.out_tokens for r in done]
    assert tokens == out[f"{name}/tokens"].tolist()
    return tokens


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
