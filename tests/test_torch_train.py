"""The PyTorch port's training slice against the JAX reference: the data
pipeline, AdamW, `LM.loss` and its gradient (K3's backward through
`FlashAttentionFn`), whole train steps, checkpoints and the resilient loop.

The reference's LM, optimizer and attention oracle run in this process on the
CPU; its whole jitted train steps run in a process of their own
(`torch_port_reference.py`'s "train" task).  Parameters go from the
reference to the port through `convert.lm_params_from_reference`, optimizer
state through `convert.adamw_state_from_reference`, and every other input is
made with a NumPy seed.  On the CPU the port's attention runs K3's and
K3-bwd's plain versions, through the padding the card's kernels use.

Bars (stated where they are used):
  * f32 compute: loss within 1e-5 relative, every gradient leaf within 1e-5
    of that leaf's largest magnitude (measured 1.7e-7 and 1.7e-6).
  * bf16 compute: the reference rounds its flash scores to bf16 before the
    softmax and K3 does not (ROADMAP "bf16 flash scores"), and each package
    rounds its bf16 products in its own order: loss within 1e-3 relative,
    each gradient leaf within 1e-1 of its norm (measured 3.8e-5 and 2.2%).
  * AdamW on identical inputs: 1e-6 relative (plus 1e-6 of the leaf's
    largest magnitude, where p - lr * delta cancels); int8 values equal.
    `global_norm` sums the leaves in another order than the reference's
    sorted keys, which moves its last bits only.
  * Whole steps: losses within 1e-4 relative, grad norms within 1e-3
    (measured 1.7e-7 and 1.5e-7 over three f32 steps; after the first step an
    Adam update is ~sign(g) lr, so gradient elements near zero may move
    parameters by 2 lr between two correct implementations, and parameters
    are not compared after several steps).  `chip_smoke.py`'s train_parity
    holds the card to the CPU at the same bars.
  * Attention's gradient: f32 within 1e-5 of each gradient's largest
    magnitude, against autograd of the port's plain version and `jax.grad` of
    the reference's `repro.kernels.ref.flash_attention_ref`.
  * Data batches: bit-equal.  Checkpoint round trips and the loop's replay:
    bit-equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as ref_ckpt
from repro.configs.base import ShapeConfig as RefShapeConfig
from repro.configs.base import get_smoke_config as ref_get_smoke_config
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import Prefetcher as RefPrefetcher
from repro.data.pipeline import SyntheticSource as RefSource
from repro.kernels.ref import flash_attention_ref as ref_flash_attention
from repro.models.lm import LM as RefLM
from repro.optim import adamw as ref_adamw
from repro.runtime.fault_tolerance import StragglerMonitor as RefMonitor
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.base import ShapeConfig, get_smoke_config
from repro_torch.convert import (adamw_state_from_reference,
                                 lm_params_from_reference)
from repro_torch.data.pipeline import DataConfig, Prefetcher, SyntheticSource
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ref import flash_attention_bwd_ref
from repro_torch.kernels.ref import flash_attention_lse_ref
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.launch import steps
from repro_torch.launch import train
from repro_torch.models.lm import LM
from repro_torch.optim import adamw
from repro_torch.runtime.fault_tolerance import (InjectedFault, ResilientLoop,
                                                 StragglerMonitor)
from torch_port_reference import run_reference

ARCH = "smollm-360m"
B, S = 2, 64
F32_LOSS_RTOL, F32_GRAD_ATOL = 1e-5, 1e-5
BF16_LOSS_RTOL, BF16_GRAD_REL = 1e-3, 1e-1
ADAMW_RTOL = 1e-6
STEP_LOSS_RTOL, STEP_GNORM_RTOL = 1e-4, 1e-3
ATTN_GRAD_ATOL = 1e-5


def _configs(**kw):
    return (dataclasses.replace(ref_get_smoke_config(ARCH), **kw),
            dataclasses.replace(get_smoke_config(ARCH), **kw))


def _batch(cfg, step=0, seed=0):
    return RefSource(cfg, RefShapeConfig("t", S, B, "train"),
                     RefDataConfig(seed=seed)).batch(step)


def _models(ref_cfg, port_cfg, seed=0):
    ref = RefLM(ref_cfg)
    params = ref.init(jax.random.key(seed))
    port = LM(port_cfg, device="cpu", train=True).load_params(
        lm_params_from_reference(jax.tree.map(np.asarray, params)))
    return ref, params, port


def _value_and_grads(ref, params, port, batch):
    loss, grads = jax.value_and_grad(ref.loss)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    want = lm_params_from_reference(jax.tree.map(np.asarray, grads))
    ps = dict(port.named_parameters())
    got_loss = port.loss({k: torch.as_tensor(v) for k, v in batch.items()})
    got = dict(zip(ps, torch.autograd.grad(got_loss, list(ps.values()))))
    assert set(got) == set(want)
    return float(loss), float(got_loss.detach()), want, got


# ------------------------------------------------------------------- data

@pytest.mark.parametrize("seed,hosts,host", [(0, 1, 0), (3, 2, 1), (7, 4, 2)])
def test_synthetic_batches_bit_equal(seed, hosts, host):
    ref_cfg, cfg = _configs()
    ref = RefSource(ref_cfg, RefShapeConfig("t", 33, 8, "train"),
                    RefDataConfig(seed=seed, num_hosts=hosts, host_id=host))
    port = SyntheticSource(cfg, ShapeConfig("t", 33, 8, "train"),
                           DataConfig(seed=seed, num_hosts=hosts, host_id=host))
    for step in (0, 1, 17):
        want, got = ref.batch(step), port.batch(step)
        assert set(got) == set(want) == {"tokens", "labels"}
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert np.array_equal(got[k], want[k])


def test_prefetcher_batches_bit_equal():
    ref_cfg, cfg = _configs()
    ref = RefPrefetcher(RefSource(ref_cfg, RefShapeConfig("t", 16, 4, "train"),
                                  RefDataConfig(seed=1)), start_step=2)
    port = Prefetcher(SyntheticSource(cfg, ShapeConfig("t", 16, 4, "train"),
                                      DataConfig(seed=1)), start_step=2)
    try:
        for want_step in range(2, 5):
            (rs, rb), (ps, pb) = next(ref), next(port)
            assert rs == ps == want_step
            assert all(np.array_equal(rb[k], pb[k]) for k in rb)
    finally:
        ref.close()
        port.close()


# ------------------------------------------------------------------ AdamW

def _tree(rng, shapes, scale=1.0):
    return {k: (rng.normal(size=s) * scale).astype(np.float32)
            for k, s in shapes.items()}


SHAPES = {"a": (6, 5), "b.w": (40,), "c": (3, 4, 2)}


@pytest.mark.parametrize("step", [1, 5, 10, 57, 100, 250])
def test_schedule_matches_reference(step):
    cfg = ref_adamw.AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=200)
    pcfg = adamw.AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=200)
    want = float(ref_adamw.schedule(cfg, jnp.asarray(step, jnp.int32)))
    got = adamw.schedule(pcfg, torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=ADAMW_RTOL)


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = _tree(np.random.default_rng(0), SHAPES, 3.0)
    want, want_norm = ref_adamw.clip_by_global_norm(
        {k: jnp.asarray(v) for k, v in g.items()}, max_norm)
    got, norm = adamw.clip_by_global_norm(
        {k: torch.from_numpy(v) for k, v in g.items()}, max_norm)
    np.testing.assert_allclose(float(norm), float(want_norm), rtol=ADAMW_RTOL)
    for k in g:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=ADAMW_RTOL, atol=0)


def test_compress_int8_matches_reference():
    g = _tree(np.random.default_rng(1), SHAPES, 0.01)
    want = ref_adamw.compress_int8({k: jnp.asarray(v) for k, v in g.items()})
    got = adamw.compress_int8({k: torch.from_numpy(v) for k, v in g.items()})
    for k in g:
        assert got[k][0].dtype == torch.int8
        assert np.array_equal(got[k][0].numpy(), np.asarray(want[k][0]))
        np.testing.assert_allclose(float(got[k][1]), float(want[k][1]),
                                   rtol=ADAMW_RTOL)
    deq = adamw.decompress_int8(got)
    ref_deq = ref_adamw.decompress_int8(want)
    for k in g:
        np.testing.assert_allclose(deq[k].numpy(), np.asarray(ref_deq[k]),
                                   rtol=ADAMW_RTOL)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("step", [0, 9, 40])
def test_apply_updates_matches_reference(step, state_dtype):
    # Identical params, grads and moments: one update in both packages.
    rng = np.random.default_rng(2 + step)
    p, g = _tree(rng, SHAPES, 0.05), _tree(rng, SHAPES, 0.5)
    mu, nu = _tree(rng, SHAPES, 0.01), _tree(rng, SHAPES, 0.01)
    nu = {k: np.abs(v) for k, v in nu.items()}
    kw = dict(lr=3e-4, warmup_steps=10, total_steps=100, clip_norm=1.0,
              state_dtype=state_dtype)
    cfg, pcfg = ref_adamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    sdt = jnp.dtype(state_dtype)
    ref_state = {"mu": {k: jnp.asarray(v).astype(sdt) for k, v in mu.items()},
                 "nu": {k: jnp.asarray(v).astype(sdt) for k, v in nu.items()},
                 "step": jnp.asarray(step, jnp.int32)}
    want_p, want_s, want_m = ref_adamw.apply_updates(
        cfg, {k: jnp.asarray(v) for k, v in p.items()}, ref_state,
        {k: jnp.asarray(v) for k, v in g.items()})
    tdt = adamw._STATE_DTYPES[state_dtype]
    state = {part: {k: torch.tensor(np.asarray(v.astype(jnp.float32))).to(tdt)
                    for k, v in ref_state[part].items()}
             for part in ("mu", "nu")}
    state["step"] = torch.tensor(step, dtype=torch.int32)
    got_p, got_s, got_m = adamw.apply_updates(
        pcfg, {k: torch.from_numpy(v) for k, v in p.items()}, state,
        {k: torch.from_numpy(v) for k, v in g.items()})
    assert int(got_s["step"]) == int(want_s["step"]) == step + 1
    for name in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(got_m[name]), float(want_m[name]),
                                   rtol=ADAMW_RTOL)
    for k in p:
        w = np.asarray(want_p[k])
        np.testing.assert_allclose(got_p[k].numpy(), w, rtol=ADAMW_RTOL,
                                   atol=ADAMW_RTOL * np.abs(w).max())
        for part in ("mu", "nu"):
            assert got_s[part][k].dtype == state["mu"][k].dtype
            # bf16 moments: one rounding of the same f32 value may land a
            # bf16 ulp (at most 2^-7 relative) apart.
            w = np.asarray(want_s[part][k].astype(jnp.float32))
            np.testing.assert_allclose(got_s[part][k].float().numpy(), w,
                                       rtol=ADAMW_RTOL if state_dtype ==
                                       "float32" else 2 ** -7,
                                       atol=ADAMW_RTOL * np.abs(w).max())


def test_adamw_decreases_quadratic():
    # tests/test_substrates.py's test on the port.
    cfg = adamw.AdamWConfig(lr=0.05, weight_decay=0.0, warmup_steps=1,
                            total_steps=200, clip_norm=100.0)
    params = {"w": torch.tensor([3.0, -2.0, 1.0])}
    state = adamw.init_state(cfg, params)
    for _ in range(150):
        w = params["w"].detach().requires_grad_()
        (g,) = torch.autograd.grad(torch.sum(w ** 2), [w])
        params, state, _ = adamw.apply_updates(cfg, params, state, {"w": g})
    assert float(torch.sum(params["w"] ** 2)) < 1e-2


def test_adamw_state_from_reference():
    ref_cfg, _ = _configs()
    params = RefLM(ref_cfg).init(jax.random.key(0))
    for dt in ("float32", "bfloat16"):
        opt = ref_adamw.init_state(ref_adamw.AdamWConfig(state_dtype=dt),
                                   params)
        opt["step"] = jnp.asarray(4, jnp.int32)
        got = adamw_state_from_reference(jax.tree.map(np.asarray, opt))
        names = set(lm_params_from_reference(jax.tree.map(np.asarray, params)))
        assert set(got["mu"]) == set(got["nu"]) == names
        assert int(got["step"]) == 4
        assert all(v.dtype == adamw._STATE_DTYPES[dt]
                   for v in got["mu"].values())


# ----------------------------------------------------- loss and gradients

@pytest.mark.parametrize("remat", ["block", "none"])
def test_f32_loss_and_grads_match_reference(remat):
    ref_cfg, port_cfg = _configs(compute_dtype="float32", remat=remat)
    ref, params, port = _models(ref_cfg, port_cfg)
    want_loss, loss, want, got = _value_and_grads(ref, params, port,
                                                  _batch(ref_cfg))
    np.testing.assert_allclose(loss, want_loss, rtol=F32_LOSS_RTOL)
    for k, g in got.items():
        w = want[k].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=F32_GRAD_ATOL * np.abs(w).max(),
                                   err_msg=k)


def test_bf16_loss_and_grads_match_reference():
    ref_cfg, port_cfg = _configs()
    assert port_cfg.compute_dtype == "bfloat16"
    ref, params, port = _models(ref_cfg, port_cfg)
    want_loss, loss, want, got = _value_and_grads(ref, params, port,
                                                  _batch(ref_cfg, seed=1))
    np.testing.assert_allclose(loss, want_loss, rtol=BF16_LOSS_RTOL)
    for k, g in got.items():
        assert g.dtype == torch.float32       # gradients of f32 masters
        err = float((g - want[k]).norm() / want[k].norm())
        assert err <= BF16_GRAD_REL, (k, err)


def test_f32_flash_training_matches_naive():
    # The port's own two attention paths: FlashAttentionFn (K3 and K3-bwd's
    # plain versions through the padding) against the materialised `_sdpa`.
    _, port_cfg = _configs(compute_dtype="float32")
    ref_cfg, _ = _configs()
    batch = {k: torch.as_tensor(v) for k, v in _batch(ref_cfg, seed=2).items()}
    out = {}
    for impl in ("flash", "naive"):
        model = LM(dataclasses.replace(port_cfg, attn_impl=impl), "cpu",
                   train=True).init(torch.Generator().manual_seed(3))
        ps = dict(model.named_parameters())
        loss = model.loss(batch)
        out[impl] = (float(loss), torch.autograd.grad(loss, list(ps.values())))
    np.testing.assert_allclose(out["flash"][0], out["naive"][0],
                               rtol=F32_LOSS_RTOL)
    for g, w in zip(out["flash"][1], out["naive"][1]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=F32_GRAD_ATOL * float(w.abs().max()))


def test_three_train_steps_match_reference(tmp_path):
    ref_cfg, port_cfg = _configs(compute_dtype="float32")
    n = 3
    ref = run_reference({"task": "train", "arch": ARCH, "steps": n, "lr": 3e-4,
                         "seed": 0, "batch": B, "seq": S,
                         "overrides": {"compute_dtype": "float32"}},
                        {}, tmp_path)
    tree = {}
    for key, arr in ref.items():
        if key.startswith("param/"):
            node = tree
            *parents, leaf = key[len("param/"):].split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = arr
    args = train.parse_args(["--arch", ARCH, "--steps", str(n), "--device",
                             "cpu"])
    opt_cfg = train.opt_config(port_cfg, args)
    model, step_fn = steps.make_train_step(port_cfg, opt_cfg, "cpu")
    model.load_params(lm_params_from_reference(tree))
    params = {k: p.detach() for k, p in model.named_parameters()}
    state = {"params": params, "opt": adamw.init_state(opt_cfg, params)}
    source = SyntheticSource(port_cfg, ShapeConfig("t", S, B, "train"),
                             DataConfig(seed=0))
    got = {"loss": [], "grad_norm": [], "lr": []}
    for step in range(n):
        batch = {k: torch.as_tensor(v) for k, v in source.batch(step).items()}
        state, m = step_fn(state, batch)
        for k in got:
            got[k].append(float(m[k]))
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=STEP_LOSS_RTOL)
    np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"],
                               rtol=STEP_GNORM_RTOL)
    np.testing.assert_allclose(got["lr"], ref["lr"], rtol=ADAMW_RTOL)


# ------------------------------------------------------------ attention

ATTN_SHAPES = [(2, 64, 64, 4, 2, 16), (1, 100, 100, 3, 1, 20),
               (2, 150, 70, 4, 2, 8), (1, 70, 130, 6, 3, 32)]


def _attn_inputs(shape, seed=4):
    Bq, Sq, Sk, H, KV, hd = shape
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((Bq, Sq, H, hd), (Bq, Sk, KV, hd), (Bq, Sk, KV, hd),
                      (Bq, Sq, H, hd))]


@pytest.mark.parametrize("shape", ATTN_SHAPES)
def test_attention_bwd_ref_matches_autograd(shape):
    # The plain backward on the unpadded problem, and through the padding
    # the kernels run (S to 64, hd to a compiled width, the caller's scale
    # and true key count), against autograd of the plain forward.
    q, k, v, do = (torch.from_numpy(a) for a in _attn_inputs(shape))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(flash_attention_ref(*leaves), leaves, do)
    out, lse = flash_attention_lse_ref(q, k, v)
    np.testing.assert_allclose(out.numpy(), flash_attention_ref(q, k, v).numpy(),
                               rtol=1e-6, atol=1e-6)
    got = flash_attention_bwd_ref(q, k, v, out, lse, do)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    padded = torch.autograd.grad(flash_attention(*leaves), leaves, do)
    for g, p, w in zip(got, padded, want):
        top = float(w.abs().max())
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=ATTN_GRAD_ATOL * top)
        np.testing.assert_allclose(p.numpy(), w.numpy(), rtol=0,
                                   atol=ATTN_GRAD_ATOL * top)


@pytest.mark.parametrize("shape", [s for s in ATTN_SHAPES if s[1] == s[2]])
def test_attention_grad_matches_jax_grad_of_reference_oracle(shape):
    q, k, v, do = _attn_inputs(shape, seed=5)

    def f(q, k, v):
        return jnp.sum(ref_flash_attention(q, k, v) * do)

    want = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got = torch.autograd.grad(flash_attention(*leaves), leaves,
                              torch.from_numpy(do))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=ATTN_GRAD_ATOL * np.abs(w).max())


# ------------------------------------------------ checkpoints and the loop

def test_checkpoint_roundtrip(tmp_path):
    state = {"params": {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
                        "m": torch.randn(4, generator=torch.Generator()
                                         .manual_seed(0)).to(torch.bfloat16)},
             "opt": {"step": torch.tensor(7, dtype=torch.int32)}}
    ckpt.save(str(tmp_path), 7, state)
    like = {"params": {"w": torch.zeros(2, 3, dtype=torch.float64),
                       "m": torch.zeros(4, dtype=torch.bfloat16)},
            "opt": {"step": torch.zeros((), dtype=torch.int32)}}
    restored, step = ckpt.restore(str(tmp_path), like)
    assert step == 7 and ckpt.latest_step(str(tmp_path)) == 7
    assert restored["params"]["w"].dtype == torch.float64   # like's dtype
    assert torch.equal(restored["params"]["w"].float(), state["params"]["w"])
    assert torch.equal(restored["params"]["m"], state["params"]["m"])
    assert int(restored["opt"]["step"]) == 7
    # the reference's layout: step directory, manifest, per-leaf files
    manifest = (tmp_path / "step_00000007" / "manifest.json").read_text()
    assert '"path": "params/m"' in manifest and '"bfloat16"' in manifest
    assert (tmp_path / "LATEST").read_text() == "step_00000007"


def test_checkpoint_reads_the_references_layout(tmp_path):
    # A checkpoint the reference wrote restores into the port, leaf by path.
    ref_ckpt.save(str(tmp_path), 3, {"params": {"w": jnp.arange(4.0)},
                                     "opt": {"step": jnp.asarray(3, jnp.int32)}})
    like = {"params": {"w": torch.zeros(4)},
            "opt": {"step": torch.zeros((), dtype=torch.int32)}}
    restored, step = ckpt.restore(str(tmp_path), like)
    assert step == 3 and torch.equal(restored["params"]["w"],
                                     torch.arange(4.0))


def test_checkpoint_latest_pointer_advances_and_stays_monotone(tmp_path):
    state = {"x": torch.zeros(3)}
    ckpt.save(str(tmp_path), 1, state)
    ckpt.save(str(tmp_path), 2, state)
    assert ckpt.latest_step(str(tmp_path)) == 2
    ckpt.save(str(tmp_path), 1, state)        # a late writer of an old step
    assert ckpt.latest_step(str(tmp_path)) == 2
    assert not [p for p in tmp_path.iterdir() if ".tmp." in p.name]


def test_async_checkpointer_saves_a_host_copy(tmp_path):
    state = {"x": torch.ones(3)}
    with ckpt.AsyncCheckpointer(str(tmp_path)) as saver:
        saver.save(5, state)
        state["x"].add_(1.0)                  # later steps cannot reach it
    restored, step = ckpt.restore(str(tmp_path), {"x": torch.zeros(3)})
    assert step == 5 and torch.equal(restored["x"], torch.ones(3))
    assert saver.last_saved == 5 and [s for s, _, _ in saver.save_seconds] == [5]


class _CountingSource:
    def __init__(self):
        self.calls = []

    def batch(self, step):
        self.calls.append(step)
        return {"step": step}


def test_resilient_loop_restarts_and_replays(tmp_path):
    # tests/test_substrates.py's test on the port.
    src = _CountingSource()
    trace = []

    def step_fn(state, batch):
        trace.append(batch["step"])
        return state + 1, {"loss": 0.0}

    loop = ResilientLoop(step_fn, src, str(tmp_path), save_every=4)
    state, step, mlog, monitor = loop.run(torch.tensor(0), 0, 12,
                                          fault_schedule={6, 9})
    assert step == 12 and int(state) == 12
    assert len(trace) > 12
    assert trace.count(4) >= 2 or trace.count(8) >= 2


def test_resilient_loop_gives_up_after_max_retries(tmp_path):
    def step_fn(state, batch):
        raise RuntimeError("CUDA error: an illegal memory access")

    loop = ResilientLoop(step_fn, _CountingSource(), str(tmp_path),
                         max_retries=2)
    with pytest.raises(RuntimeError, match="illegal memory"):
        loop.run(torch.tensor(0), 0, 3)
    assert issubclass(InjectedFault, RuntimeError)


def test_straggler_monitor_flags_outlier_like_reference():
    mon, ref = StragglerMonitor(z_threshold=3.0), RefMonitor(z_threshold=3.0)
    times = [0.1] * 20 + [10.0, 0.1]
    assert [mon.observe(t) for t in times] == [ref.observe(t) for t in times]
    assert mon.flagged == ref.flagged == 1


def _smoke_args(tmp_path, *extra):
    return train.parse_args(["--arch", ARCH, "--smoke", "--device", "cpu",
                             "--batch", "2", "--seq", "32", "--ckpt-dir",
                             str(tmp_path), *extra])


def test_train_replay_after_fault_is_bit_equal(tmp_path):
    # The trainer's resilient loop: a fault at step 5 restores
    # step 4 and replays; losses and final parameters equal an
    # uninterrupted run's bit for bit.
    cfg = get_smoke_config(ARCH)
    clean = train.train(cfg, _smoke_args(tmp_path / "a", "--steps", "7",
                                         "--save-every", "2"))
    faulted = train.train(cfg, _smoke_args(tmp_path / "b", "--steps", "7",
                                           "--save-every", "2"),
                          fault_schedule={5})
    assert clean.restarts == []
    assert [r["from_step"] for r in faulted.restarts] == [4]
    by_step = {m["step"]: m["loss"] for m in faulted.metrics_log}
    assert [by_step[s] for s in range(7)] == clean.losses
    assert faulted.losses == clean.losses[:5] + clean.losses[4:]
    for k, p in clean.state["params"].items():
        assert torch.equal(p, faulted.state["params"][k]), k
    assert torch.equal(clean.state["opt"]["step"], faulted.state["opt"]["step"])


def test_train_main_on_the_cpu(tmp_path, capsys):
    losses = train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                         "--steps", "3", "--batch", "2", "--seq", "32",
                         "--log-every", "1", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert out.startswith("arch=smollm-smoke params=")
    assert "step     2 loss" in out and "done: 3 steps" in out
    assert ckpt.latest_step(str(tmp_path)) == 3
