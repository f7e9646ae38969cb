"""The port's MoE block and MoE models against the JAX reference
(`repro.models.moe`, `repro.models.lm`, `repro.launch.serve`), on the CPU
in f32 at smoke configs.

The reference runs once for this module in its own process
(`tests/torch_port_reference.py`, task "models"); its weights come over
through `convert`.  Bars: `moe_block` within 1e-5 of the largest output
and each gradient leaf within 1e-4 of its own largest value; the models'
prefill and decode logits, caches and loss within 1e-5, each gradient leaf
within 1e-4 of its own largest; served tokens equal.  With top-1 routing
the routing weight w / (w + 1e-9) is 1 whatever w is, so the router's
gradient is zero in exact arithmetic: for llama4 both packages must keep it
below 1e-6 of the largest gradient (`torch_port_reference.assert_grads`).

The llama4 case routes top-1 over 8 experts, so every routing weight is
1/(1+1e-9) and an overflowing expert keeps the tokens the tie order picks:
half of its 640 tokens are one repeated row, which all pick the same expert
(capacity 160), and the port must keep the reference's tokens.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_smoke_config
from repro_torch.models import moe as MOE
from repro_torch.models.model import build_model
from torch_port_reference import (F32, arch_case, assert_close, assert_grads,
                                  check_arch, check_serve, port_config,
                                  run_reference, serve_case, unflat,
                                  zero_gradient_leaves)

# name -> (arch, x shape); T = B * S tokens picks the path
MOE_CASES = {"masked": ("moonshot-v1-16b-a3b", (2, 16)),
             "gathered": ("moonshot-v1-16b-a3b", (2, 320)),
             "llama4_overflow": ("llama4-maverick-400b-a17b", (2, 320))}
ARCHS = ("moonshot-v1-16b-a3b", "llama4-maverick-400b-a17b")
SERVE_ARGV = ["--requests", "3", "--batch", "2", "--prompt-len", "20",
              "--gen-len", "6", "--seed", "3"]


def _moe_inputs(name, arch, shape, rng):
    D = get_smoke_config(arch).d_model
    x = rng.normal(size=(*shape, D)).astype(np.float32)
    if name == "llama4_overflow":
        x[:, : shape[1] // 2] = x[0, 0]       # 320 identical tokens
    return {f"moe_{name}_x": x,
            f"moe_{name}_g": rng.normal(size=x.shape).astype(np.float32)}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    rng = np.random.default_rng(0)
    cases, arrays = [], {}
    for name, (arch, shape) in MOE_CASES.items():
        cases.append({"kind": "moe", "name": f"moe_{name}", "arch": arch,
                      "overrides": F32, "seed": 1})
        arrays.update(_moe_inputs(name, arch, shape, rng))
    arch_cases = {}
    for arch in ARCHS:
        case, arr = arch_case(f"arch_{arch}", arch, rng)
        arch_cases[arch] = case
        cases.append(case)
        arrays.update(arr)
        cases.append(serve_case(f"serve_{arch}", arch, SERVE_ARGV))
    out = run_reference({"task": "models", "cases": cases}, arrays,
                        tmp_path_factory.mktemp("moe_ref"))
    return out, arrays, arch_cases


def _port_moe(out, arrays, name, arch):
    """The port's moe_block on the case's weights: output and gradients."""
    cfg = port_config(arch, F32)
    p = {k: torch.from_numpy(v).requires_grad_()
         for k, v in unflat(out, f"moe_{name}/param").items()}
    x = torch.from_numpy(arrays[f"moe_{name}_x"]).requires_grad_()
    MOE.STATS.reset()
    y = MOE.moe_block(p, cfg, x)
    stats = MOE.STATS.read()
    g = torch.from_numpy(arrays[f"moe_{name}_g"])
    grads = torch.autograd.grad((y * g).sum(), [*p.values(), x])
    return y, dict(zip([*p, "x"], grads)), stats


@pytest.mark.parametrize("name", list(MOE_CASES))
def test_moe_block_matches_reference(ref, name):
    out, arrays, _ = ref
    arch, (B, S) = MOE_CASES[name]
    y, grads, stats = _port_moe(out, arrays, name, arch)
    assert_close(y, out[f"moe_{name}/out"], 1e-5, "moe out")
    want = unflat(out, f"moe_{name}/grad")
    want = {**want["0"], "x": want["1"]}
    assert_grads(grads, want, 1e-4, zero_gradient_leaves(port_config(arch,
                                                                     F32)))
    dense = B * S <= MOE._DENSE_PATH_MAX_TOKENS
    assert (stats["masked"], stats["gathered"]) == ((1, 0) if dense
                                                    else (0, 1))
    if name == "llama4_overflow":
        assert stats["overflowed_experts"] >= 1


def test_overflow_is_counted_only_after_a_reset(ref, monkeypatch):
    """Until `STATS.reset()` the gathered path computes no overflow count
    (nothing reads it); after it, the llama4 case's overflow is counted."""
    out, arrays, _ = ref
    monkeypatch.setattr(MOE, "STATS", MOE.MoEStats())
    cfg = port_config("llama4-maverick-400b-a17b", F32)
    p = {k: torch.from_numpy(v) for k, v in
         unflat(out, "moe_llama4_overflow/param").items()}
    x = torch.from_numpy(arrays["moe_llama4_overflow_x"])
    first = MOE.moe_block(p, cfg, x)
    assert MOE.STATS.read() == {"masked": 0, "gathered": 1,
                                "overflowed_experts": 0}
    MOE.STATS.reset()
    assert torch.equal(MOE.moe_block(p, cfg, x), first)
    stats = MOE.STATS.read()
    assert stats["gathered"] == 1 and stats["overflowed_experts"] >= 1


def test_overflowing_expert_keeps_the_lowest_token_ids(ref):
    """Among equal weights `jax.lax.top_k` takes the lower index first, so
    an expert with more than C tokens of one weight keeps the first C of
    them; the port's stable sort does the same (`torch.topk` promises no
    order among ties)."""
    out, arrays, _ = ref
    arch, (B, S) = MOE_CASES["llama4_overflow"]
    cfg = port_config(arch, F32)
    p = {k: torch.from_numpy(v) for k, v in
         unflat(out, "moe_llama4_overflow/param").items()}
    x = torch.from_numpy(arrays["moe_llama4_overflow_x"])
    h = MOE.rmsnorm(x, p["ln"]).reshape(B * S, -1)
    top = torch.softmax(h @ p["router"], dim=-1).argmax(-1)
    w_te = torch.zeros((B * S, cfg.num_experts)).scatter(
        1, top[:, None], 1 / (1 + 1e-9))
    C = MOE.capacity(B * S, 1, cfg.num_experts)
    kept = MOE._sorted_top(w_te.T, C)[1]
    full = [e for e in range(cfg.num_experts) if (top == e).sum() > C]
    assert full
    for e in full:
        routed = torch.nonzero(top == e).flatten()
        assert kept[e].tolist() == routed[:C].tolist()


@pytest.mark.parametrize("T,k,E,C", [(640, 1, 8, 160), (8704, 6, 64, 1632),
                                     (20, 1, 8, 5), (4, 1, 16, 1),
                                     (100, 2, 8, 50), (10, 8, 8, 10)])
def test_capacity_is_the_references(T, k, E, C):
    """round(2 T k / E) with Python's half-to-even, at least 1, at most T
    (20 x 1 / 8 x 2 = 5.0; 4 x 2 / 16 = 0.5 rounds to 0, then 1)."""
    assert MOE.capacity(T, k, E) == C


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_model_matches_reference(ref, arch):
    out, arrays, cases = ref
    check_arch(out, arrays, cases[arch])


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_matches_reference_tokens(ref, arch):
    out, _, _ = ref
    tokens = check_serve(out, serve_case(f"serve_{arch}", arch, SERVE_ARGV))
    assert [len(t) for t in tokens] == [6, 6, 6]


def test_prefill_decode_consistency_moonshot():
    """Decode logits at position S from the prefill cache equal a full
    forward over S + 1 tokens (`tests/test_models_smoke.py`'s check, at its
    bf16 compute and 2e-2 bar)."""
    cfg = get_smoke_config("moonshot-v1-16b-a3b")
    model = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    B, S = 2, 32
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S + 1))
    padded = np.zeros((B, S + 8), np.int64)
    padded[:, :S] = toks[:, :S]
    _, cache = model.prefill({"tokens": padded})
    dec, _ = model.decode_step(cache, {"tokens": toks[:, S:S + 1]}, S)
    full, _ = model.prefill({"tokens": toks})
    np.testing.assert_allclose(dec[:, 0].float().numpy(),
                               full[:, -1].float().numpy(),
                               rtol=2e-2, atol=2e-2)


def test_gathered_path_is_deterministic_forward_and_backward():
    """Two calls of the gathered path give the same bits, output and
    gradients (on the CPU here; `tests/test_torch_lm_card.py` holds it on
    the card, where a scatter-add would be atomics)."""
    cfg = dataclasses.replace(get_smoke_config("moonshot-v1-16b-a3b"), **F32)
    g = torch.Generator().manual_seed(0)
    p = {k: v.requires_grad_() for k, v in MOE.init_moe(g, cfg).items()}
    x = torch.randn((2, 300, cfg.d_model), generator=g).requires_grad_()
    runs = []
    for _ in range(2):
        y = MOE.moe_block(p, cfg, x)
        runs.append((y, *torch.autograd.grad(y.square().sum(),
                                             [*p.values(), x])))
    assert all(torch.equal(a, b) for a, b in zip(*runs))
