"""The port's recurrent blocks and local attention against the JAX reference
(`repro.models.rglru`, `repro.models.xlstm`, the windowed parts of
`repro.models.layers`), and the hybrid and xLSTM models, on the CPU in f32.

The reference runs once for this module in its own process
(`tests/torch_port_reference.py`, task "models"); its weights come over
through `convert`.  Bars: RG-LRU (full, from a state, step by step) and
local attention (windowed prefill, the rolling cache through its wrap,
windowed decode) within 1e-5 of the largest output; mLSTM at chunk 1, 4, 8
and 24 and the sLSTM scan, outputs and final states, within 1e-4, the
reference's own bar (`tests/test_models_smoke.py`); the models within 1e-5
(each gradient leaf within 1e-4 of its own largest value; the sLSTM
input-gate bias, whose gradient is zero in exact arithmetic, below 1e-6 of
the model's largest gradient in both packages) and served tokens equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_smoke_config
from repro_torch.models import layers as L
from repro_torch.models import rglru as RG
from repro_torch.models import xlstm as XL
from repro_torch.models.model import build_model
from torch_port_reference import (F32, arch_case, assert_close, check_arch,
                                  check_serve, port_config, run_reference,
                                  serve_case, unflat)

ARCHS = ("recurrentgemma-9b", "xlstm-1.3b")
SERVE_ARGV = ["--requests", "3", "--batch", "2", "--prompt-len", "20",
              "--gen-len", "6", "--seed", "3"]
CHUNKS = (1, 4, 8, 24)
# local attention: window 16 of the smoke config, prefill of 24 positions
# (the window's last 16 in their rolling slots), then 12 decode steps that
# overwrite slots 8..15, 0..3 (the wrap)
WINDOW, WIN_S, WIN_STEPS = 16, 24, 12


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    rng = np.random.default_rng(0)
    rg = port_config("recurrentgemma-9b", F32)
    xl = port_config("xlstm-1.3b", F32)
    D = rg.d_model
    arrays = {
        "rglru_x": rng.normal(size=(2, 12, D)).astype(np.float32),
        "rglru_h0": rng.normal(size=(2, D)).astype(np.float32),
        "rglru_conv0": rng.normal(size=(2, 3, D)).astype(np.float32),
        "window_x": rng.normal(size=(2, WIN_S, D)).astype(np.float32),
        "window_steps": rng.normal(size=(2, WIN_STEPS, D)).astype(np.float32),
        "xl_x": rng.normal(size=(2, 32, xl.d_model)).astype(np.float32),
        "xl_x1": rng.normal(size=(2, 1, xl.d_model)).astype(np.float32),
    }
    for t in ("q", "k", "v"):
        arrays[f"mlstm_{t}"] = rng.normal(size=(2, 24, 2, 8)).astype(
            np.float32)
    arrays["mlstm_ig"] = rng.normal(size=(2, 24, 2)).astype(np.float32)
    arrays["mlstm_fg"] = (rng.normal(size=(2, 24, 2)) + 2.0).astype(
        np.float32)
    cases = [
        {"kind": "rglru", "name": "rglru", "arch": "recurrentgemma-9b",
         "overrides": F32, "seed": 1},
        {"kind": "window", "name": "window", "arch": "recurrentgemma-9b",
         "overrides": F32, "seed": 2, "window": WINDOW},
        {"kind": "mlstm", "name": "mlstm", "chunks": list(CHUNKS)},
        {"kind": "xlstm_blocks", "name": "xl", "arch": "xlstm-1.3b",
         "overrides": F32, "seed": 3},
    ]
    arch_cases = {}
    for arch in ARCHS:
        case, arr = arch_case(f"arch_{arch}", arch, rng)
        arch_cases[arch] = case
        cases += [case, serve_case(f"serve_{arch}", arch, SERVE_ARGV)]
        arrays.update(arr)
    out = run_reference({"task": "models", "cases": cases}, arrays,
                        tmp_path_factory.mktemp("recurrent_ref"))
    return out, arrays, arch_cases


def _params(out, prefix):
    return {k: _t(v) for k, v in unflat(out, prefix).items()}


def test_rglru_full_sequence(ref):
    out, arrays, _ = ref
    cfg = port_config("recurrentgemma-9b", F32)
    p = _params(out, "rglru/param")
    full, state = RG.rglru_block(p, cfg, _t(arrays["rglru_x"]),
                                 return_state=True)
    assert_close(full, out["rglru/full"], 1e-5, "full")
    for k, v in unflat(out, "rglru/state").items():
        assert_close(state[k], v, 1e-5, f"state {k}")


def test_rglru_from_a_state(ref):
    """The initial state folded into step 0 (the reference's prefill with
    a state)."""
    out, arrays, _ = ref
    cfg = port_config("recurrentgemma-9b", F32)
    h0 = {"h": _t(arrays["rglru_h0"]), "conv": _t(arrays["rglru_conv0"])}
    got = RG.rglru_block(_params(out, "rglru/param"), cfg,
                         _t(arrays["rglru_x"]), state=h0)
    assert_close(got, out["rglru/from_state"], 1e-5, "from state")


def test_rglru_decode_steps(ref):
    out, arrays, _ = ref
    cfg = port_config("recurrentgemma-9b", F32)
    p = _params(out, "rglru/param")
    x = _t(arrays["rglru_x"])
    st = RG.init_rglru_state(cfg, x.shape[0])
    steps = []
    for t in range(x.shape[1]):
        o, st = RG.rglru_block_decode(p, cfg, x[:, t:t + 1], st)
        steps.append(o)
    assert_close(torch.cat(steps, dim=1), out["rglru/steps"], 1e-5, "steps")
    for k, v in unflat(out, "rglru/step_state").items():
        assert_close(st[k], v, 1e-5, f"state {k}")


@pytest.mark.parametrize("S", [1, 2, 5, 8, 13, 64])
def test_linear_scan_is_the_recurrence(S):
    """The doubling scan against h_t = a_t h_{t-1} + b_t step by step."""
    g = torch.Generator().manual_seed(S)
    a = torch.rand((2, S, 3), generator=g)
    b = torch.randn((2, S, 3), generator=g)
    h, want = torch.zeros((2, 3)), []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    assert_close(RG.linear_scan(a, b), torch.stack(want, 1), 1e-6, "scan")


def _window_model(out):
    cfg = dataclasses.replace(port_config("recurrentgemma-9b", F32),
                              local_window=WINDOW)
    return cfg, _params(out, "window/param")


def test_windowed_prefill_and_rolling_cache(ref):
    out, arrays, _ = ref
    cfg, p = _window_model(out)
    x = _t(arrays["window_x"])
    B, S, _ = x.shape
    positions = torch.arange(S)[None].expand(B, S)
    o, cache = L.attention_prefill(p, cfg, x, positions, WINDOW,
                                   L.CacheSpec(S, cfg.kv_cache_dtype))
    assert_close(o, out["window/prefill"], 1e-5, "prefill")
    want = unflat(out, "window/prefill_cache")
    assert cache["pos_ids"].tolist() == want["pos_ids"].tolist()
    assert sorted(cache) == sorted(want)
    for k in ("k", "v"):
        assert_close(cache[k], want[k], 1e-5, k)
    naive = dataclasses.replace(cfg, attn_impl="naive")
    assert_close(L.attention(p, naive, x, positions, WINDOW),
                 out["window/prefill_naive"], 1e-5, "naive")
    assert_close(L.attention(p, naive, x, positions, WINDOW), o, 1e-5,
                 "naive vs flash in the port")


def test_windowed_decode_wraps_the_rolling_cache(ref):
    out, arrays, _ = ref
    cfg, p = _window_model(out)
    x, xs = _t(arrays["window_x"]), _t(arrays["window_steps"])
    B, S, _ = x.shape
    positions = torch.arange(S)[None].expand(B, S)
    _, cache = L.attention_prefill(p, cfg, x, positions, WINDOW,
                                   L.CacheSpec(S, cfg.kv_cache_dtype))
    steps = []
    for t in range(xs.shape[1]):
        o, cache = L.attention_decode_windowed(p, cfg, xs[:, t:t + 1], cache,
                                               S + t)
        steps.append(o)
    assert_close(torch.cat(steps, dim=1), out["window/steps"], 1e-5, "steps")
    want = unflat(out, "window/steps_cache")
    assert cache["pos_ids"].tolist() == want["pos_ids"].tolist()
    assert min(cache["pos_ids"].tolist()) == S + WIN_STEPS - WINDOW
    for k in ("k", "v"):
        assert_close(cache[k], want[k], 1e-5, k)


def test_windowed_attention_decode_on_a_full_cache(ref):
    out, arrays, _ = ref
    cfg, p = _window_model(out)
    x, xs = _t(arrays["window_x"]), _t(arrays["window_steps"])
    B, S, _ = x.shape
    positions = torch.arange(S)[None].expand(B, S)
    _, full = L.attention_prefill(p, cfg, x, positions, 0,
                                  L.CacheSpec(S, cfg.kv_cache_dtype))
    full = {k: torch.cat([v, torch.zeros_like(v[:, :1])], dim=1)
            for k, v in full.items()}
    o, _ = L.attention_decode(p, cfg, xs[:, :1], full, S, WINDOW)
    assert_close(o, out["window/decode_window"], 1e-5, "decode window")


@pytest.mark.parametrize("chunk", CHUNKS)
def test_mlstm_chunkwise(ref, chunk):
    out, arrays, _ = ref
    q, k, v, ig, fg = (_t(arrays[f"mlstm_{t}"])
                       for t in ("q", "k", "v", "ig", "fg"))
    o, (C, n, m) = XL.mlstm_chunkwise(q, k, v, ig, fg, chunk)
    assert_close(o, out[f"mlstm/chunk{chunk}"], 1e-4, "out")
    want = unflat(out, f"mlstm/chunk{chunk}_state")
    for name, got in zip("012", (C, n, m)):
        assert_close(got, want[name], 1e-4, f"state {name}")
    # and the port's own recurrence, as the reference's smoke test holds it
    assert_close(o, out["mlstm/steps"], 1e-4, "chunkwise vs recurrent")


def test_mlstm_recurrent_steps(ref):
    out, arrays, _ = ref
    q, k, v, ig, fg = (_t(arrays[f"mlstm_{t}"])
                       for t in ("q", "k", "v", "ig", "fg"))
    B, S, H, dh = q.shape
    st = (torch.zeros((B, H, dh, dh)), torch.zeros((B, H, dh)),
          torch.full((B, H), -1e30))
    steps = []
    for t in range(S):
        o, st = XL.mlstm_recurrent_step(q[:, t], k[:, t], v[:, t], ig[:, t],
                                        fg[:, t], st)
        steps.append(o)
    assert_close(torch.stack(steps, 1), out["mlstm/steps"], 1e-4, "steps")
    want = unflat(out, "mlstm/steps_state")
    for name, got in zip("012", st):
        assert_close(got, want[name], 1e-4, f"state {name}")


@pytest.mark.parametrize("block", ["mlstm", "slstm"])
def test_xlstm_blocks_and_their_decode_states(ref, block):
    out, arrays, _ = ref
    cfg = port_config("xlstm-1.3b", F32)
    p = _params(out, f"xl/{block[0]}param")
    x, x1 = _t(arrays["xl_x"]), _t(arrays["xl_x1"])
    if block == "mlstm":
        assert_close(XL.mlstm_block(p, cfg, x), out["xl/mlstm"], 1e-4, "full")
        _, st = XL.mlstm_block_prefill(p, cfg, x)
        o, st2 = XL.mlstm_block_decode(p, cfg, x1, st)
    else:
        o_full, st = XL.slstm_block(p, cfg, x, return_state=True)
        assert_close(o_full, out["xl/slstm"], 1e-4, "full")
        o, st2 = XL.slstm_block_decode(p, cfg, x1, st)
    for k, v in unflat(out, f"xl/{block}_state").items():
        assert_close(st[k], v, 1e-4, f"state {k}")
    assert_close(o, out[f"xl/{block}_decode"], 1e-4, "decode")
    for k, v in unflat(out, f"xl/{block}_decode_state").items():
        assert_close(st2[k], v, 1e-4, f"decode state {k}")


def test_mlstm_chunk_must_divide_the_sequence():
    q = torch.zeros((1, 10, 1, 4))
    g = torch.zeros((1, 10, 1))
    with pytest.raises(AssertionError):
        XL.mlstm_chunkwise(q, q, q, g, g, 4)


@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_model_matches_reference(ref, arch):
    out, arrays, cases = ref
    check_arch(out, arrays, cases[arch])


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_matches_reference_tokens(ref, arch):
    out, _, _ = ref
    tokens = check_serve(out, serve_case(f"serve_{arch}", arch, SERVE_ARGV))
    assert [len(t) for t in tokens] == [6, 6, 6]


def test_hybrid_decode_past_the_window_stays_finite():
    """recurrentgemma's smoke config (window 16) served past its window in
    bf16: the rolling cache wraps and every logit stays finite."""
    cfg = get_smoke_config("recurrentgemma-9b")
    model = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 20))
    logits, cache = model.prefill({"tokens": toks})
    nxt = logits[:, -1, :cfg.vocab_size].argmax(-1)
    for pos in range(20, 40):
        logits, cache = model.decode_step(cache, {"tokens": nxt[:, None]}, pos)
        assert torch.isfinite(logits.float()).all()
        nxt = logits[:, 0, :cfg.vocab_size].argmax(-1)
    assert sorted(cache[2]["pos_ids"].tolist()) == list(range(24, 40))
