"""Every model family of the port against the JAX reference: M-RoPE and the
VLM's embedding inputs, the encoder-decoder, and the per-arch dispatch, on
the CPU in f32 at smoke configs.

The reference runs once for this module in its own process
(`tests/torch_port_reference.py`, task "models"); its weights come over
through `convert`.  Bars: `apply_mrope` within 1e-5 of its largest output;
for each arch not covered by `tests/test_torch_moe.py` and
`tests/test_torch_recurrent.py` (the dense ones, qwen2-vl and seamless),
prefill logits and cache, one decode step and the loss within 1e-5, every
gradient leaf within 1e-4 of its own largest value.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import (ARCH_IDS, SHAPES, get_config,
                                      get_smoke_config)
from repro_torch.launch import serve, train
from repro_torch.models.layers import apply_mrope, apply_rope
from repro_torch.models.model import build_model, cache_specs, input_specs
from torch_port_reference import (arch_case, assert_close, check_arch,
                                  run_reference)

# archs whose models are held here; the MoE and recurrent ones in their
# own files
ARCHS = ("phi3-medium-14b", "smollm-360m", "stablelm-12b", "qwen3-14b",
         "qwen2-vl-72b", "seamless-m4t-large-v2")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    rng = np.random.default_rng(0)
    arrays = {"mrope_x": rng.normal(size=(2, 10, 3, 24)).astype(np.float32)}
    t = np.arange(10)
    arrays["mrope_positions"] = np.broadcast_to(
        np.stack([t, 3 * t, t % 2])[:, None], (3, 2, 10)).astype(np.int32)
    cases = [{"kind": "mrope", "name": "mrope"}]
    arch_cases = {}
    for arch in ARCHS:
        case, arr = arch_case(f"arch_{arch}", arch, rng)
        arch_cases[arch] = case
        cases.append(case)
        arrays.update(arr)
    out = run_reference({"task": "models", "cases": cases}, arrays,
                        tmp_path_factory.mktemp("families_ref"))
    return out, arrays, arch_cases


def test_apply_mrope_matches_reference(ref):
    out, arrays, _ = ref
    got = apply_mrope(torch.from_numpy(arrays["mrope_x"]),
                      torch.from_numpy(arrays["mrope_positions"]))
    assert_close(got, out["mrope/out"], 1e-5, "mrope")


def test_mrope_with_equal_sections_is_rope():
    """With the three position streams equal, M-RoPE is plain RoPE."""
    x = torch.randn((2, 7, 4, 48), generator=torch.Generator().manual_seed(0))
    pos = torch.arange(7)[None].expand(2, 7)
    assert torch.allclose(apply_mrope(x, pos[None].expand(3, 2, 7)),
                          apply_rope(x, pos), atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_matches_reference(ref, arch):
    out, arrays, cases = ref
    check_arch(out, arrays, cases[arch])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_arch_trains_on_the_cpu(arch, tmp_path):
    """`launch.train` on each smoke config: two finite steps, from the
    synthetic source's tokens, embeddings or source frames."""
    losses = train.main(["--arch", arch, "--smoke", "--device", "cpu",
                         "--steps", "2", "--batch", "2", "--seq", "32",
                         "--ckpt-dir", str(tmp_path), "--save-every", "50",
                         "--log-every", "1"])
    assert len(losses) == 2 and np.isfinite(losses).all()


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "seamless-m4t-large-v2"])
def test_serve_refuses_stub_frontend_archs(arch):
    with pytest.raises(SystemExit, match="token-in/token-out"):
        serve.main(["--arch", arch, "--smoke", "--device", "cpu"])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_describe_the_models(arch):
    """`input_specs` and `cache_specs` (meta tensors) carry the shapes and
    dtypes of the reference's, and the cache's are the model's own."""
    cfg = get_config(arch)
    spec = input_specs(cfg, SHAPES["train_4k"])
    B, S = 256, 4096
    assert spec["labels"].shape == (B, S)
    if cfg.family == "encdec":
        assert spec["src_embeddings"].shape == (B, S // 8, cfg.d_model)
    elif cfg.input_mode == "embeddings":
        assert spec["embeddings"].shape == (B, S, cfg.d_model)
    assert ("positions" in spec) == (cfg.mrope and cfg.family != "encdec")
    dec = input_specs(cfg, SHAPES["decode_32k"])
    assert "labels" not in dec and all(t.device.type == "meta"
                                       for t in dec.values())
    small = dataclasses.replace(get_smoke_config(arch))
    shape = dataclasses.replace(SHAPES["decode_32k"], seq_len=64,
                                global_batch=2)
    model = build_model(small, "cpu")
    want = model.init_cache(2, 64)
    got = cache_specs(small, shape)
    if small.family == "encdec":
        assert got[1].shape == (2, 16, small.d_model)
        got, want = [c["self"] for c in got[0]], [c["self"] for c in want]
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        assert all(g[k].shape == w[k].shape and g[k].dtype == w[k].dtype
                   for k in w)


def test_llama4_trains_on_bf16_masters_and_moments(tmp_path):
    """llama4's published config keeps bf16 master weights and bf16 AdamW
    moments (`param_dtype`, `optimizer_dtype`); at its smoke width the
    trainer steps them in bf16 and the loss stays finite."""
    cfg = dataclasses.replace(get_smoke_config("llama4-maverick-400b-a17b"),
                              param_dtype="bfloat16",
                              optimizer_dtype="bfloat16")
    args = train.parse_args(["--arch", "llama4-maverick-400b-a17b",
                             "--device", "cpu", "--steps", "3", "--batch",
                             "2", "--seq", "32", "--ckpt-dir", str(tmp_path),
                             "--save-every", "50"])
    run = train.train(cfg, args)
    assert len(run.losses) == 3 and np.isfinite(run.losses).all()
    assert {p.dtype for p in run.state["params"].values()} == {torch.bfloat16}
    assert {m.dtype for m in run.state["opt"]["mu"].values()} == {
        torch.bfloat16}
