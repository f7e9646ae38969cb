"""The PyTorch port's LM serving slice against the JAX reference
(`repro.models`, `repro.launch.serve`).

The reference LM runs in this process on the CPU (its prefill attention is
the pure-JAX `flash_sdpa`); its `init` tree is carried into the port through
`convert.lm_params_from_reference`, and both run on the same tokens, made
with a NumPy seed.  On the CPU the port's prefill attention is K3's plain
version (`flash_attention_ref`).

Bars: in f32 compute the logits agree within 1e-4 (the two packages sum in
other orders; measured 3e-7 to 5e-6).  In bf16 compute the reference rounds its
flash scores to bf16 before the softmax (`flash_sdpa` casts the einsum's
bf16 result) while K3 keeps them in f32, and every bf16 matmul rounds its
output in each package's own order, so the logits are held to 5e-2 of their
largest magnitude (measured 0.8-1.1%).  Served tokens, the int8 cache included, must be equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ARCH_IDS as REF_ARCH_IDS
from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.base import get_config as ref_get_config
from repro.configs.base import get_smoke_config as ref_get_smoke_config
from repro.launch import serve as ref_serve
from repro.models import flops as ref_flops
from repro.models.lm import LM as RefLM
from repro_torch.configs.base import (ARCH_IDS, SHAPES, get_config,
                                      get_smoke_config)
from repro_torch.convert import lm_params_from_reference
from repro_torch.launch import serve
from repro_torch.models import flops
from repro_torch.models.lm import LM
from repro_torch.models.model import build_model

F32 = dict(compute_dtype="float32", kv_cache_dtype="float32")
BF16_BAR = 5e-2


def _configs(name: str, **kw):
    """The same config in both packages."""
    if name == "smoke":
        ref, port = (ref_get_smoke_config("smollm-360m"),
                     get_smoke_config("smollm-360m"))
    else:  # smollm-360m at full width, one layer
        kw = dict(num_layers=1, **kw)
        ref, port = ref_get_config("smollm-360m"), get_config("smollm-360m")
    return dataclasses.replace(ref, **kw), dataclasses.replace(port, **kw)


def _models(ref_cfg, port_cfg, seed=0):
    ref = RefLM(ref_cfg)
    params = ref.init(jax.random.key(seed))
    tree = jax.tree.map(np.asarray, params)
    port = LM(port_cfg, device="cpu").load_params(
        lm_params_from_reference(tree))
    return ref, params, port, tree


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _assert_logits(got, want, compute_dtype):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    if compute_dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        bar = BF16_BAR * np.abs(want).max()
        assert np.abs(got - want).max() <= bar, (np.abs(got - want).max(), bar)


def _prefill_then_decode(ref_cfg, port_cfg, S, n_steps=3, B=2, seed=0):
    """Prefill a zero-padded prompt of S // 2 tokens on S positions, then
    decode `n_steps` tokens (the reference's greedy choices, fed to both)."""
    ref, params, port, _ = _models(ref_cfg, port_cfg, seed)
    rng = np.random.default_rng(seed + 1)
    P = S // 2
    toks = np.zeros((B, S), np.int64)
    toks[:, :P] = rng.integers(0, ref_cfg.vocab_size, (B, P))
    want, cache_ref = jax.jit(ref.prefill)(params, {"tokens": jnp.asarray(toks)})
    got, cache = port.prefill({"tokens": torch.from_numpy(toks)})
    pairs = [(got, want)]
    step = jax.jit(ref.decode_step)
    nxt = np.array(jnp.argmax(want[:, -1, :ref_cfg.vocab_size], axis=-1))
    for i in range(n_steps):
        want, cache_ref = step(params, cache_ref,
                               {"tokens": jnp.asarray(nxt[:, None])},
                               jnp.asarray(P + i, jnp.int32))
        got, cache = port.decode_step(cache, {"tokens": torch.from_numpy(nxt[:, None])},
                                      P + i)
        pairs.append((got, want))
        nxt = np.array(jnp.argmax(want[:, 0, :ref_cfg.vocab_size], axis=-1))
    return pairs, cache, cache_ref


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,S", [("smoke", 64), ("smollm-1layer", 128)])
def test_prefill_and_decode_match_reference(name, S, compute):
    kw = F32 if compute == "float32" else {}
    ref_cfg, port_cfg = _configs(name, **kw)
    pairs, _, _ = _prefill_then_decode(ref_cfg, port_cfg, S)
    for got, want in pairs:
        _assert_logits(got, want, compute)


@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8"])
def test_kv_caches_through_decode_steps(kv):
    ref_cfg, port_cfg = _configs("smoke", compute_dtype="float32",
                                 kv_cache_dtype=kv)
    pairs, cache, cache_ref = _prefill_then_decode(ref_cfg, port_cfg, 64,
                                                   n_steps=4)
    for got, want in pairs:
        _assert_logits(got, want, "float32")
    # a fresh cache has the reference's leaves, shapes and dtypes
    ref_empty = RefLM(ref_cfg).init_cache(2, 64)["pos0"]
    port_empty = LM(port_cfg, "cpu").init_cache(2, 64)
    assert len(port_empty) == ref_cfg.num_layers
    assert sorted(port_empty[0]) == sorted(ref_empty)
    for key, leaf in port_empty[0].items():
        assert tuple(leaf.shape) == ref_empty[key].shape[1:]
        assert str(leaf.dtype).split(".")[1] == str(ref_empty[key].dtype)
        assert not leaf.any()
    # the caches themselves: layer 0 of the port is super-block 0 of the
    # reference, every position written by prefill and by the decode steps
    for key in cache[0]:
        ref_leaf = np.asarray(cache_ref["pos0"][key][0])
        port_leaf = cache[0][key]
        assert port_leaf.dtype == {"int8": torch.int8, "float32": torch.float32,
                                   "bfloat16": torch.bfloat16}[
            "float32" if key.endswith("scale") else kv]
        if kv == "int8" and not key.endswith("scale"):
            # f32 sums one ulp apart can round x / scale to the next integer
            assert np.abs(port_leaf.numpy().astype(int)
                          - ref_leaf.astype(int)).max() <= 1
        else:
            np.testing.assert_allclose(_f32(port_leaf),
                                       ref_leaf.astype(np.float32),
                                       rtol=1e-4, atol=1e-5)


def test_flash_and_naive_prefill_agree_in_the_port():
    ref_cfg, port_cfg = _configs("smoke", **F32)
    _, _, flash, tree = _models(ref_cfg, port_cfg)
    naive = LM(dataclasses.replace(port_cfg, attn_impl="naive"), "cpu")
    naive.load_params(lm_params_from_reference(tree))
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (2, 64)))
    (lf, cf), (ln_, cn) = flash.prefill({"tokens": toks}), naive.prefill(
        {"tokens": toks})
    np.testing.assert_allclose(lf.numpy(), ln_.numpy(), rtol=1e-5, atol=1e-5)
    assert torch.equal(cf[1]["k"], cn[1]["k"])


def test_serve_matches_reference_tokens_on_smoke_config(monkeypatch):
    ref_cfg, port_cfg = _configs("smoke", **F32)
    argv = ["--arch", "smollm-360m", "--smoke", "--requests", "3", "--batch",
            "2", "--prompt-len", "20", "--gen-len", "6", "--seed", "3"]
    monkeypatch.setattr(ref_serve, "get_smoke_config", lambda arch: ref_cfg)
    want = ref_serve.main(argv)
    tree = jax.tree.map(np.asarray, RefLM(ref_cfg).init(jax.random.key(3)))
    got = serve.main(argv + ["--device", "cpu"], config=port_cfg,
                     params=lm_params_from_reference(tree))
    assert [r.rid for r in got] == [r.rid for r in want] == [0, 1, 2]
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    # the reference's first token is the argmax over the padded vocabulary
    assert any(r.out_tokens[0] >= ref_cfg.vocab_size for r in got)
    assert all(t < ref_cfg.vocab_size for r in got for t in r.out_tokens[1:])


def test_serve_stats_count_the_calls():
    args = serve.parse_args(["--arch", "smollm-360m", "--smoke", "--requests",
                             "3", "--batch", "2", "--prompt-len", "10",
                             "--gen-len", "4", "--device", "cpu"])
    done, stats = serve.serve(get_smoke_config("smollm-360m"), args)
    assert [len(r.out_tokens) for r in done] == [4, 4, 4]
    assert stats["decode_steps"] == 2 * 4 and stats["prefill_calls"] == 4
    assert stats["S_max"] == 64 and stats["tok_s"] > 0


def test_init_draws_the_reference_distributions():
    cfg = get_smoke_config("qwen3-14b")
    model = LM(dataclasses.replace(cfg, **F32), "cpu").init(
        torch.Generator().manual_seed(0))
    blk = model.blocks[0]
    D, F = cfg.d_model, cfg.d_ff
    assert torch.count_nonzero(blk.attn["ln"]) == 0
    assert torch.count_nonzero(blk.attn["q_norm"]) == 0
    for w, std in ((blk.attn["wq"], D ** -0.5), (blk.mlp["wo_mlp"], F ** -0.5),
                   (model.embed["embedding"], 0.02)):
        assert abs(float(w.std()) / std - 1) < 0.1
    again = LM(dataclasses.replace(cfg, **F32), "cpu").init(
        torch.Generator().manual_seed(0))
    assert torch.equal(again.blocks[1].mlp["wi_mlp_up"],
                       model.blocks[1].mlp["wi_mlp_up"])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_and_flops_are_the_reference_copies(arch):
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
        ref_get_config(arch))
    assert dataclasses.asdict(get_smoke_config(arch)) == dataclasses.asdict(
        ref_get_smoke_config(arch))
    for shape in SHAPES:
        assert flops.forward_flops(get_config(arch), SHAPES[shape]) == (
            ref_flops.forward_flops(ref_get_config(arch), REF_SHAPES[shape]))
    assert ARCH_IDS == REF_ARCH_IDS


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_arch_builds_prefills_and_decodes_on_the_cpu(arch):
    """`build_model(get_smoke_config(arch), "cpu")` for all ten archs (every
    block kind and family is ported): the model class of the family, finite
    prefill and decode logits of the padded vocabulary, and a cache of one
    entry a decoder layer."""
    from repro_torch.models.encdec import EncDecLM

    cfg = get_smoke_config(arch)
    model = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    assert isinstance(model, EncDecLM if cfg.family == "encdec" else LM)
    rng = np.random.default_rng(1)
    B, S, D = 1, 64, cfg.d_model
    step = {"tokens": np.ones((B, 1), np.int64)}
    if cfg.family == "encdec":
        batch = {"src_embeddings": rng.normal(size=(B, 16, D)),
                 "tokens": np.zeros((B, S), np.int64)}
    elif cfg.input_mode == "embeddings":
        batch = {"embeddings": rng.normal(size=(B, S, D))}
        step = {"embeddings": rng.normal(size=(B, 1, D))}
    else:
        batch = {"tokens": np.zeros((B, S), np.int64)}
    logits, cache = model.prefill(batch)
    assert logits.shape == (B, 1, cfg.padded_vocab())
    caches = cache[0] if cfg.family == "encdec" else cache
    assert len(caches) == cfg.num_layers
    logits, _ = model.decode_step(cache, step, S - 1)
    assert logits.shape == (B, 1, cfg.padded_vocab())
    assert torch.isfinite(logits.float()).all()
