"""DeepSeek-V3's decode step as a workload of the port
(`repro_torch.workloads.mla_decode`), held to the plain reference of the
layer (`tests/deepseek_v3_reference.py`):

  * the reference's absorbed decode step equals its naive form at the last
    position of a prefix, in float32; the same step in bf16 does not;
  * every GEMM the reference's decode step runs, recorded at the dispatcher,
    is the registry's set for the same config, shape for shape and count
    for count (the routed experts by their summed rows), with the same
    MACs -- on the CPU at a small size, and on the `meta` device at the
    published widths and the deployment's batch and context;
  * the service, the portfolio and the registry reach the set by name.

The card's run of the first check at the published widths is marked `cuda`:

    PYTHONPATH=src python -m pytest -q -s -m cuda tests/test_torch_deepseek_v3.py
"""

import collections
import dataclasses

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import deepseek_v3_reference as ref
from repro_torch.workloads import PortfolioConfig, known_workloads
from repro_torch.workloads import resolve_workload
from repro_torch.workloads.mla_decode import (DECODE_32K, DEEPSEEK_V3,
                                              Deployment, MLAConfig,
                                              decode_set, decode_workload)
from repro_torch.workloads.zoo import ZOO_NAMES

# The absorbed step sums the same float32 products as the naive form in
# another order (q through W_UK before the cache, W_UV after the
# probabilities).  A reordered float32 sum of n terms moves by ~sqrt(n)
# units of 2**-24 of its magnitude; the longest reductions of the step are
# the context (32,768 at the published widths) and H * v_head_dim (16,384):
# sqrt(32768) * 6e-8 = 1.1e-5, so 1e-4 of the output's largest entry leaves
# room above, and bf16's unit (3.9e-3) lies far beyond it.
TOL = 1e-4

# A small config of the same structure: no two roles share a shape by
# accident, and batch * top_k fills the experts evenly.
SMALL = dict(hidden_size=64, num_attention_heads=4, q_lora_rank=32,
             kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=8,
             v_head_dim=12, intermediate_size=96, moe_intermediate_size=24,
             n_routed_experts=16, num_experts_per_tok=4, n_shared_experts=1)
SMALL_REF = ref.Config(**SMALL, n_group=4, topk_group=2)
SMALL_BATCH, SMALL_CONTEXT = 8, 40

# The decode step at the published widths: (role, P, C, K, count a step).
TABLE = [
    ("q_a", 128, 7168, 1536, 1),
    ("q_b", 128, 1536, 24576, 1),
    ("kv_a", 128, 7168, 576, 1),
    ("q_absorb", 128, 128, 512, 128),
    ("scores", 128, 576, 32768, 128),
    ("pv", 128, 32768, 512, 128),
    ("v_up", 128, 512, 128, 128),
    ("o", 128, 16384, 7168, 1),
    ("router", 128, 7168, 256, 1),
    ("expert_up", 128, 7168, 2048, 18),
    ("expert_down", 128, 2048, 7168, 9),
    ("dense_up", 128, 7168, 18432, 2),
    ("dense_down", 128, 18432, 7168, 1),
]

ATEN = torch.ops.aten


class GemmRecorder(TorchDispatchMode):
    """Counts every GEMM the dispatcher runs as (rows, in, out)."""

    def __init__(self):
        super().__init__()
        self.gemms = collections.Counter()
        self.other = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is ATEN.mm.default:
            a, b = args
            self.gemms[(a.shape[0], a.shape[1], b.shape[1])] += 1
        elif func is ATEN.addmm.default:
            a, b = args[1], args[2]
            self.gemms[(a.shape[0], a.shape[1], b.shape[1])] += 1
        elif func is ATEN.bmm.default:
            a, b = args
            self.gemms[(a.shape[1], a.shape[2], b.shape[2])] += a.shape[0]
        elif func in (ATEN.baddbmm.default, ATEN.mv.default,
                      ATEN.dot.default, ATEN.addbmm.default):
            self.other.append(func)
        return func(*args, **kwargs)


def _inputs(cfg, batch, context, device, seed=0):
    """Normed hidden states of `batch` sequences at `context` positions."""
    gen = torch.Generator(device).manual_seed(seed)
    attn = ref.init_mla(cfg, torch.Generator().manual_seed(seed), device)
    x = torch.randn(batch, context, cfg.hidden_size, generator=gen,
                    device=device)
    return attn, ref.rms_norm(x, attn["attn_norm"], cfg.rms_norm_eps)


def absorbed_vs_naive(cfg, batch, context, device, dtype=torch.float32):
    """max |absorbed - naive| / max |naive| at the last position, with the
    absorbed step (its weights, cache and token) run in `dtype`."""
    attn, xn = _inputs(cfg, batch, context, device)
    with torch.no_grad():
        naive = ref.mla_naive(attn, cfg, xn, n_queries=1)[:, 0]
        cache = ref.latent_cache(attn, cfg, xn[:, :-1])
        low = {k: v.to(dtype) for k, v in attn.items()}
        out, _ = ref.mla_decode(low, cfg, xn[:, -1].to(dtype),
                                cache.to(dtype))
    err = (out.to(torch.float32) - naive).abs().max() / naive.abs().max()
    return float(err)


# --- the absorbed decode step against the naive form ------------------------

def test_absorbed_decode_matches_the_naive_form():
    assert absorbed_vs_naive(SMALL_REF, 3, SMALL_CONTEXT, "cpu") <= TOL


def test_bf16_absorbed_decode_fails_the_tolerance():
    assert absorbed_vs_naive(SMALL_REF, 3, SMALL_CONTEXT, "cpu",
                             torch.bfloat16) > TOL


def test_the_whole_layer_decodes_as_its_naive_form():
    """The layer's decode step (MLA absorbed, then the MoE) against the
    whole layer over the prefix at its last position, and the cache the
    step grows against the cache of the whole prefix."""
    cfg = SMALL_REF
    gen = torch.Generator().manual_seed(1)
    attn = ref.init_mla(cfg, gen)
    mlp = ref.init_ffn(cfg, gen, moe=True)
    x = torch.randn(3, SMALL_CONTEXT, cfg.hidden_size, generator=gen)
    with torch.no_grad():
        want = ref.layer_naive(attn, mlp, cfg, x)[:, -1]
        xn = ref.rms_norm(x, attn["attn_norm"], cfg.rms_norm_eps)
        got, cache = ref.layer_decode(attn, mlp, cfg, x[:, -1],
                                      ref.latent_cache(attn, cfg, xn[:, :-1]))
    assert float((got - want).abs().max() / want.abs().max()) <= TOL
    assert torch.allclose(cache, ref.latent_cache(attn, cfg, xn),
                          rtol=0, atol=1e-6)


# --- the recorded decode step against the registry -------------------------

def _record_step(cfg, batch, context, device, assignment=None):
    """The GEMMs of one decode step of an MoE layer plus the dense FFN of a
    leading layer: one instance of every GEMM of the block pattern."""
    gen = torch.Generator().manual_seed(2)
    attn = ref.init_mla(cfg, gen, device)
    moe = ref.init_ffn(cfg, gen, moe=True, device=device)
    dense = ref.init_ffn(cfg, gen, moe=False, device=device)
    if device == "meta":
        x = torch.empty(batch, cfg.hidden_size, device=device)
        cache = torch.empty(batch, context - 1,
                            cfg.kv_lora_rank + cfg.qk_rope_head_dim,
                            device=device)
    else:
        x = torch.randn(batch, cfg.hidden_size, generator=gen)
        cache = torch.randn(batch, context - 1,
                            cfg.kv_lora_rank + cfg.qk_rope_head_dim,
                            generator=gen)
    rec = GemmRecorder()
    with torch.no_grad(), rec:
        h, _ = ref.layer_decode(attn, moe, cfg, x, cache, assignment)
        ref.dense_ffn(dense, cfg, h)
    assert rec.other == []
    return rec.gemms


def _macs(gemms) -> int:
    return sum(n * p * c * k for (p, c, k), n in gemms.items())


def _registry(workload) -> collections.Counter:
    return collections.Counter({(ly.P, ly.C, ly.K): n for ly, n in
                                zip(workload.layers, workload.counts)})


def test_the_recorded_decode_step_is_the_registrys_set():
    mla = MLAConfig(**SMALL)
    tpe = (SMALL_BATCH * mla.num_experts_per_tok) // mla.n_routed_experts
    dep = Deployment(batch=SMALL_BATCH, context=SMALL_CONTEXT,
                     tokens_per_expert=tpe)
    want = _registry(decode_workload(mla, dep, name="small"))
    got = _record_step(SMALL_REF, SMALL_BATCH, SMALL_CONTEXT, "cpu")
    # The experts' GEMMs by (in, out): routing is uneven, so only their
    # summed rows are fixed.
    F, D = mla.moe_intermediate_size, mla.hidden_size
    experts = {(D, F), (F, D)}

    def split(gemms):
        rows = collections.Counter()
        rest = collections.Counter()
        for (p, c, k), n in gemms.items():
            if (c, k) in experts:
                rows[(c, k)] += n * p
            else:
                rest[(p, c, k)] += n
        return rows, rest

    assert split(got) == split(want)
    assert _macs(got) == _macs(want)


def test_the_published_widths_record_the_thirteen_gemms():
    """On `meta` tensors (shapes, no memory), at the deployment's batch and
    context; a balanced assignment, 128 tokens to each of 8 experts, stands
    in for the router's choice, which needs values."""
    k = DEEPSEEK_V3.num_experts_per_tok
    assignment = torch.arange(k).repeat(DECODE_32K.batch, 1)
    got = _record_step(ref.Config(), DECODE_32K.batch, DECODE_32K.context,
                       "meta", assignment)
    workload = decode_set("deepseek_v3")
    assert [(ly.name.split("-", 1)[1], ly.P, ly.C, ly.K, n) for ly, n in
            zip(workload.layers, workload.counts)] == TABLE
    assert got == _registry(workload)
    assert _macs(got) == workload.total_macs


def test_the_reference_reads_the_published_config():
    """The reference's defaults are the registry's published keys."""
    published = dataclasses.asdict(DEEPSEEK_V3)
    assert {k: getattr(ref.Config(), k) for k in published} == published


def test_experts_that_do_not_fill_raise():
    with pytest.raises(ValueError, match="token slots"):
        decode_workload(DEEPSEEK_V3, dataclasses.replace(
            DECODE_32K, tokens_per_expert=100))


# --- the registry ------------------------------------------------------------

@pytest.mark.parametrize("name", ["deepseek_v3", "deepseek-v3"])
def test_the_registry_resolves_the_decode_set(name):
    layers = resolve_workload(name)
    assert layers == list(decode_set("deepseek_v3").layers)
    assert len(layers) == 13
    assert all((ly.R, ly.S, ly.Q, ly.stride) == (1, 1, 1, 1) for ly in layers)
    assert "deepseek_v3" in known_workloads()
    # The zoo's registry, which must equal the reference's, is untouched.
    assert "deepseek_v3" not in ZOO_NAMES


def test_the_service_and_the_portfolio_take_it_by_name():
    from repro_torch.service.scheduler import ServiceRequest

    req = ServiceRequest.from_dict({"layers": "deepseek-v3"})
    assert list(req.layers) == resolve_workload("deepseek_v3")
    PortfolioConfig(workloads=("resnet", "deepseek_v3"))


# --- on the card ---------------------------------------------------------------

@pytest.mark.cuda
def test_absorbed_decode_matches_the_naive_form_at_published_widths():
    """2 sequences x 32,768 positions at the published widths, float32 with
    TF32 off (~11 GB of the naive form's K and V); bf16 as the control."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the check runs at the published "
                    "widths")
    cfg = ref.Config()
    f32 = absorbed_vs_naive(cfg, 2, 32768, "cuda")
    bf16 = absorbed_vs_naive(cfg, 2, 32768, "cuda", torch.bfloat16)
    print(f"absorbed vs naive at 2 x 32768, published widths: float32 "
          f"{f32:.3e}, bf16 {bf16:.3e}, tolerance {TOL:.0e} "
          f"({torch.cuda.get_device_name(0)})")
    assert f32 <= TOL < bf16
