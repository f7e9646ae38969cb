"""DeepSeek-V3's decode step as a co-design workload: latent attention over
a long cache and routed experts, as the GEMM set the cost model searches.

In the absorbed form of multi-head latent attention (MLA), every term of a
decode step is a GEMM with one shared operand: all heads of a sequence read
one cache of the latent and the shared rope key, [kv_lora_rank +
qk_rope_head_dim] a position, and all tokens read each projection.  So the
whole block fits the 1x1-conv GEMM encoding (`timeloop.workloads.fc`:
rows -> P, in -> C, out -> K) with no batch dimension; the count of a layer
is how many times the step runs that GEMM.

The set holds one instance of every GEMM of the block pattern: the
attention (shared by all layers), the MoE FFN of the layers after
`first_k_dense_replace`, and the dense FFN of the leading layers, counted
once as ResNet-K1..K4 select ResNet-18's layers.  The output head and the
multi-token-prediction module run once a token, not once a layer, and are
left out, as the paper's sets leave out a network's stem and classifier.

The deployment is decode serving: `batch` sequences a step at `context`
positions each, and expert parallelism that hands each expert
`tokens_per_expert` tokens a step.  Identical shapes merge by summing their
counts (the shared expert runs at P = batch, the routed ones at P =
tokens_per_expert), as the zoo merges them.  The tests hold the set to
the GEMMs a plain reference of the layer runs, shape for shape and MAC for
MAC (`tests/test_torch_deepseek_v3.py`).
"""

from __future__ import annotations

import dataclasses
import functools

from repro_torch.timeloop.workloads import ConvLayer, fc, merge_shapes

SOURCE = "https://huggingface.co/deepseek-ai/DeepSeek-V3/blob/main/config.json"


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """The published keys the decode step's shapes read, under their names
    in the source's config.json."""

    hidden_size: int
    num_attention_heads: int
    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int
    intermediate_size: int
    moe_intermediate_size: int
    n_routed_experts: int
    num_experts_per_tok: int
    n_shared_experts: int


# DeepSeek-V3's config.json (SOURCE), copied by hand.
DEEPSEEK_V3 = MLAConfig(
    hidden_size=7168, num_attention_heads=128, q_lora_rank=1536,
    kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
    v_head_dim=128, intermediate_size=18432, moe_intermediate_size=2048,
    n_routed_experts=256, num_experts_per_tok=8, n_shared_experts=1)


@dataclasses.dataclass(frozen=True)
class Deployment:
    """What one accelerator runs a decode step: attention for `batch`
    sequences at `context` positions, and `tokens_per_expert` tokens for
    each expert it holds."""

    batch: int
    context: int
    tokens_per_expert: int


# 128 sequences at 32,768 positions (`configs.base.SHAPES["decode_32k"]`);
# expert parallelism over a 4,096-token global step: 4096 * 8 / 256 = 128.
DECODE_32K = Deployment(batch=128, context=32768, tokens_per_expert=128)


@dataclasses.dataclass(frozen=True)
class DecodeWorkload:
    name: str                       # registry name ("deepseek_v3")
    layers: tuple[ConvLayer, ...]   # unique shapes, first-occurrence order
    counts: tuple[int, ...]         # GEMMs of that shape a step
    total_macs: int                 # sum(count * layer.macs)


def routed_instances(cfg: MLAConfig, dep: Deployment) -> int:
    """Routed-expert GEMM instances a step: batch * top_k token slots in
    groups of `tokens_per_expert`."""
    slots = dep.batch * cfg.num_experts_per_tok
    if slots % dep.tokens_per_expert:
        raise ValueError(
            f"batch {dep.batch} x top-{cfg.num_experts_per_tok} = {slots} "
            f"token slots do not fill experts of {dep.tokens_per_expert}")
    return slots // dep.tokens_per_expert


def decode_items(cfg: MLAConfig, dep: Deployment
                 ) -> list[tuple[str, ConvLayer, int]]:
    """(role, GEMM, count a step) of every GEMM of the block pattern."""
    B, T, D = dep.batch, dep.context, cfg.hidden_size
    H, dn, dr = (cfg.num_attention_heads, cfg.qk_nope_head_dim,
                 cfg.qk_rope_head_dim)
    kvr, dv = cfg.kv_lora_rank, cfg.v_head_dim
    Fe = cfg.moe_intermediate_size
    n = routed_instances(cfg, dep)
    return [
        ("q_a", fc("q_a", D, cfg.q_lora_rank, B), 1),
        ("q_b", fc("q_b", cfg.q_lora_rank, H * (dn + dr), B), 1),
        ("kv_a", fc("kv_a", D, kvr + dr, B), 1),
        # W_UK absorbed into each head's query; rows are the tokens.
        ("q_absorb", fc("q_absorb", dn, kvr, B), H),
        # Each sequence's heads against its cache; rows are the heads.
        ("scores", fc("scores", kvr + dr, T, H), B),
        ("pv", fc("pv", T, kvr, H), B),
        # W_UV applied to each head's latent output.
        ("v_up", fc("v_up", kvr, dv, B), H),
        ("o", fc("o", H * dv, D, B), 1),
        ("router", fc("router", D, cfg.n_routed_experts, B), 1),
        # Gate and up, then down, of the routed experts and the shared one.
        ("expert_up", fc("expert_up", D, Fe, dep.tokens_per_expert), 2 * n),
        ("expert_down", fc("expert_down", Fe, D, dep.tokens_per_expert), n),
        ("shared_up", fc("shared_up", D, Fe * cfg.n_shared_experts, B), 2),
        ("shared_down", fc("shared_down", Fe * cfg.n_shared_experts, D, B),
         1),
        ("dense_up", fc("dense_up", D, cfg.intermediate_size, B), 2),
        ("dense_down", fc("dense_down", cfg.intermediate_size, D, B), 1),
    ]


def decode_workload(cfg: MLAConfig = DEEPSEEK_V3,
                    dep: Deployment = DECODE_32K,
                    name: str = "deepseek_v3") -> DecodeWorkload:
    """The decode step's GEMM set, identical shapes merged."""
    layers, counts = merge_shapes(name, decode_items(cfg, dep))
    return DecodeWorkload(
        name=name, layers=layers, counts=counts,
        total_macs=sum(c * ly.macs for c, ly in zip(counts, layers)))


# Registry name -> (config, deployment); `zoo.resolve_workload` reaches
# these by name, dashed aliases accepted.
DECODE_SETS = {"deepseek_v3": (DEEPSEEK_V3, DECODE_32K)}


@functools.lru_cache(maxsize=None)
def decode_set(name: str) -> DecodeWorkload:
    cfg, dep = DECODE_SETS[name]
    return decode_workload(cfg, dep, name)
