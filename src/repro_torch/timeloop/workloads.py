"""Neural-layer workloads from the paper (Fig. 11 / Fig. 12).

Every layer -- conv, FC, or attention projection -- is expressed in the canonical
7-level conv form used by Timeloop:

    R, S : filter height / width
    P, Q : output height / width
    C    : input channels
    K    : output channels
    (N = 1 throughout, as in the paper's inference setting)

FC layers map d_in -> C, d_out -> K, and the token/batch dimension -> P (this is
the standard Timeloop encoding of a GEMM as a 1x1 convolution).
"""

from __future__ import annotations

import dataclasses
import functools
import math
import warnings

DIMS = ("R", "S", "P", "Q", "C", "K")

# Tensor relevance: which loop dims index each operand.
RELEVANCE = {
    "W": frozenset({"R", "S", "C", "K"}),
    "I": frozenset({"R", "S", "P", "Q", "C"}),
    "O": frozenset({"P", "Q", "K"}),
}


@dataclasses.dataclass(frozen=True)
class ConvLayer:
    name: str
    R: int
    S: int
    P: int
    Q: int
    C: int
    K: int
    stride: int = 1

    def dim(self, d: str) -> int:
        return getattr(self, d)

    @property
    def macs(self) -> int:
        return self.R * self.S * self.P * self.Q * self.C * self.K

    def input_extent(self, p: int, r: int) -> int:
        """Input halo extent covering `p` outputs with filter extent `r`."""
        return (p - 1) * self.stride + r

    @property
    def input_size(self) -> int:
        return (
            self.input_extent(self.P, self.R)
            * self.input_extent(self.Q, self.S)
            * self.C
        )

    @property
    def weight_size(self) -> int:
        return self.R * self.S * self.C * self.K

    @property
    def output_size(self) -> int:
        return self.P * self.Q * self.K

    def divisors(self, d: str) -> list[int]:
        return list(divisors(self.dim(d)))


def fc(name: str, d_in: int, d_out: int, tokens: int) -> ConvLayer:
    """FC / projection layer in conv form (tokens -> P)."""
    return ConvLayer(name=name, R=1, S=1, P=tokens, Q=1, C=d_in, K=d_out, stride=1)


def merge_shapes(name: str, items) -> tuple[tuple[ConvLayer, ...],
                                            tuple[int, ...]]:
    """(layers, counts) of `(role, layer, count)` items with identical
    shapes merged by summing their counts, in first-occurrence order, each
    layer named `<name>-<role>` after the first role of its shape."""
    order: dict[tuple, list] = {}
    for role, layer, count in items:
        key = (layer.R, layer.S, layer.P, layer.Q, layer.C, layer.K,
               layer.stride)
        if key in order:
            order[key][1] += count
        else:
            order[key] = [
                dataclasses.replace(layer, name=f"{name}-{role}"), count]
    return (tuple(v[0] for v in order.values()),
            tuple(int(v[1]) for v in order.values()))


# --- Paper workloads (Fig. 11) ------------------------------------------------
# ResNet-18 critical 3x3 layers; DQN conv layers.
_RESNET = [
    ConvLayer("ResNet-K1", R=3, S=3, P=56, Q=56, C=64, K=64, stride=2),
    ConvLayer("ResNet-K2", R=3, S=3, P=28, Q=28, C=128, K=128, stride=1),
    ConvLayer("ResNet-K3", R=3, S=3, P=14, Q=14, C=256, K=256, stride=1),
    ConvLayer("ResNet-K4", R=3, S=3, P=7, Q=7, C=512, K=512, stride=1),
]
_DQN = [
    ConvLayer("DQN-K1", R=8, S=8, P=20, Q=20, C=4, K=16, stride=4),
    ConvLayer("DQN-K2", R=4, S=4, P=9, Q=9, C=16, K=32, stride=2),
]
# Fig. 12: MLP and Transformer projections. The paper evaluates single layers; we
# follow the standard Timeloop GEMM encoding with a 64-token tile mapped to P.
_TOKENS = 64
_MLP = [
    fc("MLP-K1", 512, 512, _TOKENS),
    fc("MLP-K2", 64, 1024, _TOKENS),
]
_TRANSFORMER = [
    fc("Transformer-K1", 512, 16 * 32, _TOKENS),  # h=16, d_k=32
    fc("Transformer-K2", 512, 8 * 64, _TOKENS),   # h=8,  d_k=64
    fc("Transformer-K3", 512, 4 * 128, _TOKENS),  # h=4,  d_k=128
    fc("Transformer-K4", 512, 1 * 512, _TOKENS),  # h=1,  d_k=512
]

MODEL_LAYERS: dict[str, list[ConvLayer]] = {
    "resnet": _RESNET,
    "dqn": _DQN,
    "mlp": _MLP,
    "transformer": _TRANSFORMER,
}

PAPER_WORKLOADS: dict[str, ConvLayer] = {
    layer.name: layer for layers in MODEL_LAYERS.values() for layer in layers
}


def factorize(n: int) -> list[int]:
    """Prime factorization (with multiplicity) of n."""
    out = []
    d = 2
    while d * d <= n:
        while n % d == 0:
            out.append(d)
            n //= d
        d += 1
    if n > 1:
        out.append(n)
    return out


@functools.lru_cache(maxsize=4096)
def divisors(n: int) -> tuple[int, ...]:
    """Sorted divisors of n, memoized: the samplers call this O(pool x dims x
    levels) times per BO trial on a handful of distinct layer-dim values."""
    small, large = [], []
    for i in range(1, int(math.isqrt(n)) + 1):
        if n % i == 0:
            small.append(i)
            if i != n // i:
                large.append(n // i)
    return tuple(small + large[::-1])


# The zoo workload generator (repro.workloads.zoo) produces FC dims far outside
# the paper's (d_model 5120, vocab-shaped K ~ 2e5).  Their divisor *counts* are
# what the constrained samplers scale with -- every per-dim choice builds a
# (pool, n_divisors) candidate mask -- so a highly composite dim (e.g. 720720:
# 240 divisors) would quietly blow the sampler up.  `sampler_divisors` caps the
# ladder the samplers draw from; every paper and zoo dim today sits under the
# cap, so the guard only fires on genuinely pathological shapes.
SAMPLER_DIVISOR_CAP = 128


@functools.lru_cache(maxsize=4096)
def sampler_divisors(n: int) -> tuple[int, ...]:
    """Divisor ladder for the mapping samplers: identical to `divisors(n)` up
    to `SAMPLER_DIVISOR_CAP` entries; beyond that, a geometric subsample that
    always keeps 1 and n (so factor chains still terminate: the outermost
    level absorbs whatever remainder the sampled factors leave).  Any divisor
    subset yields structurally valid mappings -- capping only narrows the
    sampled tilings -- and the cap is announced loudly, once per dim."""
    ds = divisors(n)
    if len(ds) <= SAMPLER_DIVISOR_CAP:
        return ds
    warnings.warn(
        f"dim {n} has {len(ds)} divisors (> SAMPLER_DIVISOR_CAP="
        f"{SAMPLER_DIVISOR_CAP}); the mapping samplers draw from a geometric "
        f"subsample of {SAMPLER_DIVISOR_CAP} divisors (1 and {n} kept), so "
        "some tilings of this dim are unreachable", RuntimeWarning,
        stacklevel=2)
    idx = {round(i * (len(ds) - 1) / (SAMPLER_DIVISOR_CAP - 1))
           for i in range(SAMPLER_DIVISOR_CAP)}
    return tuple(ds[i] for i in sorted(idx))
