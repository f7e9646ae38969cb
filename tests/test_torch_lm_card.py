"""Kernels K2 (`tiled_matmul`) and K3 (`flash_attention`) on the card,
against their plain versions on the same inputs.

Card-only (the `cuda` marker; they skip without a card).  This file imports
no jax, so it runs on a machine with the card but without the reference:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_lm_card.py

The bf16 cases at the end reach the edges of the tensor-core designs: K2's
one-warpgroup block (M = 64), bn = 64 (N = 320), a long K and a block other
than the default; K3's padded hd 8, hd 128, a single 64-row tile and g = 1.
The f32 cases reach those of K2's register-tiled design: M = 64 (bm 64),
N = 320 (bn 64), K = 2560 at every bk, and each compiled (bm, bn); and of
K3's: every head dim (output vectors of 1, 2 and 4 columns; one V stage
at hd 160), g in {1, 3, 4}, and S of 64, 192 and 1088, whose leading 128-row
q tile is half empty.  The padded cases hold the shapes the kernels take
only through the wrapper's padding: S not a multiple of 64, Sq < Sk, Sq >
Sk, and hd 20 and 160.

Bars, as `chip_smoke.py` holds the kernels: matmul f32 1e-4 relative with
atol 1e-4 * sqrt(K), bf16 1e-2 relative with atol 1e-3 (one bf16 ulp of the
output); attention f32 1e-4, bf16 1e-2 relative with atol 5e-3
against the plain version and atol 2e-3 against the plain version with the
kernels' roundings (`flash_attention_rounded_ref`).

K3-bwd (`flash_attention_bwd`) is held against `flash_attention_bwd_ref` on
the same padded operands, K3's own output and log-sum-exp: f32 within 1e-4
of each gradient's largest magnitude plus 1e-4 relative (the f32 sums run in
other orders); bf16 within 2^-7 of the largest magnitude, one bf16 ulp at
the gradient's scale (both round the same f32 sums once to bf16).  K3's
lse is held to `flash_attention_lse_ref` within 1e-4, and K3 with the lse
store gives an output bit-equal to K3 without it.  Further K3-bwd shapes
reach the edges of its two designs (bf16 `mma_sync`, f32 `simt_4x8`): one
q tile against several k tiles, g = 5 and the train path's heads at S 1024,
hd 8 (padded to the mma's k of 16) and hd 160 (two query halves a warp in
bf16, 256 threads and one ring stage in f32); two calls on the same
operands give bit-equal gradients; and the shared memory the library
launches each K3-bwd kernel with is `bwd_smem_bytes`.

The LM stack's block kinds on the card: the MoE block's gathered path equal
to the CPU's with an expert over capacity (llama4's smoke width, top-1,
f32), both MoE paths bit-equal over two calls, forward and backward (no
atomics), and each new family's prefill and decode steps against the CPU
in f32 within 1e-4 of the largest logit.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (
    HEAD_DIMS, _launch_forward, built_bwd_smem_bytes, built_smem_bytes,
    bwd_smem_bytes, flash_attention, flash_attention_bwd, flash_attention_fwd,
    pad_operands, smem_bytes)
from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                     flash_attention_lse_ref,
                                     flash_attention_ref,
                                     flash_attention_rounded_ref, matmul_ref)
from repro_torch.kernels.tiled_matmul import tiled_matmul

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# dtype -> (rtol, atol)
ATTN_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 5e-3)}
ATTN_ROUNDED_TOL = (1e-2, 2e-3)
SMOLLM_M = 8 * 1088


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().cpu().numpy()


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(256, 128, 384), (SMOLLM_M, 960, 320)])
def test_cuda_matmul_matches_plain_on_card(m, k, n, dtype):
    _card()
    rng = np.random.default_rng(5)
    tdt = DTYPES[dtype]
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to("cuda", tdt)
    w = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32)).to("cuda", tdt)
    before = tiled_matmul.launches
    got = tiled_matmul(x, w)
    torch.cuda.synchronize()
    assert tiled_matmul.launches == before + 1
    rtol, atol = (1e-2, 1e-3) if dtype == "bfloat16" else (1e-4, 1e-4 * k ** 0.5)
    np.testing.assert_allclose(_np(got), _np(matmul_ref(x, w)),
                               rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KV,hd", [(2, 128, 8, 2, 32), (2, 192, 15, 5, 64),
                                         (1, 128, 4, 1, 128)])
def test_cuda_attention_matches_plain_on_card(B, S, H, KV, hd, dtype):
    _card()
    rng = np.random.default_rng(6)
    tdt = DTYPES[dtype]
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to("cuda", tdt)
               for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
    before = flash_attention.launches
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    rtol, atol = ATTN_TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(flash_attention_ref(q, k, v)),
                               rtol=rtol, atol=atol)
    if dtype == "bfloat16":
        rtol, atol = ATTN_ROUNDED_TOL
        np.testing.assert_allclose(
            _np(got), _np(flash_attention_rounded_ref(q, k, v)),
            rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,blocks", [
    (64, 2560, 320, None),             # bm clipped to 64: one warpgroup
    (256, 2560, 320, (64, 128, 64)),   # bk 128: two swizzle rows a stage
    (128, 256, 256, (64, 64, 128)),    # one warpgroup, two 64-column boxes
    (256, 960, 384, (64, 192, 64)),    # K 960 in five 192-deep stages
])
def test_cuda_bf16_matmul_design_edges(m, k, n, blocks):
    _card()
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(
        "cuda", torch.bfloat16)
    w = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32)).to(
        "cuda", torch.bfloat16)
    before = tiled_matmul.launches
    got = tiled_matmul(x, w) if blocks is None else tiled_matmul(x, w, *blocks)
    torch.cuda.synchronize()
    assert tiled_matmul.launches == before + 1
    np.testing.assert_allclose(_np(got), _np(matmul_ref(x, w)),
                               rtol=1e-2, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,blocks", [
    (64, 2560, 320, None),             # defaults clipped: (64, 16, 64)
    (64, 2560, 320, (64, 8, 64)),      # each bk
    (64, 2560, 320, (64, 32, 64)),
    (256, 512, 384, (128, 8, 128)),    # each compiled (bm, bn)
    (256, 512, 384, (128, 32, 64)),
    (256, 512, 384, (64, 16, 128)),
])
def test_cuda_f32_matmul_design_edges(m, k, n, blocks):
    _card()
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).cuda()
    w = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32)).cuda()
    before = tiled_matmul.launches
    got = tiled_matmul(x, w) if blocks is None else tiled_matmul(x, w, *blocks)
    torch.cuda.synchronize()
    assert tiled_matmul.launches == before + 1
    np.testing.assert_allclose(_np(got), _np(matmul_ref(x, w)),
                               rtol=1e-4, atol=1e-4 * k ** 0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KV,hd", [
    (2, 128, 6, 3, 8),    # hd 8: Q and K padded to the mma's k of 16
    (1, 64, 4, 4, 128),   # one 64-row tile, g = 1, hd 128
    (2, 64, 6, 6, 64),    # one tile, g = 1
    (1, 256, 4, 1, 128),  # hd 128 over four tiles, g = 4
])
def test_cuda_bf16_attention_design_edges(B, S, H, KV, hd):
    _card()
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(
        "cuda", torch.bfloat16)
        for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
    before = flash_attention.launches
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    rtol, atol = ATTN_TOL["bfloat16"]
    np.testing.assert_allclose(_np(got), _np(flash_attention_ref(q, k, v)),
                               rtol=rtol, atol=atol)
    rtol, atol = ATTN_ROUNDED_TOL
    np.testing.assert_allclose(
        _np(got), _np(flash_attention_rounded_ref(q, k, v)),
        rtol=rtol, atol=atol)


# S 64, 192 and 1088 start with a half 128-row q tile; hd 8, 16 and >= 32
# give output vectors of 1, 2 and 4 columns.
@pytest.mark.cuda
@pytest.mark.parametrize("S", [64, 128, 192, 1088])
@pytest.mark.parametrize("g", [1, 3, 4])
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_cuda_f32_attention_design_edges(hd, g, S):
    _card()
    rng = np.random.default_rng(10)
    B, KV = 2, 2
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).cuda()
               for s in ((B, S, g * KV, hd), (B, S, KV, hd), (B, S, KV, hd)))
    before = flash_attention.launches
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    rtol, atol = ATTN_TOL["float32"]
    np.testing.assert_allclose(_np(got), _np(flash_attention_ref(q, k, v)),
                               rtol=rtol, atol=atol)


# Shapes the kernels do not run as they are: the wrapper pads S to multiples
# of 64 (passing the true key count) and hd to a compiled head dim.  hd 20 is
# smollm-360m's smoke config, hd 160 stablelm-12b's; S 100, Sq < Sk and
# Sq > Sk.
PADDED_SHAPES = [
    (1, 100, 100, 3, 1, 20),
    (2, 100, 100, 32, 8, 160),
    (1, 256, 256, 32, 8, 160),
    (1, 100, 150, 4, 2, 20),
    (1, 64, 192, 4, 2, 64),
    (2, 150, 70, 4, 2, 64),
    (1, 130, 20, 6, 3, 160),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd", PADDED_SHAPES)
def test_cuda_attention_padded_shapes_match_plain(B, Sq, Sk, H, KV, hd, dtype):
    _card()
    rng = np.random.default_rng(11)
    tdt = DTYPES[dtype]
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to("cuda", tdt)
               for s in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd)))
    before = flash_attention.launches
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.shape == q.shape and got.dtype == q.dtype
    rtol, atol = ATTN_TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(flash_attention_ref(q, k, v)),
                               rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_cuda_attention_smem_bytes_is_the_librarys(hd, dtype):
    # The wrapper's layout, which the CPU tests read, is what the built
    # library launches a CTA with.
    _card()
    assert smem_bytes(hd, DTYPES[dtype]) == built_smem_bytes(hd, DTYPES[dtype])


# K3-bwd: every compiled head dim, g in {1, 2, 3, 4}, one and several q tiles,
# the train shape's heads, and the shapes the wrapper pads: S 100 at hd 20,
# Sq > Sk, Sq < Sk, hd 160 at S 100.
BWD_SHAPES = [
    (2, 128, 128, 6, 2, 8),
    (2, 128, 128, 4, 4, 16),
    (1, 192, 192, 6, 2, 32),
    (2, 256, 256, 15, 5, 64),
    (1, 128, 128, 4, 1, 128),
    (1, 128, 128, 4, 2, 160),
    (1, 100, 100, 3, 1, 20),
    (2, 150, 70, 4, 2, 64),
    (1, 70, 150, 4, 2, 20),
    (1, 100, 100, 8, 2, 160),
]
BWD_F32_TOL = (1e-4, 1e-4)   # (atol as a share of max |g|, rtol)
BWD_BF16_TOL = 2.0 ** -7     # atol as a share of max |g|


def _bwd_inputs(B, Sq, Sk, H, KV, hd, tdt, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to("cuda", tdt)
            for s in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd),
                      (B, Sq, H, hd))]


def _bwd_padded(B, Sq, Sk, H, KV, hd, tdt, seed):
    """The padded operands, K3's output and lse, and dO, as FlashAttentionFn
    hands them to K3-bwd (padded rows of dO zero, as the pad's backward
    gives them); K3's lse is held to the plain one within 1e-4."""
    q, k, v, do = _bwd_inputs(B, Sq, Sk, H, KV, hd, tdt, seed)
    qp, kp, vp = pad_operands(q, k, v)
    dop = pad_operands(do, k, v)[0]
    dop[:, Sq:] = 0
    scale = hd ** -0.5
    out, lse = flash_attention_fwd(qp, kp, vp, scale=scale, sk_valid=Sk)
    _, lse_ref = flash_attention_lse_ref(qp, kp, vp, scale=scale,
                                         sk_valid=Sk)
    np.testing.assert_allclose(_np(lse), _np(lse_ref), rtol=0, atol=1e-4)
    return (qp, kp, vp, out, lse, dop), dict(scale=scale, sk_valid=Sk)


def _check_bwd_against_plain(B, Sq, Sk, H, KV, hd, dtype, seed):
    tdt = DTYPES[dtype]
    args, kw = _bwd_padded(B, Sq, Sk, H, KV, hd, tdt, seed)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(*args, **kw)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    want = flash_attention_bwd_ref(*args, **kw)
    for g, w in zip(got, want):
        assert g.dtype == tdt and g.shape == w.shape
        top = float(w.float().abs().max())
        if dtype == "float32":
            atol, rtol = BWD_F32_TOL
            np.testing.assert_allclose(_np(g), _np(w), rtol=rtol,
                                       atol=atol * top)
        else:
            np.testing.assert_allclose(_np(g), _np(w), rtol=0,
                                       atol=BWD_BF16_TOL * top)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd", BWD_SHAPES)
def test_cuda_attention_bwd_matches_plain_on_card(B, Sq, Sk, H, KV, hd, dtype):
    _card()
    _check_bwd_against_plain(B, Sq, Sk, H, KV, hd, dtype, 12)


# The edges of K3-bwd's designs: one q tile against four k tiles (the
# dK/dV CTAs of keys 64 and on see no query); g = 5, and the train path's
# heads (H 15, KV 5), at S 1024; hd 8, padded to the mma's k of 16 in S^T,
# dP^T, S and dP but n = 8 in dK, dV and dQ; hd 160, whose bf16 dK/dV warps
# take the q tile in two halves and whose f32 kernels run 256 threads and
# one ring stage, also with g = 1 and a padded S.
BWD_EDGE_SHAPES = [
    (1, 64, 256, 4, 2, 64),
    (1, 1024, 1024, 10, 2, 64),
    (1, 1024, 1024, 15, 5, 64),
    (2, 192, 192, 6, 2, 8),
    (1, 100, 100, 3, 3, 8),
    (1, 256, 256, 8, 2, 160),
    (2, 130, 130, 2, 2, 160),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd", BWD_EDGE_SHAPES)
def test_cuda_attention_bwd_design_edges(B, Sq, Sk, H, KV, hd, dtype):
    _card()
    _check_bwd_against_plain(B, Sq, Sk, H, KV, hd, dtype, 15)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KV,hd", [(2, 256, 15, 5, 64),
                                         (1, 256, 8, 2, 160)])
def test_cuda_attention_bwd_is_deterministic(B, S, H, KV, hd, dtype):
    # No atomics: each sum runs in one fixed order, so a second call gives
    # the same bits (what keeps train_resume's replay bit-equal).
    _card()
    args, kw = _bwd_padded(B, S, S, H, KV, hd, DTYPES[dtype], 16)
    first = flash_attention_bwd(*args, **kw)
    second = flash_attention_bwd(*args, **kw)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_cuda_attention_bwd_smem_bytes_is_the_librarys(hd, dtype):
    # The wrapper's restatement of each K3-bwd design's layout, which the
    # CPU tests read, is what the built library launches a CTA with.
    _card()
    for dq in (False, True):
        assert (bwd_smem_bytes(hd, dq, DTYPES[dtype])
                == built_bwd_smem_bytes(hd, dq, DTYPES[dtype]))


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd", [(2, 256, 256, 15, 5, 64),
                                             (1, 100, 100, 3, 1, 20),
                                             (2, 150, 70, 4, 2, 160)])
def test_cuda_attention_grad_matches_autograd_of_plain(B, Sq, Sk, H, KV, hd):
    # f32 through the public wrapper: pad, FlashAttentionFn, slice, and the
    # pad's backward, against autograd of the plain version.
    _card()
    q, k, v, do = _bwd_inputs(B, Sq, Sk, H, KV, hd, torch.float32, 13)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fwd, bwd = flash_attention.launches, flash_attention_bwd.launches
    out = flash_attention(*leaves)
    got = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert flash_attention.launches == fwd + 1
    assert flash_attention_bwd.launches == bwd + 1
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(flash_attention_ref(*plain), plain, do)
    np.testing.assert_allclose(_np(out), _np(flash_attention_ref(q, k, v)),
                               rtol=1e-4, atol=1e-4)
    for g, w in zip(got, want):
        top = float(w.abs().max())
        np.testing.assert_allclose(_np(g), _np(w), rtol=BWD_F32_TOL[1],
                                   atol=BWD_F32_TOL[0] * top)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KV,hd", [(2, 192, 15, 5, 64),
                                         (1, 128, 8, 2, 160),
                                         (2, 64, 3, 1, 32)])
def test_cuda_attention_lse_store_leaves_output_bit_equal(B, S, H, KV, hd,
                                                          dtype):
    _card()
    q, k, v, _ = _bwd_inputs(B, S, S, H, KV, hd, DTYPES[dtype], 14)
    plain, none = _launch_forward(q, k, v, hd ** -0.5, S)
    with_lse, lse = _launch_forward(q, k, v, hd ** -0.5, S, with_lse=True)
    assert none is None and torch.isfinite(lse).all()
    assert torch.equal(plain, with_lse)


# ------------------------------------------------ the LM stack's block kinds


def _moe_inputs(arch, T, dtype, overflow):
    """A smoke config's MoE weights (f32 draws on the CPU) and x (1, T, D);
    with `overflow` half of the tokens are one repeated row, so one expert
    takes more than its capacity and its kept tokens follow the tie
    order."""
    import dataclasses

    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import moe as MOE

    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype=dtype)
    g = torch.Generator().manual_seed(0)
    p = MOE.init_moe(g, cfg)
    x = torch.randn((1, T, cfg.d_model), generator=g)
    if overflow:
        x[:, : T // 2] = x[0, 0]
    return cfg, p, x


@pytest.mark.cuda
def test_cuda_moe_gathered_path_matches_cpu_with_overflow():
    """llama4's smoke width (E 8, top-1) at T 640 > 512 in f32: the card's
    gathered output equals the CPU's, with an expert over capacity."""
    from repro_torch.models import moe as MOE

    _card()
    cfg, p, x = _moe_inputs("llama4-maverick-400b-a17b", 640, "float32",
                            overflow=True)
    MOE.STATS.reset()
    cpu = MOE.moe_block(p, cfg, x)
    card = MOE.moe_block({k: v.cuda() for k, v in p.items()}, cfg, x.cuda())
    stats = MOE.STATS.read()
    assert stats["gathered"] == 2 and stats["overflowed_experts"] >= 2
    np.testing.assert_allclose(_np(card), _np(cpu), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [64, 1200])
def test_cuda_moe_is_deterministic_forward_and_backward(T, dtype):
    """Two calls on the card give bit-equal outputs and gradients (weights
    and x), on the masked path (T 64) and the gathered one (T 1200, with an
    expert over capacity): no atomics in either."""
    from repro_torch.models import moe as MOE

    _card()
    cfg, p, x = _moe_inputs("moonshot-v1-16b-a3b", T, "float32",
                            overflow=True)
    tdt = DTYPES[dtype]
    p = {k: v.to("cuda", tdt).requires_grad_() for k, v in p.items()}
    x = x.to("cuda", tdt).requires_grad_()
    runs = []
    for _ in range(2):
        y = MOE.moe_block(p, cfg, x)
        runs.append((y, *torch.autograd.grad(y.float().square().sum(),
                                             [*p.values(), x])))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b",
                                  "llama4-maverick-400b-a17b",
                                  "recurrentgemma-9b", "xlstm-1.3b",
                                  "qwen2-vl-72b", "seamless-m4t-large-v2"])
def test_cuda_model_prefill_and_decode_match_cpu(arch):
    """Each new family at its smoke config in f32: prefill (K3 for the full
    attention on the card) and two decode steps, card against CPU within
    1e-4 of the largest logit."""
    import dataclasses

    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models.model import build_model

    _card()
    cfg = dataclasses.replace(get_smoke_config(arch),
                              compute_dtype="float32",
                              kv_cache_dtype="float32")
    rng = np.random.default_rng(0)
    B, S, D = 2, 64, cfg.d_model
    if cfg.family == "encdec":
        batch = {"src_embeddings": rng.normal(size=(B, 16, D)),
                 "tokens": rng.integers(0, cfg.vocab_size, (B, S))}
    elif cfg.input_mode == "embeddings":
        batch = {"embeddings": rng.normal(size=(B, S, D))}
    else:
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S))}
    steps = [{"embeddings": rng.normal(size=(B, 1, D))}
             if "embeddings" in batch else
             {"tokens": rng.integers(0, cfg.vocab_size, (B, 1))}
             for _ in range(2)]
    logits = {}
    for device in ("cuda", "cpu"):
        model = build_model(cfg, device).init(torch.Generator().manual_seed(0))
        out, cache = model.prefill(batch)
        got = [out]
        for i, step in enumerate(steps):
            out, cache = model.decode_step(cache, step, S - 2 + i)
            got.append(out)
        logits[device] = [_np(t) for t in got]
    for card, cpu in zip(logits["cuda"], logits["cpu"]):
        assert np.abs(card - cpu).max() <= 1e-4 * np.abs(cpu).max()
