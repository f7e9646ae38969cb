"""Kernels K2 (`tiled_matmul`) and K3 (`flash_attention`) of the PyTorch port
against the JAX reference (`repro.kernels`).

Inputs are made with a NumPy seed and handed to both packages.  The
reference runs its Pallas kernels in interpret mode, in this process, as
`tests/test_kernels.py` runs them; on the CPU the port's wrappers take their
plain versions.  Bars are the reference sweep's own: matmul f32 1e-4, bf16
2e-1 relative with atol tol * sqrt(K) (bf16 keeps 8 bits, and the two sides
round the output and sum in different orders); attention f32 1e-4, bf16 5e-2
(the Pallas kernel rounds p to bf16 before the PV product, the plain version
does not).  The CUDA kernels themselves are held against the plain versions
by the card-only tests of `tests/test_torch_lm_card.py` (and by
chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as ref_flash
from repro.kernels import ref as ref_oracles
from repro.kernels import tiled_matmul as ref_matmul
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (HEAD_DIMS, PATHS,
                                                 PATHS_BWD, bwd_smem_bytes,
                                                 flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_fwd,
                                                 pad_operands, padded_shape)
from repro_torch.kernels.flash_attention import smem_bytes as attn_smem_bytes
from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                     flash_attention_ref,
                                     flash_attention_rounded_ref, matmul_ref)
from repro_torch.kernels.tiled_matmul import (SMEM_LIMIT, block_is_valid,
                                              default_blocks, smem_bytes,
                                              tiled_matmul)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
MATMUL_TOL = {"float32": 1e-4, "bfloat16": 2e-1}
ATTN_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
MATMUL_SWEEP = [
    (128, 256, 128, 32, 64, 64),
    (256, 128, 384, 64, 128, 128),
    (64, 512, 256, 8, 256, 128),
    (128, 128, 128, 128, 128, 128),   # single block
]
# The port's bf16 blocks for the sweep's shapes: its wgmma/TMA design takes
# bm, bk, bn multiples of 64 (bm, bn in {64, 128}) whose 4-stage ring fits
# 227 KB, so the reference's TPU blocks above are not all valid there.
PORT_BF16_BLOCKS = {
    (128, 256, 128): (64, 64, 64),
    (256, 128, 384): (64, 128, 128),
    (64, 512, 256): (64, 128, 128),
    (128, 128, 128): (128, 64, 128),  # single output block
}
# The port's f32 blocks for the sweep's shapes: its register-tiled design
# takes bm, bn in {64, 128} and bk in {8, 16, 32}, so the reference's TPU
# blocks (bm 8 or 32, bk up to 256) are not all valid there either.
PORT_F32_BLOCKS = {
    (128, 256, 128): (64, 32, 64),
    (256, 128, 384): (64, 16, 128),
    (64, 512, 256): (64, 8, 128),
    (128, 128, 128): (128, 32, 128),  # single output block
}
ATTN_SWEEP = [
    (2, 64, 4, 2, 16, 16, 16),
    (1, 128, 8, 2, 32, 32, 64),
    (2, 64, 4, 4, 8, 64, 32),      # MHA (g=1)
    (1, 128, 4, 1, 64, 128, 128),  # MQA, single block pair
]
# The serve projections of smollm-360m: M = 8 requests x 1088 positions,
# (K, N) of wq/wo, wk/wv, the MLP's up and down projections.
SMOLLM_M = 8 * 1088
SMOLLM_KN = [(960, 960), (960, 320), (960, 5120), (2560, 960)]


def _pair(a: np.ndarray, dtype: str):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n,bm,bk,bn", MATMUL_SWEEP)
def test_matmul_plain_matches_reference_kernel(m, k, n, bm, bk, bn, dtype):
    rng = np.random.default_rng(m + k + n)
    (xj, xt), (wj, wt) = (_pair(rng.normal(size=s).astype(np.float32), dtype)
                          for s in ((m, k), (k, n)))
    want = ref_matmul.tiled_matmul(xj, wj, bm=bm, bk=bk, bn=bn, interpret=True)
    port_blocks = PORT_BF16_BLOCKS if dtype == "bfloat16" else PORT_F32_BLOCKS
    bm, bk, bn = port_blocks[m, k, n]
    assert block_is_valid(m, k, n, bm, bk, bn, dtype=DTYPES[dtype][1])[0]
    got = tiled_matmul(xt, wt, bm=bm, bk=bk, bn=bn)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (m, n)
    tol = MATMUL_TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol,
                               atol=tol * k ** 0.5)
    np.testing.assert_allclose(_np(matmul_ref(xt, wt)),
                               _np(ref_oracles.matmul_ref(xj, wj)),
                               rtol=tol, atol=tol * k ** 0.5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KV,hd,bq,bk", ATTN_SWEEP)
def test_attention_plain_matches_reference_kernel(B, S, H, KV, hd, bq, bk,
                                                  dtype):
    rng = np.random.default_rng(B * S + H * hd)
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(rng.normal(size=s).astype(np.float32), dtype)
        for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
    want = ref_flash.flash_attention(qj, kj, vj, bq=bq, bk=bk, interpret=True)
    got = flash_attention(qt, kt, vt)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (B, S, H, hd)
    tol = ATTN_TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    # the plain version with the flash kernels' roundings (p rounded to v's
    # dtype) tracks the Pallas kernel to about one bf16 ulp of the output:
    # bf16 atol 2e-3 plus 1e-2 relative (one ulp is at most 2^-7 relative);
    # chip_smoke.py holds K3's bf16 instance to it at that bar
    np.testing.assert_allclose(
        _np(flash_attention_rounded_ref(qt, kt, vt)), _np(want),
        rtol=1e-5 if dtype == "float32" else 1e-2,
        atol=1e-5 if dtype == "float32" else 2e-3)
    # the plain versions of both packages compute the same materialised
    # softmax in f32; only the final rounding to the input dtype can differ
    np.testing.assert_allclose(
        _np(flash_attention_ref(qt, kt, vt)),
        _np(ref_oracles.flash_attention_ref(qj, kj, vj)),
        rtol=1e-5 if dtype == "float32" else 1e-2,
        atol=1e-5 if dtype == "float32" else 1e-2)


def test_ops_dispatch_cpu_is_the_plain_version_and_launches_nothing():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(64, 128)).astype(np.float32)
    w = rng.normal(size=(128, 128)).astype(np.float32)
    q = torch.from_numpy(rng.normal(size=(1, 64, 4, 16)).astype(np.float32))
    kv = torch.from_numpy(rng.normal(size=(1, 64, 2, 16)).astype(np.float32))
    before = (tiled_matmul.launches, flash_attention.launches)
    got = ops.matmul(x, w, device="cpu")
    assert torch.equal(got, matmul_ref(torch.from_numpy(x), torch.from_numpy(w)))
    att = ops.attention(q, kv, kv)
    assert torch.equal(att, flash_attention_ref(q, kv, kv))
    assert (tiled_matmul.launches, flash_attention.launches) == before


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_f32_attention_design_fits_and_cpu_takes_the_plain_version(hd):
    # The register-tiled f32 design fits one CTA's shared memory at every
    # compiled head dim, and two CTAs fit an SM's 228 KB (with 1 KB reserved
    # each) up to hd 64.  That `smem_bytes` is what the library launches
    # with is checked on the card (test_torch_lm_card.py, chip_smoke.py).
    smem = attn_smem_bytes(hd, torch.float32)
    assert smem <= SMEM_LIMIT == 232448
    assert (2 * (smem + 1024) <= 233472) == (hd <= 64)
    assert PATHS[torch.float32] == "simt_4x8"
    # Without a card, an f32 call (S 192: a half leading q tile on the card)
    # is the plain version and launches nothing.
    rng = np.random.default_rng(hd)
    q = torch.from_numpy(rng.normal(size=(1, 192, 6, hd)).astype(np.float32))
    kv = torch.from_numpy(rng.normal(size=(1, 192, 2, hd)).astype(np.float32))
    before = flash_attention.launches
    assert torch.equal(flash_attention(q, kv, kv), flash_attention_ref(q, kv, kv))
    assert flash_attention.launches == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_bwd_design_fits_and_cpu_takes_the_plain_version(hd, dtype):
    # Each K3-bwd design (`PATHS_BWD`) fits one CTA's shared memory at every
    # compiled head dim, in its dK/dV and its dQ kernel.  The f32 design's
    # CTAs of 128 threads fit two to an SM's 228 KB (with 1 KB reserved
    # each) up to hd 64, as its launch bounds ask; the bf16 design's fit at
    # least three there.  That `bwd_smem_bytes` is what the library
    # launches with is checked on the card (test_torch_lm_card.py,
    # chip_smoke.py).
    tdt = DTYPES[dtype][1]
    assert PATHS_BWD == {torch.bfloat16: "mma_sync", torch.float32: "simt_4x8"}
    for dq in (False, True):
        smem = bwd_smem_bytes(hd, dq, tdt)
        assert smem <= SMEM_LIMIT == 232448
        if dtype == "float32":
            assert (2 * (smem + 1024) <= 233472) == (hd <= 64)
        elif hd <= 64:
            assert 3 * (smem + 1024) <= 233472
    # Without a card, K3-bwd through its public wrapper is the plain version
    # on the same operands, and launches nothing (S 100: padded to 128).
    rng = np.random.default_rng(hd)
    q, do = (torch.from_numpy(rng.normal(size=(1, 100, 4, hd)).astype(
        np.float32)).to(tdt) for _ in range(2))
    k, v = (torch.from_numpy(rng.normal(size=(1, 100, 2, hd)).astype(
        np.float32)).to(tdt) for _ in range(2))
    qp, kp, vp = pad_operands(q, k, v)
    dop = pad_operands(do, k, v)[0]
    out, lse = flash_attention_fwd(qp, kp, vp, scale=hd ** -0.5, sk_valid=100)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(qp, kp, vp, out, lse, dop, scale=hd ** -0.5,
                              sk_valid=100)
    want = flash_attention_bwd_ref(qp, kp, vp, out, lse, dop,
                                   scale=hd ** -0.5, sk_valid=100)
    assert flash_attention_bwd.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# (B, Sq, Sk, H, KV, hd): smollm-360m's smoke head dim 20 and stablelm-12b's
# 160, S 100, Sq < Sk and Sq > Sk (where rows past Sk would see padded keys
# without the true key count).
PADDING_CASES = [(1, 100, 100, 3, 1, 20), (2, 100, 100, 32, 8, 160),
                 (1, 64, 150, 4, 2, 20), (2, 150, 70, 4, 2, 64),
                 (1, 130, 20, 6, 3, 160), (1, 40, 40, 2, 1, 8)]


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd", PADDING_CASES)
def test_padding_rule_is_exact(B, Sq, Sk, H, KV, hd):
    # What the wrapper hands the kernel on the card -- S padded to multiples
    # of 64, hd to a compiled head dim, the true scale and key count --
    # computed by the plain version and sliced, equals the plain version on
    # the original shape.
    rng = np.random.default_rng(Sq * 1000 + Sk + hd)
    q, k, v = (torch.from_numpy(rng.normal(size=s))
               .to(torch.float32)
               for s in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd)))
    Sq_p, Sk_p, hd_p = padded_shape(Sq, Sk, hd)
    assert (Sq_p % 64, Sk_p % 64) == (0, 0) and hd_p in HEAD_DIMS
    assert 0 <= Sq_p - Sq < 64 and 0 <= Sk_p - Sk < 64 and hd <= hd_p
    qp, kp, vp = pad_operands(q, k, v)
    assert qp.shape == (B, Sq_p, H, hd_p) and kp.shape == (B, Sk_p, KV, hd_p)
    got = flash_attention_ref(qp, kp, vp, scale=hd ** -0.5,
                              sk_valid=Sk)[:, :Sq, :, :hd]
    want = flash_attention_ref(q, k, v)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)
    if Sq > Sk:  # the key bound is what makes it exact past Sk
        wrong = flash_attention_ref(qp, kp, vp, scale=hd ** -0.5)
        assert not torch.allclose(wrong[:, Sk:Sq, :, :hd], want[:, Sk:],
                                  atol=1e-3)
    # On the CPU the wrapper itself is the plain version on the original
    # shape and launches nothing.
    before = flash_attention.launches
    assert torch.equal(flash_attention(q, k, v), want)
    assert flash_attention.launches == before


def test_padding_rejects_head_dims_past_the_largest_compiled():
    assert padded_shape(1, 1, 160) == (64, 64, 160)
    assert padded_shape(65, 128, 129) == (128, 128, 160)
    with pytest.raises(ValueError, match="head dim 192"):
        padded_shape(64, 64, 192)


@pytest.mark.parametrize("k,n", SMOLLM_KN)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_block_constraints_on_smollm_projections(k, n, dtype):
    if dtype == torch.bfloat16:
        # wgmma + TMA: the wrapper's default blocks are valid on every serve
        # projection, and (128, 64, 64) on all of them (N = 320 rules out
        # bn = 128) ...
        assert block_is_valid(SMOLLM_M, k, n, *default_blocks(n, dtype),
                              dtype=dtype) == (True, "ok")
        assert block_is_valid(SMOLLM_M, k, n, 128, 64, 64,
                              dtype=dtype) == (True, "ok")
        # ... the ring is 4 stages of x and w tiles, 16 mbarriers and 1 KB of
        # alignment slack ...
        assert smem_bytes(128, 64, 64, dtype) == (
            4 * (128 * 64 + 64 * 64) * 2 + 2 * 4 * 8 + 1024)
        # ... K = 960 takes bk = 192 here, which the TPU rule bk % 128
        # rejects ...
        assert block_is_valid(SMOLLM_M, 960, n, 64, 192, 64, dtype=dtype)[0]
        # ... and each constraint reports its reason
        assert block_is_valid(SMOLLM_M, 960, n, 64, 128, 64,
                              dtype=dtype) == (False, "divisibility")
        assert block_is_valid(SMOLLM_M, k, n, 96, 64, 64,
                              dtype=dtype) == (False, "divisibility")
        assert block_is_valid(SMOLLM_M, k, n, 64, 32, 64,   # bk not 64k
                              dtype=dtype) == (False, "alignment")
        assert block_is_valid(SMOLLM_M, k, n, 32, 64, 64,   # bm not 64k
                              dtype=dtype) == (False, "alignment")
        assert block_is_valid(SMOLLM_M, k, n, 256, 64, 64,  # not compiled
                              dtype=dtype) == (False, "alignment")
        assert smem_bytes(64, k, 64, dtype) > SMEM_LIMIT   # all of K at once
        assert block_is_valid(SMOLLM_M, k, n, 64, k, 64,
                              dtype=dtype) == (False, "smem_capacity")
        return
    # f32, register-tiled on the CUDA cores: its default blocks are valid on
    # every serve projection -- (128, 16, 128) where 128 divides N, else
    # (64, 16, 64) -- and so is (128, 16, 64) ...
    bn = 128 if n % 128 == 0 else 64
    assert default_blocks(n, dtype, SMOLLM_M) == (bn, 16, bn)
    assert block_is_valid(SMOLLM_M, k, n, *default_blocks(n, dtype, SMOLLM_M),
                          dtype=dtype) == (True, "ok")
    ok, why = block_is_valid(SMOLLM_M, k, n, 128, 16, 64, dtype=dtype)
    assert (ok, why) == (True, "ok")
    assert default_blocks(n, dtype, 64) == (64, 16, bn)   # M = 64
    assert smem_bytes(128, 16, 64, dtype) == 2 * (128 + 64) * 16 * 4
    # ... K = 960 takes bk = 32 here, which the TPU rule bk % 128 rejects ...
    assert block_is_valid(SMOLLM_M, 960, n, 64, 32, 64, dtype=dtype)[0]
    # ... and each constraint reports its reason
    assert block_is_valid(SMOLLM_M, 960, n, 64, 128, 64,
                          dtype=dtype) == (False, "divisibility")
    assert block_is_valid(SMOLLM_M, k, n, 96, 32, 64,
                          dtype=dtype) == (False, "divisibility")
    assert block_is_valid(SMOLLM_M, k, n, 8, 32, 8,     # not compiled
                          dtype=dtype) == (False, "alignment")
    assert block_is_valid(SMOLLM_M, k, n, 128, 32, 320,  # bn not compiled
                          dtype=dtype) == (False, "alignment")
    # the compiled set stays far inside shared memory: 64 KB at most
    assert smem_bytes(128, 32, 128, dtype) == 65536 <= SMEM_LIMIT
    assert block_is_valid(SMOLLM_M, k, n, 64, k, 64,     # all of K at once
                          dtype=dtype) == (False, "alignment")


@pytest.mark.parametrize("bad", ["blocks", "dtype", "inner", "type",
                                 "bf16_blocks", "bf16_k", "bf16_n",
                                 "f32_blocks", "f32_k", "f32_n"])
def test_matmul_wrapper_rejects_bad_operands(bad):
    x, w = torch.zeros((64, 96)), torch.zeros((96, 64))
    if bad == "blocks":
        args = (x, w, 64, 64, 64)      # bk 64 does not divide K 96
    elif bad == "dtype":
        args = (x.double(), w.double())
    elif bad == "inner":
        args = (x, w[:64])
    elif bad == "bf16_blocks":         # f32-valid, but bk 32 is not a
        args = (torch.zeros((64, 128), dtype=torch.bfloat16),  # swizzle row
                torch.zeros((128, 64), dtype=torch.bfloat16), 64, 32, 64)
    elif bad == "bf16_k":              # K 100: TMA needs 16-byte rows
        args = (torch.zeros((64, 100), dtype=torch.bfloat16),
                torch.zeros((100, 64), dtype=torch.bfloat16))
    elif bad == "bf16_n":              # N 100
        args = (torch.zeros((64, 64), dtype=torch.bfloat16),
                torch.zeros((64, 100), dtype=torch.bfloat16))
    elif bad == "f32_blocks":          # divides, but bm 32 is not compiled
        args = (torch.zeros((64, 96)), torch.zeros((96, 64)), 32, 32, 64)
    elif bad == "f32_k":               # K 102: 16-byte loads need K % 4
        args = (torch.zeros((64, 102)), torch.zeros((102, 64)))
    elif bad == "f32_n":               # N 66
        args = (torch.zeros((64, 64)), torch.zeros((64, 66)))
    else:
        args = (x.numpy(), w)
    with pytest.raises((ValueError, TypeError), match=None if bad in (
            "dtype", "inner", "type") else "block|multiples of [48]"):
        tiled_matmul(*args)
@pytest.mark.parametrize("bad", ["heads", "dtype", "shape"])
def test_attention_wrapper_rejects_bad_operands(bad):
    q, kv = torch.zeros((1, 64, 6, 16)), torch.zeros((1, 64, 4, 16))
    if bad == "dtype":
        q, kv = q.half(), kv.half()
    elif bad == "shape":
        kv = torch.zeros((1, 64, 2, 8))
    with pytest.raises(ValueError):
        flash_attention(q, kv, kv)


# ptxas's report as `nvcc -Xptxas -v` writes it: two instances of one
# template and a function whose name ends in the first's.
PTXAS_REPORT = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117flash_simt_kernelILi64EEEvPKfS2_S2_Pfiiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_117flash_simt_kernelILi64EEEvPKfS2_S2_Pfiiiif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, 384 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117flash_simt_kernelILi8EEEvPKfS2_S2_Pfiiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_117flash_simt_kernelILi8EEEvPKfS2_S2_Pfiiiif
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 40 registers, 16 bytes smem, 384 bytes cmem[0]
ptxas info    : Compiling entry function '_Z18xflash_simt_kernelILi64EEvPKf' for 'sm_90a'
ptxas info    : Used 20 registers, 384 bytes cmem[0]
"""
DEMANGLED = {
    "_ZN12_GLOBAL__N_117flash_simt_kernelILi64EEEvPKfS2_S2_Pfiiiif":
        "void (anonymous namespace)::flash_simt_kernel<(int)64>(const float *)",
    "_ZN12_GLOBAL__N_117flash_simt_kernelILi8EEEvPKfS2_S2_Pfiiiif":
        "void (anonymous namespace)::flash_simt_kernel<(int)8>(const float *)",
    "_Z18xflash_simt_kernelILi64EEvPKf": "void xflash_simt_kernel<64>(const float *)",
}


@pytest.mark.parametrize("cufilt", [False, True])
def test_ptxas_function_finds_one_template_instance(cufilt, tmp_path,
                                                    monkeypatch):
    # With cu++filt the report's names are demangled, without it they stay
    # mangled; either way a function is found by its name and template
    # arguments, and exactly one must match.
    from repro_torch.kernels import build

    report = tmp_path / "report.txt"
    report.write_text(PTXAS_REPORT)
    monkeypatch.setattr(build, "report_path", lambda name: report)
    monkeypatch.setattr(build, "_demangle", (
        lambda names: {n: DEMANGLED[n] for n in names}) if cufilt else (
        lambda names: {n: n for n in names}))
    assert build.ptxas_function("flash_attention", "flash_simt_kernel", 64) == {
        "stack_bytes": 0, "spill_store_bytes": 0, "spill_load_bytes": 0,
        "registers": 128, "static_smem_bytes": 0}
    got = build.ptxas_function("flash_attention", "flash_simt_kernel", 8)
    assert (got["registers"], got["spill_store_bytes"],
            got["spill_load_bytes"], got["static_smem_bytes"]) == (40, 4, 12, 16)
    assert build.ptxas_function("flash_attention", "xflash_simt_kernel",
                                64)["registers"] == 20
    with pytest.raises(LookupError, match="0 functions"):
        build.ptxas_function("flash_attention", "flash_simt_kernel", 128)


BWD_REPORT = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121flash_bwd_dkdv_kernelIfLi64EEEvPKT_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_121flash_bwd_dkdv_kernelIfLi64EEEvPKT_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 127 registers, 384 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121flash_bwd_dkdv_kernelI13__nv_bfloat16Li64EEEvPKT_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_121flash_bwd_dkdv_kernelI13__nv_bfloat16Li64EEEvPKT_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 126 registers, 384 bytes cmem[0]
"""
BWD_DEMANGLED = {
    "_ZN12_GLOBAL__N_121flash_bwd_dkdv_kernelIfLi64EEEvPKT_":
        "void <unnamed>::flash_bwd_dkdv_kernel<float, (int)64>(const T1 *)",
    "_ZN12_GLOBAL__N_121flash_bwd_dkdv_kernelI13__nv_bfloat16Li64EEEvPKT_":
        "void <unnamed>::flash_bwd_dkdv_kernel<__nv_bfloat16, (int)64>"
        "(const T1 *)",
}


@pytest.mark.parametrize("cufilt", [False, True])
def test_ptxas_function_takes_type_arguments(cufilt, tmp_path, monkeypatch):
    # K3-bwd's kernels are templated on the I/O type and hd; a type argument
    # is spelled by name demangled and by its mangled code ("f", length-prefixed
    # names) mangled.
    from repro_torch.kernels import build

    report = tmp_path / "report.txt"
    report.write_text(BWD_REPORT)
    monkeypatch.setattr(build, "report_path", lambda name: report)
    monkeypatch.setattr(build, "_demangle", (
        lambda names: {n: BWD_DEMANGLED[n] for n in names}) if cufilt else (
        lambda names: {n: n for n in names}))
    assert build.ptxas_function("flash_attention_bwd", "flash_bwd_dkdv_kernel",
                                "float", 64)["registers"] == 127
    assert build.ptxas_function("flash_attention_bwd", "flash_bwd_dkdv_kernel",
                                "__nv_bfloat16", 64)["registers"] == 126
    with pytest.raises(LookupError, match="0 functions"):
        build.ptxas_function("flash_attention_bwd", "flash_bwd_dkdv_kernel",
                             "float", 128)


def test_ab_variant_sets_the_named_knobs_of_the_committed_source():
    # `python -m repro_torch.kernels.ab` builds K3-bwd variants from the
    # committed source by setting its `static constexpr` knobs; a knob that
    # is missing, or defined in more than one place, raises.
    from repro_torch.kernels import ab, build

    src = (build.CSRC / ab.SOURCE).read_text()
    out = ab.with_knobs(src, {"DKDV_MIN_CTAS": "1", "KC": "kTile"})
    assert "static constexpr int DKDV_MIN_CTAS = 1;" in out
    assert "static constexpr int KC = kTile;" in out
    changed = [(a, b) for a, b in zip(src.splitlines(), out.splitlines())
               if a != b]
    assert len(changed) == 2 and len(out.splitlines()) == len(src.splitlines())
    for knob in ("NO_SUCH_KNOB", "DKDV_BYTES"):
        with pytest.raises(KeyError, match=knob):
            ab.with_knobs(src, {knob: "1"})
    assert ab.parse_variant("x=QC=32,KC=32")[1] == ab.with_knobs(
        src, {"QC": "32", "KC": "32"})
