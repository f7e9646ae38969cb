"""Block-tiled matrix product (K2): `x (M, K) @ w (K, N)`.

Two implementations of one function:

  * `matmul_ref` (`kernels/ref.py`) -- the plain PyTorch version: the CPU
    path and the reference the kernel is held against;
  * `tiled_matmul` -- the wrapper of the hand-written CUDA kernel
    (`csrc/tiled_matmul.cu`, sm_90a, built at first use).  It launches the
    kernel for CUDA tensors and takes the plain version only for CPU tensors;
    a failed build or launch raises, it never falls back.
    `tiled_matmul.launches` counts kernel launches.

The block shape (bm, bk, bn) plays the part of the paper's software mapping,
as in the reference, but its constraints are Hopper's, not the TPU's
(`vmem_bytes` and the (8, 128) tiling of `repro.kernels.tiled_matmul`), and
they depend on the dtype, since each dtype has its own design
(`block_is_valid`; blocks are first clipped to the dims, as the reference
clips them):

  * bf16 -- warpgroup MMA fed by TMA (`path` "wgmma_tma"):
      - divisibility: bm, bk and bn divide M, K and N;
      - alignment: bm a multiple of 64 (one wgmma m64 band per consumer
        warpgroup), bn a multiple of 64 (one 128-byte swizzle row of w's
        columns per TMA box), bk a multiple of 64 (one 128-byte swizzle row
        of x's k); the kernel is compiled for bm in {64, 128} and bn in
        {64, 128, 256};
      - smem_capacity: the ring, STAGES * (bm*bk + bk*bn) * 2 bytes, its
        barriers and 1 KB of alignment slack fit the 227 KB a block may
        claim on H100.
    TMA also needs 16-byte row strides and bases: K and N multiples of 8 and
    16-byte-aligned operands, or the wrapper raises.
  * f32 -- true FP32 on the CUDA cores, register-tiled, 8 x 8 outputs a
    thread (`path` "simt_8x8"):
      - divisibility, as above;
      - alignment: bm and bn in {64, 128} and bk in {8, 16, 32}, the blocks
        the kernel is compiled for (bm * bn / 64 threads);
      - smem_capacity: two stages of x and w tiles, 2 * (bm + bn) * bk * 4
        bytes, within 227 KB (at most 64 KB in the compiled set).
    Its 16-byte loads need K and N multiples of 4 and 16-byte-aligned
    operands, or the wrapper raises.

So K = 960, which the TPU rule `bk % 128` rejects, is fine here.  Left to the
wrapper (`default_blocks`), bf16 takes (bm, bk, bn) = (128, 64, bn) with
bn the largest of 256, 128 and 64 that divides N (256 for the MLP's 5120,
64 for 960 and for the 320 of the wk/wv projections); f32 takes
(128, 16, 128), and (64, 16, 64) where 128 does not divide N (the 960 and
320 of the serve projections), bm 64 where 128 does not divide M.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.ref import matmul_ref

SMEM_LIMIT = 232_448          # bytes of shared memory per block, H100 opt-in
# f32, CUDA cores: the blocks the kernel is compiled for, two stages
SIMT_BM = (64, 128)
SIMT_BN = (64, 128)
SIMT_BK = (8, 16, 32)
SIMT_STAGES = 2
# bf16, wgmma + TMA: bm is 64 rows (one wgmma) per consumer warpgroup, bn
# whole 64-column TMA boxes
SWIZZLE_ROW = 64              # bf16 values in one 128-byte swizzle row
WGMMA_BM = (64, 128)          # the bm and bn the kernel is compiled for
WGMMA_BN = (64, 128, 256)
STAGES = 4                    # TMA ring depth (kStages in the source)
DEFAULT_BLOCKS = {torch.bfloat16: (128, 64, 64),   # (bm, bk, bn)
                  torch.float32: (128, 16, 128)}
PATHS = {torch.bfloat16: "wgmma_tma", torch.float32: "simt_8x8"}

_ENTRY = {torch.float32: "tiled_matmul_f32", torch.bfloat16: "tiled_matmul_bf16"}


def smem_bytes(bm: int, bk: int, bn: int, dtype=torch.bfloat16) -> int:
    """Dynamic shared memory the kernel claims for one block.  bf16: the
    STAGES-deep ring of x and w tiles, its 2 * STAGES mbarriers and 1 KB of
    slack to align the ring to the 1024-byte swizzle atom
    (`wgmma_smem_bytes` in the source); f32: two stages of x and w tiles
    (`sgemm_smem_bytes`)."""
    if dtype == torch.bfloat16:
        return STAGES * (bm * bk + bk * bn) * 2 + 2 * STAGES * 8 + 1024
    return SIMT_STAGES * (bm + bn) * bk * 4


def block_is_valid(m: int, k: int, n: int, bm: int, bk: int, bn: int,
                   dtype=torch.bfloat16) -> tuple[bool, str]:
    """Input constraints of the block-shape space on Hopper, for the design
    that runs `dtype` (see the module's docstring)."""
    if m % bm or k % bk or n % bn:
        return False, "divisibility"
    if dtype == torch.bfloat16:
        if bm not in WGMMA_BM or bn not in WGMMA_BN or bk % SWIZZLE_ROW:
            return False, "alignment"
    elif bm not in SIMT_BM or bn not in SIMT_BN or bk not in SIMT_BK:
        return False, "alignment"
    if smem_bytes(bm, bk, bn, dtype) > SMEM_LIMIT:
        return False, "smem_capacity"
    return True, "ok"


def default_blocks(n: int, dtype, m: int | None = None) -> tuple[int, int, int]:
    """The wrapper's blocks when the caller names none: bf16 widens bn to
    the largest of 256 and 128 that divides N; f32 narrows bn to 64 where
    128 does not divide N, and bm to 64 there too (more CTAs; faster at
    N 320 and 960) and where 128 does not divide M."""
    bm, bk, bn = DEFAULT_BLOCKS[dtype]
    if dtype == torch.bfloat16:
        bn = next((w for w in (256, 128) if n % w == 0), bn)
    elif n % bn:
        bm = bn = 64
    elif m is not None and m % bm:
        bm = 64
    return bm, bk, bn


def _check(x, w, bm, bk, bn) -> tuple[int, int, int, int, int, int]:
    for name, t in (("x", x), ("w", w)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"tiled_matmul: {name} must be a torch.Tensor")
        if t.dim() != 2:
            raise ValueError(f"tiled_matmul: {name} must be 2-d, got shape "
                             f"{tuple(t.shape)}")
    if w.device != x.device:
        raise ValueError(f"tiled_matmul: w is on {w.device}, x on {x.device}")
    if w.dtype != x.dtype:
        raise ValueError(f"tiled_matmul: w is {w.dtype}, x {x.dtype}")
    if x.dtype not in _ENTRY:
        raise ValueError(f"tiled_matmul: dtype must be float32 or bfloat16, "
                         f"got {x.dtype}")
    m, k = x.shape
    k2, n = w.shape
    if k != k2:
        raise ValueError(f"tiled_matmul: inner dims differ: {tuple(x.shape)} "
                         f"@ {tuple(w.shape)}")
    if x.dtype == torch.bfloat16 and (k % 8 or n % 8):
        raise ValueError(f"tiled_matmul: bf16 takes K and N that are multiples "
                         f"of 8 (TMA needs 16-byte row strides), got K {k}, "
                         f"N {n}")
    if x.dtype == torch.float32 and (k % 4 or n % 4):
        raise ValueError(f"tiled_matmul: f32 takes K and N that are multiples "
                         f"of 4 (16-byte loads), got K {k}, N {n}")
    if (bm, bk, bn) == (None, None, None):
        bm, bk, bn = default_blocks(n, x.dtype, m)
    elif None in (bm, bk, bn):
        raise ValueError("tiled_matmul: give all of bm, bk and bn, or none")
    bm, bk, bn = min(bm, m), min(bk, k), min(bn, n)
    ok, why = block_is_valid(m, k, n, bm, bk, bn, dtype=x.dtype)
    if not ok:
        raise ValueError(f"tiled_matmul: block ({bm}, {bk}, {bn}) is invalid "
                         f"for ({m}, {k}) @ ({k}, {n}): {why}")
    return m, k, n, bm, bk, bn


def _kernel_lib():
    from repro_torch.kernels import build

    lib = build.load("tiled_matmul")
    for entry in _ENTRY.values():
        fn = getattr(lib, entry)
        if fn.argtypes is None:
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                           + [ctypes.c_void_p])
    return lib


def tiled_matmul(x, w, bm: int | None = None, bk: int | None = None,
                 bn: int | None = None):
    """`x @ w` through the CUDA kernel for CUDA tensors (the plain version
    for CPU tensors), f32 accumulation, output in x's dtype.  Blocks default
    to `default_blocks`."""
    m, k, n, bm, bk, bn = _check(x, w, bm, bk, bn)
    if x.device.type == "cpu":
        return matmul_ref(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"tiled_matmul: unsupported device {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("tiled_matmul: x and w must be contiguous")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("tiled_matmul: operands must start on a 16-byte "
                         "boundary (TMA, 16-byte loads)")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    fn = getattr(_kernel_lib(), _ENTRY[x.dtype])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k, bm, bn,
                bk, stream)
    if rc != 0:
        raise RuntimeError(f"tiled_matmul: CUDA kernel launch failed "
                           f"(cudaError {rc})")
    tiled_matmul.launches += 1
    return out


tiled_matmul.launches = 0
