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
(`vmem_bytes` and the (8, 128) tiling of `repro.kernels.tiled_matmul`):

  * divisibility -- bm, bk and bn divide M, K and N (blocks are first clipped
    to the dims, as the reference clips them);
  * alignment -- every thread computes a 4 x 4 block of outputs, so bm and bn
    are multiples of 4 and the CTA's bm * bn / 16 threads are a whole number
    of warps, at most 1,024;
  * smem_capacity -- the staged x and w tiles, (bm*bk + bk*bn) * itemsize,
    fit the 227 KB of shared memory a block may claim on H100 (the f32
    accumulator lives in registers, not in shared memory).

So K = 960, which the TPU rule `bk % 128` rejects, is fine here (bk = 32).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.ref import matmul_ref

SMEM_LIMIT = 232_448          # bytes of shared memory per block, H100 opt-in
MAX_THREADS = 1024
THREAD_TILE = 4               # outputs per thread along each of m and n
DEFAULT_BLOCKS = (64, 32, 64)  # (bm, bk, bn)

_ENTRY = {torch.float32: "tiled_matmul_f32", torch.bfloat16: "tiled_matmul_bf16"}


def smem_bytes(bm: int, bk: int, bn: int, dtype=torch.bfloat16) -> int:
    """Shared memory the kernel claims for one block: the x and w tiles in
    the input dtype."""
    return (bm * bk + bk * bn) * torch.empty((), dtype=dtype).element_size()


def block_is_valid(m: int, k: int, n: int, bm: int, bk: int, bn: int,
                   dtype=torch.bfloat16) -> tuple[bool, str]:
    """Input constraints of the block-shape space on Hopper."""
    if m % bm or k % bk or n % bn:
        return False, "divisibility"
    threads = (bm // THREAD_TILE) * (bn // THREAD_TILE)
    if (bm % THREAD_TILE or bn % THREAD_TILE or threads % 32
            or threads > MAX_THREADS):
        return False, "alignment"
    if smem_bytes(bm, bk, bn, dtype) > SMEM_LIMIT:
        return False, "smem_capacity"
    return True, "ok"


def _check(x, w, bm: int, bk: int, bn: int) -> tuple[int, int, int, int,
                                                        int, int]:
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


def tiled_matmul(x, w, bm: int = DEFAULT_BLOCKS[0], bk: int = DEFAULT_BLOCKS[1],
                 bn: int = DEFAULT_BLOCKS[2]):
    """`x @ w` through the CUDA kernel for CUDA tensors (the plain version
    for CPU tensors), f32 accumulation, output in x's dtype."""
    m, k, n, bm, bk, bn = _check(x, w, bm, bk, bn)
    if x.device.type == "cpu":
        return matmul_ref(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"tiled_matmul: unsupported device {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("tiled_matmul: x and w must be contiguous")
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
