"""Causal GQA flash attention (K3) and its backward (K3-bwd).

Two implementations of one function:

  * `flash_attention_ref` (`kernels/ref.py`) -- the plain PyTorch version,
    materialised f32 scores: the CPU path and the reference the kernel is
    held against;
  * `flash_attention` -- the wrapper of the hand-written CUDA kernels
    (`csrc/flash_attention.cu`, sm_90a, built at first use), an online
    softmax over k tiles of 64 keys: bf16 on the tensor cores, one CTA per
    (64-row q tile, query head, batch) (`mma.sync` m16n8k16 with cp.async
    double-buffering, `path` "mma_sync"); f32 on the CUDA cores in true
    FP32, one CTA of 256 threads per (128-row q tile, query head, batch),
    each thread holding 4 rows x 8 keys of the scores and the same 4 rows
    of the output, operands transposed in shared memory for 16-byte reads
    (`path` "simt_4x8").  It launches the kernel for CUDA tensors and takes
    the plain version only for CPU tensors; a failed build or launch
    raises, it never falls back.  `flash_attention.launches` counts kernel
    launches.

q (B, Sq, H, hd); k, v (B, Sk, KV, hd); H = g * KV, query head h reads KV
head h // g.  Float32 or bfloat16; the output has q's dtype.

On the card the wrapper takes every Sq, Sk >= 1 and hd up to 160, as the
reference's attention does.  The kernels run multiples of 64 and the
compiled head dims `HEAD_DIMS`; the wrapper pads the rest with zeros
(`pad_operands`) and slices the output back:

  * Sq and Sk up to multiples of 64 at the end, with the true key count
    passed to the kernel, which masks keys at or past it.  Causal masking
    alone would hide the padded keys only from queries before Sk; with the
    bound the padding is exact for every Sq and Sk;
  * hd up to the next compiled head dim: zero columns add nothing to q.k,
    and V's zero columns give output columns that are sliced off.  The scale
    stays the caller's hd^-0.5.

A head dim above 160 (in no config) raises ValueError naming the compiled
set, and so do operands that are not contiguous or do not start on a
16-byte boundary.  `bq` and `bk` keep their place in the signature only:
clipped to the padded Sq and Sk as in the reference, they must be (64, 64)
and select nothing (the f32 kernel runs 128-row q tiles all the same).  The config's `flash_block_q/k = 1024` is a TPU VMEM tile size
and does not carry over: the LM calls this with the kernel's own tiles.

Training.  When autograd records the call (grad enabled and an operand that
requires grad), `flash_attention` pads with the same autograd-tracked
`pad_operands` and runs the registered op `repro_torch::flash_attention_fwd`
on the padded operands, whose backward is `repro_torch::flash_attention_bwd`
(the ops are below, with their fake implementations and FLOP formulas): on CUDA
tensors its forward launches K3 with the `lse` output and its backward
launches K3-bwd (`csrc/flash_attention_bwd.cu`: D, then dK/dV, then dQ;
`flash_attention_bwd.launches` counts one a backward); on CPU tensors both
run the plain versions (`flash_attention_lse_ref`, `flash_attention_bwd_ref`)
through the same padding.  The pad's own backward slices the padding off
the gradients: padded query rows get dO = 0 (so D = 0 and dS = 0), padded
keys are masked, padded hd columns are zero in q and k.  Under `no_grad`
(serving) nothing changes: one launch of the kernels without `lse`, or the
plain version on the CPU.

K3-bwd has one design a dtype (`PATHS_BWD`): bf16 on the tensor cores
(`mma.sync` m16n8k16, one warp per 16 keys of the dK/dV CTA or 16 rows of
the dQ CTA, P and dS kept in registers as the A fragments of the next
products, Q/dO or K/V tiles through a cp.async ring; path "mma_sync"); f32
on the CUDA cores in true FP32, register-tiled (4 x 8 scores a thread,
operands transposed in shared memory for 16-byte reads, P and dS crossing
threads through shared memory; path "simt_4x8").  Both are deterministic:
no atomics, every sum in one fixed order.
"""

from __future__ import annotations

import ctypes

import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                     flash_attention_lse_ref,
                                     flash_attention_ref)

TILE = 64
HEAD_DIMS = (8, 16, 32, 64, 128, 160)
PATHS = {torch.bfloat16: "mma_sync", torch.float32: "simt_4x8"}
PATHS_BWD = {torch.bfloat16: "mma_sync", torch.float32: "simt_4x8"}
F32_ROWS = 128  # q rows of one f32 CTA
BWD_STAGES = 2  # tiles in K3-bwd's cp.async rings (f32 hd 160: one)

_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}
_BWD_ENTRY = {torch.float32: "flash_attention_bwd_f32",
              torch.bfloat16: "flash_attention_bwd_bf16"}


def _check(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"flash_attention: {name} must be a torch.Tensor")
        if t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be 4-d, got shape "
                             f"{tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, "
                             f"q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {t.dtype}, "
                             f"q {q.dtype}")
    if q.dtype not in _ENTRY:
        raise ValueError(f"flash_attention: dtype must be float32 or "
                         f"bfloat16, got {q.dtype}")
    B, _, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)} and v {tuple(v.shape)} do not fit "
                         "(B,Sq,H,hd), (B,Sk,KV,hd), (B,Sk,KV,hd)")
    if H % k.shape[2]:
        raise ValueError(f"flash_attention: {H} query heads are not a "
                         f"multiple of {k.shape[2]} KV heads")


def smem_bytes(hd: int, dtype=torch.bfloat16) -> int:
    """Dynamic shared memory of one CTA: bf16 holds Q and a double-buffered
    ring of K and V tiles, rows padded by 16 bytes (Q and K rows padded to 16
    values for hd 8; `MmaTile` in the source); f32 holds Q^T [hd][128], K^T
    [hd][64], two stages of V [64][hd] (one above hd 128) and P^T
    [64][128 + 4], its rows padded against bank conflicts (`SimtTile`).  The launch takes the size
    from the source's own structs; `built_smem_bytes` reads it there."""
    if dtype == torch.bfloat16:
        qk, vr = max(hd, 16) + 8, hd + 8
        return 2 * TILE * (3 * qk + 2 * vr)
    v_stages = 2 if hd <= 128 else 1
    return 4 * (hd * F32_ROWS + hd * TILE + v_stages * TILE * hd
                + TILE * (F32_ROWS + 4))


def built_smem_bytes(hd: int, dtype=torch.bfloat16) -> int:
    """The dynamic shared memory the built library launches a CTA with
    (`MmaTile` / `SimtTile::BYTES`); builds the library on first use."""
    n = _kernel_lib().flash_attention_smem_bytes(hd,
                                                 int(dtype == torch.bfloat16))
    if n < 0:
        raise ValueError(f"flash_attention: head dim {hd} is not compiled")
    return n


def _kernel_lib():
    from repro_torch.kernels import build

    lib = build.load("flash_attention")
    for entry in _ENTRY.values():
        fn = getattr(lib, entry)
        if fn.argtypes is None:
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                           + [ctypes.c_float, ctypes.c_void_p])
    lib.flash_attention_smem_bytes.restype = ctypes.c_int
    lib.flash_attention_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    return lib


def _bwd_lib():
    from repro_torch.kernels import build

    lib = build.load("flash_attention_bwd")
    for entry in _BWD_ENTRY.values():
        fn = getattr(lib, entry)
        if fn.argtypes is None:
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                           + [ctypes.c_float, ctypes.c_void_p])
    lib.flash_attention_bwd_smem_bytes.restype = ctypes.c_int
    lib.flash_attention_bwd_smem_bytes.argtypes = [ctypes.c_int] * 3
    return lib


def bwd_smem_bytes(hd: int, dq: bool = False, dtype=torch.bfloat16) -> int:
    """Dynamic shared memory of one CTA of K3-bwd's dK/dV kernel (or, with
    `dq`, its dQ kernel).  bf16 (`MmaBwdTile` in the source): [64][hd + 8]
    bf16 tiles (hd 8 padded to 16 columns), K and V plus a ring of two Q and
    dO tiles with their 64 rows' lse and D in f32 (dQ: Q and dO plus a ring
    of two K and V tiles).  f32 (`SimtBwdTile`): [64][hd] f32 tiles, K^T and
    V^T plus a ring of Q and dO tiles with lse and D (dQ: Q^T and dO^T plus
    a ring of K and V), and one [64][64] tile of P and dS (dQ: dS^T); two
    stages up to hd 128, one at hd 160.  The launch takes the size from the
    source's own structs; `built_bwd_smem_bytes` reads it there."""
    if dtype == torch.bfloat16:
        tile = 2 * TILE * (max(hd, 16) + 8)
        rows = 0 if dq else BWD_STAGES * 2 * TILE * 4
        return (2 + 2 * BWD_STAGES) * tile + rows
    stages = BWD_STAGES if hd <= 128 else 1
    tile = 4 * TILE * hd
    rows = 0 if dq else 2 * TILE * 4
    return 2 * tile + stages * (2 * tile + rows) + 4 * TILE * TILE


def built_bwd_smem_bytes(hd: int, dq: bool = False,
                         dtype=torch.bfloat16) -> int:
    """The dynamic shared memory the built K3-bwd library launches a CTA of
    its dK/dV (or, with `dq`, its dQ) kernel with for `dtype`
    (`MmaBwdTile` / `SimtBwdTile::*_BYTES`); builds the library on first
    use."""
    n = _bwd_lib().flash_attention_bwd_smem_bytes(
        hd, int(dq), int(dtype == torch.bfloat16))
    if n < 0:
        raise ValueError(f"flash_attention_bwd: head dim {hd} is not compiled")
    return n


def padded_shape(sq: int, sk: int, hd: int) -> tuple[int, int, int]:
    """(Sq, Sk, hd) as the kernel runs them: the sequences rounded up to
    multiples of 64, hd up to the smallest compiled head dim that holds it.
    Raises ValueError for an hd above the largest."""
    fits = [d for d in HEAD_DIMS if d >= hd]
    if hd < 1 or not fits:
        raise ValueError(f"flash_attention: head dim {hd} is not compiled "
                         f"and pads to none of {HEAD_DIMS}")
    return -(-sq // TILE) * TILE, -(-sk // TILE) * TILE, fits[0]


def pad_operands(q, k, v):
    """q, k and v zero-padded at the end of S and hd to `padded_shape`
    (the tensors themselves where nothing pads)."""
    Sq_p, Sk_p, hd_p = padded_shape(q.shape[1], k.shape[1], q.shape[3])

    def pad(t, s):
        extra = (hd_p - t.shape[3], s - t.shape[1])
        if extra == (0, 0):
            return t
        return torch.nn.functional.pad(t, (0, extra[0], 0, 0, 0, extra[1]))

    return pad(q, Sq_p), pad(k, Sk_p), pad(v, Sk_p)


def _check_launchable(*tensors) -> None:
    for name, t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must start on a "
                             "16-byte boundary (cp.async, 16-byte loads)")


def _launch_forward(qp, kp, vp, scale: float, sk_valid: int,
                    with_lse: bool = False):
    """One launch of K3 on padded CUDA operands; (out, lse or None)."""
    B, Sq_p, H, hd_p = qp.shape
    Sk_p, KV = kp.shape[1], kp.shape[2]
    out = torch.empty_like(qp)
    lse = (torch.empty((B, H, Sq_p), dtype=torch.float32, device=qp.device)
           if with_lse else None)
    fn = getattr(_kernel_lib(), _ENTRY[qp.dtype])
    with torch.cuda.device(qp.device):
        stream = torch.cuda.current_stream(qp.device).cuda_stream
        rc = fn(qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(),
                B, Sq_p, Sk_p, sk_valid, H, KV, hd_p, scale, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention: CUDA kernel launch failed "
                           f"(cudaError {rc})")
    flash_attention.launches += 1
    return out, lse


def flash_attention_fwd(q, k, v, *, scale: float, sk_valid: int):
    """K3's forward with its log-sum-exp on operands the kernel runs as they
    are (S multiples of 64, hd compiled; `pad_operands` gives them): (out,
    lse (B, H, Sq) f32).  One launch on CUDA tensors, the plain version on
    CPU tensors."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_lse_ref(q, k, v, scale=scale, sk_valid=sk_valid)
    _check_launchable(("q", q), ("k", k), ("v", v))
    return _launch_forward(q, k, v, scale, sk_valid, with_lse=True)


def flash_attention_bwd(q, k, v, o, lse, do, *, scale: float, sk_valid: int):
    """K3-bwd: (dq, dk, dv) of K3 on the operands K3 ran (as
    `flash_attention_fwd` takes them), its output `o` and `lse`, for the
    output gradient `do`.  On CUDA tensors one call launches the three
    kernels of `csrc/flash_attention_bwd.cu` for the dtype's design
    (`PATHS_BWD`: D, then dK/dV, then dQ; counted once in
    `flash_attention_bwd.launches`); two calls on the same operands give the
    same bits.  On CPU tensors it runs `flash_attention_bwd_ref`.  A failed
    build or launch raises."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, lse, do, scale=scale,
                                       sk_valid=sk_valid)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device {q.device}")
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if (Sq % TILE or Sk % TILE or hd not in HEAD_DIMS
            or not Sk - TILE < sk_valid <= Sk):
        raise ValueError(f"flash_attention_bwd: ({Sq}, {Sk}, {hd}) with "
                         f"sk_valid {sk_valid} is not a padded shape "
                         "(`pad_operands`)")
    if (o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype
            or do.dtype != q.dtype or lse.shape != (B, H, Sq)
            or lse.dtype != torch.float32):
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)} "
                         f"{o.dtype}, do {tuple(do.shape)} {do.dtype} and lse "
                         f"{tuple(lse.shape)} {lse.dtype} do not fit q "
                         f"{tuple(q.shape)} {q.dtype}")
    _check_launchable(("q", q), ("k", k), ("v", v), ("o", o), ("do", do),
                      ("lse", lse))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    fn = getattr(_bwd_lib(), _BWD_ENTRY[q.dtype])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                B, Sq, Sk, sk_valid, H, KV, hd, scale, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd: CUDA kernel launch failed "
                           f"(cudaError {rc})")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


def causal_pairs(sq: int, sk: int, sk_valid: int | None = None) -> int:
    """(query, key) pairs causal attention scores: query i reads keys
    j <= i below `sk_valid` (default Sk)."""
    n = min(sk, sk if sk_valid is None else sk_valid)
    m = min(sq, n)
    return m * (m + 1) // 2 + (sq - m) * n


def _fwd_flops(B: int, H: int, hd: int, pairs: int) -> int:
    """QK^T and PV over the causal pairs, 2 FLOPs a multiply-add."""
    return 4 * B * H * hd * pairs


# --- registered ops ---------------------------------------------------------
#
# The kernels are custom ops so that FakeTensor and DTensor code can trace
# them: under `FakeTensorMode` the fake implementations allocate only the
# outputs the kernels write (never the plain version's score matrix), and
# `FlopCounterMode` counts what the kernels compute through the formulas
# registered below.  The real implementations are the wrappers above.

@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _attention_op(q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """Serving: K3 without lse on CUDA tensors (padded, sliced), the plain
    version on CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v).contiguous()
    _check_launchable(("q", q), ("k", k), ("v", v))
    qp, kp, vp = pad_operands(q, k, v)
    out, _ = _launch_forward(qp, kp, vp, q.shape[3] ** -0.5, k.shape[1])
    if out.shape == q.shape:
        return out
    return out[:, :q.shape[1], :, :q.shape[3]].contiguous()


@_attention_op.register_fake
def _(q, k, v):
    return q.new_empty(q.shape)


@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=())
def _fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
            sk_valid: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Training: `flash_attention_fwd` (K3 with lse) on padded operands
    (contiguous results, as the fake implementation states them)."""
    out, lse = flash_attention_fwd(q, k, v, scale=scale, sk_valid=sk_valid)
    return out.contiguous(), lse.contiguous()


@_fwd_op.register_fake
def _(q, k, v, scale, sk_valid):
    B, Sq, H, _ = q.shape
    return q.new_empty(q.shape), q.new_empty((B, H, Sq), dtype=torch.float32)


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def _bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
            scale: float, sk_valid: int) -> tuple[torch.Tensor, torch.Tensor,
                                                  torch.Tensor]:
    """K3-bwd (`flash_attention_bwd`) on the operands K3 ran (contiguous
    results, as the fake implementation states them)."""
    return tuple(g.contiguous() for g in flash_attention_bwd(
        q, k, v, o, lse, do, scale=scale, sk_valid=sk_valid))


@_bwd_op.register_fake
def _(q, k, v, o, lse, do, scale, sk_valid):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


def _setup_context(ctx, inputs, output):
    q, k, v, scale, sk_valid = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.scale, ctx.sk_valid = scale, sk_valid


def _backward(ctx, dout, _dlse):
    q, k, v, out, lse = ctx.saved_tensors
    dq, dk, dv = _bwd_op(q, k, v, out, lse, dout.contiguous(), ctx.scale,
                         ctx.sk_valid)
    return dq, dk, dv, None, None


_fwd_op.register_autograd(_backward, setup_context=_setup_context)


def _register_flop_formulas() -> None:
    from torch.utils.flop_counter import register_flop_formula

    @register_flop_formula(torch.ops.repro_torch.flash_attention)
    def _(q_shape, k_shape, v_shape, *args, out_shape=None, **kwargs):
        B, Sq, H, hd = q_shape
        return _fwd_flops(B, H, hd, causal_pairs(Sq, k_shape[1]))

    @register_flop_formula(torch.ops.repro_torch.flash_attention_fwd)
    def _(q_shape, k_shape, v_shape, scale, sk_valid, *args, out_shape=None,
          **kwargs):
        B, Sq, H, hd = q_shape
        return _fwd_flops(B, H, hd, causal_pairs(Sq, k_shape[1], sk_valid))

    @register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
    def _(q_shape, k_shape, v_shape, o_shape, lse_shape, do_shape, scale,
          sk_valid, *args, out_shape=None, **kwargs):
        # QK^T again, dO V^T, P^T dO, dS^T Q and dS K: 2.5 forwards
        B, Sq, H, hd = q_shape
        return 5 * _fwd_flops(B, H, hd,
                              causal_pairs(Sq, k_shape[1], sk_valid)) // 2


_register_flop_formulas()


def flash_attention(q, k, v, bq: int = TILE, bk: int = TILE):
    """Causal GQA attention through the CUDA kernel for CUDA tensors (the
    plain version for CPU tensors), differentiable through K3-bwd when
    autograd records it (the registered op `repro_torch::flash_attention_fwd`
    and its backward `repro_torch::flash_attention_bwd`; under `no_grad`,
    `repro_torch::flash_attention`).  Returns (B, Sq, H, hd)."""
    _check(q, k, v)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    if Sk < 1:
        raise ValueError("flash_attention: no keys (Sk is 0)")
    if B == 0 or H == 0 or Sq == 0:
        return torch.empty_like(q)
    Sq_p, Sk_p, hd_p = padded_shape(Sq, Sk, hd)
    bq, bk = min(bq, Sq_p), min(bk, Sk_p)
    if (bq, bk) != (TILE, TILE):
        raise ValueError(f"flash_attention: blocks ({bq}, {bk}) are not "
                         f"compiled; the kernel's tiles are ({TILE}, {TILE})")
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    if not grad:
        return _attention_op(q, k, v)
    if q.device.type == "cuda" and not is_fake(q):
        _check_launchable(("q", q), ("k", k), ("v", v))
    qp, kp, vp = pad_operands(q, k, v)
    out, _ = _fwd_op(qp, kp, vp, hd ** -0.5, Sk)
    if out.shape == q.shape:
        return out
    return out[:, :Sq, :, :hd].contiguous()


flash_attention.launches = 0
