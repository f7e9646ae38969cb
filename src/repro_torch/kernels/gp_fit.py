"""The GP's whole hyperparameter fit in one kernel (K4).

`core.gp._fit` fits a stack of exact GPs by 80 steps of Adam on the negative
marginal log-likelihood, each step an eager forward and `torch.autograd.grad`
of some 180 small launches.  K4 (`csrc/gp_fit.cu`, `gp_fit_kernel`) runs every
step of one stack in one launch: one CTA a run, on that run's real rows only
(padding trails and has exactly zero influence), with the NLL's gradient in
closed form,

    dNLL/dtheta = 0.5 tr((K^-1 - alpha alpha^T) dK/dtheta),  alpha = K^-1 r,

and the Adam update of `_fit` (betas 0.9 / 0.999, eps 1e-8 outside the square
root, the bias corrections `1 - 0.9 ** t` of a float step count, computed on
the host and passed in), all in float64.  The objective is the one the eager
fit would use for the shape: the Cholesky NLL, or for a stacked linear fit
above `gp._LOWRANK_MIN_ROWS` padded rows its Woodbury form, whose gradient
goes through K^-1 = D^-1 - D^-1 V A^-1 V^T D^-1 in O(n d^2).  A factor with a
non-positive pivot gives NaN gradients, so that run's parameters turn NaN as
the eager fit's do (the pinned `log_tau` of `noisy=False` keeps its value).

Two functions:

  * `fit_path` -- the routing rule, pure: "kernel" for float64 operands on a
    CUDA device, no early exit (`fit_tol == 0`: the exit needs a host
    gradient norm every step) and a shape inside the kernel's caps
    (`MAX_ROWS` real rows a run in each form, `MAX_D` features); "eager"
    otherwise;
  * `gp_fit` -- the wrapper: K4 for CUDA tensors in one launch
    (`gp_fit.launches` counts them).  A failed build or launch raises; it
    never falls back, and it refuses CPU tensors (a CUDA kernel has no CPU
    mode).  The kernel's algorithm in plain PyTorch, which tests hold
    against the autograd fit and the card against K4, is
    `tests/gp_fit_reference.py`.

Parameters travel packed in one float64 buffer, one block a key in sorted
key order (`layout`), each block (L, width) row-major, so the fitted dict's
tensors are contiguous views of the output.
"""

from __future__ import annotations

import ctypes

import torch

MAX_D = 32
# Real rows a run: the Cholesky form keeps K, L^-1 and (SE) the squared
# distances in shared memory (3 x 64 x 65 doubles); the Woodbury form keeps
# the run's X (512 x 32 doubles) and four (d+1)^2 systems.  The library's
# `gp_fit_smem_bytes` counts the bytes (`built_smem_bytes`).
MAX_ROWS = {"cholesky": 64, "woodbury": 512}
# `csrc/gp_fit.cu`'s form numbers, by (kind, Woodbury).
FORMS = {("linear", False): 0, ("se", False): 1, ("linear", True): 2}

_F64 = torch.float64
_bc_cache: dict = {}


def fit_path(device, fit_tol: float, kind: str, lowrank: bool, rows: int,
             d: int, dtype: torch.dtype) -> str:
    """"kernel" where K4 fits this stack exactly as the eager `_fit` would,
    "eager" otherwise.  `rows`: the most real rows of any run; `lowrank`:
    the Woodbury form (a stacked linear fit above the switch); `dtype`: the
    operands' (K4 is float64 only)."""
    if torch.device(device).type != "cuda" or fit_tol != 0.0:
        return "eager"
    if dtype != _F64 or (kind, lowrank) not in FORMS:
        return "eager"
    cap = MAX_ROWS["woodbury" if lowrank else "cholesky"]
    return "kernel" if rows <= cap and d <= MAX_D else "eager"


def layout(kind: str, d: int) -> list[tuple[str, int]]:
    """(key, width) of each parameter block of the packed buffer, in sorted
    key order (the order `_fit` returns them in)."""
    widths = ({"log_w": d, "log_bias": 1} if kind == "linear"
              else {"log_alpha": 1, "log_ell": 1})
    widths.update(log_tau=1, mean_const=1)
    return sorted(widths.items())


def bias_corrections(steps: int) -> list[float]:
    """Adam's bias corrections as `_fit` computes them: 1 - 0.9 ** t for
    t = 1.0, 2.0, ... (a float step count), then 1 - 0.999 ** t."""
    ts = [float(t) for t in range(1, steps + 1)]
    return [1 - 0.9 ** t for t in ts] + [1 - 0.999 ** t for t in ts]


# --- the kernel -----------------------------------------------------------------

def _kernel_lib():
    from repro_torch.kernels import build

    lib = build.load("gp_fit")
    if lib.gp_fit_f64.argtypes is None:
        lib.gp_fit_f64.restype = ctypes.c_int
        lib.gp_fit_f64.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                                   + [ctypes.c_double, ctypes.c_void_p])
        lib.gp_fit_smem_bytes.restype = ctypes.c_longlong
        lib.gp_fit_smem_bytes.argtypes = [ctypes.c_int] * 3
    return lib


def built_smem_bytes(form: int, rows: int, d: int) -> int:
    """Dynamic shared memory of one CTA of `form` for `rows` rows and `d`
    features, as the library launches it (builds it if need be)."""
    return int(_kernel_lib().gp_fit_smem_bytes(form, rows, d))


def _device_bias_corrections(steps: int, device) -> torch.Tensor:
    key = (steps, str(device))
    bc = _bc_cache.get(key)
    if bc is None:
        bc = _bc_cache[key] = torch.tensor(bias_corrections(steps),
                                           dtype=_F64).to(device)
    return bc


def gp_fit(params, X, y, mask, kind, steps=80, lr=0.05, train_tau=True,
           lowrank=False, *, rows: int) -> dict:
    """`_fit`'s fixed-step fit (no early exit) of the stack in one K4 launch.
    X, y and mask are contiguous float64 CUDA tensors; `params` may live on
    the host: they are packed there and copied once.  `rows`, the most real
    rows of any run (the caller knows it without reading the mask), must be
    inside `MAX_ROWS` for the form, and d inside `MAX_D`."""
    if X.device.type != "cuda":
        raise ValueError(f"gp_fit: K4 runs on a CUDA device, not {X.device}")
    form = FORMS[kind, lowrank]
    L, b, d = X.shape
    if fit_path(X.device, 0.0, kind, lowrank, rows, d, _F64) != "kernel":
        raise ValueError(f"gp_fit: {L} runs of up to {rows} rows and {d} "
                         f"features are outside K4's caps")
    for name, x in (("X", X), ("y", y), ("mask", mask)):
        if x.dtype != _F64 or not x.is_contiguous() or x.device != X.device:
            raise ValueError(f"gp_fit: {name} must be contiguous float64 "
                             f"on {X.device}")
    keys = layout(kind, d)
    p0 = torch.cat([params[k].detach().reshape(-1).to(_F64)
                    for k, _ in keys]).to(X.device)
    p1 = torch.empty_like(p0)
    bc = _device_bias_corrections(steps, X.device)
    fn = _kernel_lib().gp_fit_f64
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        rc = fn(X.data_ptr(), y.data_ptr(), mask.data_ptr(), p0.data_ptr(),
                p1.data_ptr(), bc.data_ptr(), form, L, b, d, rows, steps,
                int(bool(train_tau)), float(lr), stream)
    if rc != 0:
        raise RuntimeError(f"gp_fit: CUDA kernel launch failed "
                           f"(cudaError {rc})")
    gp_fit.launches += 1
    out, off = {}, 0
    for k, width in keys:
        block = p1[off:off + L * width]
        out[k] = block.view(L, width) if k == "log_w" else block
        off += L * width
    return out


gp_fit.launches = 0
