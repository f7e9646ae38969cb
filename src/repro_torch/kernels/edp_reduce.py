"""The per-mapping trip-count / energy reduction of the cost model (K1).

This is the innermost arithmetic of the analytical cost model (`model.evaluate`
-> `batch.evaluate_batch`): for each candidate mapping, reduce the per-level
loop factors into refetch trip counts (the Timeloop temporal-reuse rule),
read-modify-write passes, and finally the energy / delay / EDP scalars.

Two implementations of one function:

  * `reduce_edp_terms` -- the plain PyTorch version (any device): the CPU
    path and the reference the kernel is held against;
  * `edp_reduce` -- the wrapper of the hand-written CUDA kernel
    (`csrc/edp_reduce.cu`, built for sm_90a at first use).  It launches the
    kernel for CUDA tensors and takes the plain version only for CPU tensors;
    a failed build or launch raises, it never falls back.  `edp_reduce.launches`
    counts kernel launches.

Operand layout (all leading dim B, one dtype, float32 or float64):

  fo     (B, 2, 6)     loop factors *in loop order* at [gb, dram] level
  relo   (B, 2, 3, 6)  0/1 relevance per [level, tensor(W,I,O), loop position]
  tiles  (B, 2, 3)     [lb, gb] x [W, I, O] tile sizes
  sp     (B, 6)        [sp_rel_W, sp_rel_I, sp_rel_O, sp_all, used_pes, macs]
  consts (B, 7)        [e_mac, e_lb, e_noc, e_gb, e_dram, gb_bw, dram_bw]

Every constant rides per row: the rows of one call may belong to different
layers (the layer-stacked search) and different hardware probes (the
probe-fanout search).

Outputs:

  ev     (B, 3)        [energy_pj, delay_cycles, edp]
  trips  (B, 6)        refetch trips [W, I, O]@gb then [W, I, O]@dram
"""

from __future__ import annotations

import ctypes

import torch

N_DIMS = 6
N_TENSORS = 3

_SHAPES = {"fo": (2, N_DIMS), "relo": (2, N_TENSORS, N_DIMS),
           "tiles": (2, N_TENSORS), "sp": (6,), "consts": (7,)}
_ENTRY = {torch.float64: "edp_reduce_f64", torch.float32: "edp_reduce_f32"}


def reduce_edp_terms(fo, relo, tiles, sp, consts):
    """Batched trip-count + energy reduction (see module docstring for shapes).

    Mirrors `timeloop.model.evaluate` / `batch.evaluate_batch` exactly; the
    trip products are integer-valued (exact below 2^53 in f64), so their
    order does not matter, and the energy sums run in the reference's term
    order."""
    n = fo.shape[0]
    one = torch.ones((), dtype=fo.dtype, device=fo.device)
    pos = torch.arange(N_DIMS, device=fo.device).expand(n, N_DIMS)

    def level_trips(f, r):
        # f: (n, 6) factors in loop order; r: (n, 6) 0/1 relevance mask.
        rel = r > 0.5
        active = rel & (f > 1.0)
        innermost = torch.where(active, pos, -1).amax(dim=1)
        include = rel | (pos < innermost[:, None])
        t = torch.where(include, f, one).prod(dim=1)
        return torch.where(active.any(dim=1), t, one)

    def passes(f, r):
        # Reduction passes for outputs: irrelevant loops outside all relevant.
        rel = r > 0.5
        active = rel & (f > 1.0)
        anchor = torch.where(active, pos, N_DIMS).amin(dim=1)
        include = (~rel) & (pos < anchor[:, None])
        return torch.where(include, f, one).prod(dim=1)

    e_mac, e_lb, e_noc, e_gb, e_dram, gb_bw, dram_bw = consts.unbind(1)
    macs = sp[:, 5]

    trips = [
        level_trips(fo[:, li, :], relo[:, li, ti, :])
        for li in range(2)
        for ti in range(N_TENSORS)
    ]
    rw_gb = 2.0 * passes(fo[:, 0, :], relo[:, 0, 2, :]) - 1.0
    rw_dram = 2.0 * passes(fo[:, 1, :], relo[:, 1, 2, :]) - 1.0

    sp_all = sp[:, 3]
    used = sp[:, 4]
    lb_acc = torch.zeros((n,), dtype=fo.dtype, device=fo.device)
    noc_acc = torch.zeros_like(lb_acc)
    gb_acc = torch.zeros_like(lb_acc)
    dram_acc = torch.zeros_like(lb_acc)
    for ti in range(N_TENSORS):
        gb_trips = trips[ti]
        dram_trips = trips[N_TENSORS + ti]
        rw = rw_gb if ti == 2 else one
        rw_d = rw_dram if ti == 2 else one
        fills_lb = tiles[:, 0, ti] * gb_trips * dram_trips
        gb_acc = gb_acc + fills_lb * sp[:, ti] * rw
        noc_acc = noc_acc + fills_lb * sp_all * rw
        lb_acc = lb_acc + fills_lb * sp_all * rw
        dram_acc = dram_acc + tiles[:, 1, ti] * dram_trips * rw_d
    lb_acc = lb_acc + 4.0 * macs

    energy = (
        macs * e_mac
        + lb_acc * e_lb
        + noc_acc * e_noc
        + gb_acc * e_gb
        + dram_acc * e_dram
    )
    delay = torch.maximum(
        macs / used, torch.maximum(gb_acc / gb_bw, dram_acc / dram_bw)
    )
    ev = torch.stack([energy, delay, energy * delay], dim=1)
    return ev, torch.stack(trips, dim=1)


def _check(fo, relo, tiles, sp, consts) -> int:
    ops = {"fo": fo, "relo": relo, "tiles": tiles, "sp": sp, "consts": consts}
    n = fo.shape[0]
    for name, x in ops.items():
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"edp_reduce: {name} must be a torch.Tensor")
        if x.device != fo.device:
            raise ValueError(f"edp_reduce: {name} is on {x.device}, "
                             f"fo on {fo.device}")
        if x.dtype != fo.dtype:
            raise ValueError(f"edp_reduce: {name} is {x.dtype}, fo {fo.dtype}")
        if tuple(x.shape) != (n, *_SHAPES[name]):
            raise ValueError(f"edp_reduce: {name} has shape {tuple(x.shape)}, "
                             f"expected {(n, *_SHAPES[name])}")
    if fo.dtype not in _ENTRY:
        raise ValueError(f"edp_reduce: dtype must be float32 or float64, "
                         f"got {fo.dtype}")
    return n


def _kernel_lib():
    from repro_torch.kernels import build

    lib = build.load("edp_reduce")
    for entry in _ENTRY.values():
        fn = getattr(lib, entry)
        if fn.argtypes is None:
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong,
                                                   ctypes.c_void_p]
    return lib


def edp_reduce(fo, relo, tiles, sp, consts):
    """`reduce_edp_terms` through the CUDA kernel for CUDA tensors (the plain
    version for CPU tensors).  Returns (ev (B, 3), trips (B, 6))."""
    n = _check(fo, relo, tiles, sp, consts)
    if fo.device.type == "cpu":
        return reduce_edp_terms(fo, relo, tiles, sp, consts)
    if fo.device.type != "cuda":
        raise ValueError(f"edp_reduce: unsupported device {fo.device}")
    for name, x in (("fo", fo), ("relo", relo), ("tiles", tiles), ("sp", sp),
                    ("consts", consts)):
        if not x.is_contiguous():
            raise ValueError(f"edp_reduce: {name} must be contiguous")
    ev = torch.empty((n, 3), dtype=fo.dtype, device=fo.device)
    trips = torch.empty((n, N_DIMS), dtype=fo.dtype, device=fo.device)
    if n == 0:
        return ev, trips
    fn = getattr(_kernel_lib(), _ENTRY[fo.dtype])
    with torch.cuda.device(fo.device):
        stream = torch.cuda.current_stream(fo.device).cuda_stream
        rc = fn(fo.data_ptr(), relo.data_ptr(), tiles.data_ptr(),
                sp.data_ptr(), consts.data_ptr(), ev.data_ptr(),
                trips.data_ptr(), n, stream)
    if rc != 0:
        raise RuntimeError(f"edp_reduce: CUDA kernel launch failed "
                           f"(cudaError {rc})")
    edp_reduce.launches += 1
    return ev, trips


edp_reduce.launches = 0
