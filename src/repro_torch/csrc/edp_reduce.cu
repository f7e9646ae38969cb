// Per-mapping trip-count / energy / delay / EDP reduction of the analytical
// cost model, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/edp_reduce.py::edp_reduce
// (body `_edp_kernel`, numerics `reduce_edp_terms`); the plain PyTorch twin is
// `repro_torch.kernels.edp_reduce.reduce_edp_terms`, which this kernel
// mirrors operation for operation (built with -fmad=false, so every product
// and sum rounds where the plain version's does).
//
// Layout (row-major, contiguous, leading dim B -- one row per candidate
// mapping; rows of one call may belong to different layers and hardware
// probes, so every constant rides per row):
//   in   fo (B,2,6)  relo (B,2,3,6)  tiles (B,2,3)  sp (B,6)  consts (B,7)
//   out  ev (B,3) = [energy, delay, edp]   trips (B,6) = [W,I,O]@gb, @dram
//
// Design: one thread per row, the six-wide loop-position scans unrolled, a
// 256-thread block and a bounds check on the ragged edge (a CUDA block need
// not divide B, unlike the Pallas block).  Templated on float and double.
//
// Bound: memory.  A row reads 12+36+6+6+7 = 67 values and writes 3+6 = 9,
// 76 values or 608 B in f64, against ~100 flops.  The main path's largest
// stacked dispatch (speculative fan-out, 8 probes x 4 layers x 256-row bucket
// = 8,192 rows) moves ~5 MB: ~1.5 us at 3.35 TB/s.  At these sizes the launch
// itself (~several us) dominates.  What a later step does about it (K1b):
// fuse the `_prep_one` tiles/validity/gathers, the features and the -log10
// utility of `batch_torch._forward` into this launch, so one kernel reads the
// packed (B,5,6) factors and writes features + utility.

#include <cuda_runtime.h>

namespace {

constexpr int kDims = 6;
constexpr int kThreads = 256;

// Timeloop refetch trips at one level: product of the relevant factors plus
// every factor outside the innermost active relevant loop (1 if none active).
template <typename T>
__device__ __forceinline__ T level_trips(const T* f, const T* r) {
  int innermost = -1;
  bool any_active = false;
#pragma unroll
  for (int p = 0; p < kDims; ++p) {
    if (r[p] > T(0.5) && f[p] > T(1.0)) {
      innermost = p;
      any_active = true;
    }
  }
  T t = T(1.0);
#pragma unroll
  for (int p = 0; p < kDims; ++p) {
    if (r[p] > T(0.5) || p < innermost) t = t * f[p];
  }
  return any_active ? t : T(1.0);
}

// Output read-modify-write passes: irrelevant loops outside every active
// relevant loop.
template <typename T>
__device__ __forceinline__ T passes(const T* f, const T* r) {
  int anchor = kDims;
#pragma unroll
  for (int p = kDims - 1; p >= 0; --p) {
    if (r[p] > T(0.5) && f[p] > T(1.0)) anchor = p;
  }
  T t = T(1.0);
#pragma unroll
  for (int p = 0; p < kDims; ++p) {
    if (!(r[p] > T(0.5)) && p < anchor) t = t * f[p];
  }
  return t;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
edp_reduce_kernel(const T* __restrict__ fo, const T* __restrict__ relo,
                  const T* __restrict__ tiles, const T* __restrict__ sp,
                  const T* __restrict__ consts, T* __restrict__ ev,
                  T* __restrict__ trips, long long n) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  const T* f = fo + i * 12;       // [level][pos]
  const T* r = relo + i * 36;     // [level][tensor][pos]
  const T* tl = tiles + i * 6;    // [lb, gb][W, I, O]
  const T* s = sp + i * 6;        // sp_rel W I O, sp_all, used, macs
  const T* c = consts + i * 7;    // e_mac e_lb e_noc e_gb e_dram gb_bw dram_bw

  T tr[6];
#pragma unroll
  for (int li = 0; li < 2; ++li) {
#pragma unroll
    for (int ti = 0; ti < 3; ++ti) {
      tr[li * 3 + ti] = level_trips(f + li * kDims, r + li * 18 + ti * kDims);
    }
  }
  const T rw_gb = T(2.0) * passes(f, r + 2 * kDims) - T(1.0);
  const T rw_dram = T(2.0) * passes(f + kDims, r + 18 + 2 * kDims) - T(1.0);

  const T sp_all = s[3];
  const T used = s[4];
  const T macs = s[5];
  T lb_acc = T(0.0), noc_acc = T(0.0), gb_acc = T(0.0), dram_acc = T(0.0);
#pragma unroll
  for (int ti = 0; ti < 3; ++ti) {
    const T gb_trips = tr[ti];
    const T dram_trips = tr[3 + ti];
    const T rw = ti == 2 ? rw_gb : T(1.0);
    const T rw_d = ti == 2 ? rw_dram : T(1.0);
    const T fills_lb = tl[ti] * gb_trips * dram_trips;
    gb_acc = gb_acc + fills_lb * s[ti] * rw;
    noc_acc = noc_acc + fills_lb * sp_all * rw;
    lb_acc = lb_acc + fills_lb * sp_all * rw;
    dram_acc = dram_acc + tl[3 + ti] * dram_trips * rw_d;
  }
  lb_acc = lb_acc + T(4.0) * macs;

  const T energy = macs * c[0] + lb_acc * c[1] + noc_acc * c[2] +
                   gb_acc * c[3] + dram_acc * c[4];
  const T delay = fmax(macs / used, fmax(gb_acc / c[5], dram_acc / c[6]));
  T* e = ev + i * 3;
  e[0] = energy;
  e[1] = delay;
  e[2] = energy * delay;
  T* to = trips + i * 6;
#pragma unroll
  for (int j = 0; j < 6; ++j) to[j] = tr[j];
}

template <typename T>
int launch(const void* fo, const void* relo, const void* tiles, const void* sp,
           const void* consts, void* ev, void* trips, long long n,
           void* stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  edp_reduce_kernel<T><<<static_cast<unsigned int>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(fo), static_cast<const T*>(relo),
      static_cast<const T*>(tiles), static_cast<const T*>(sp),
      static_cast<const T*>(consts), static_cast<T*>(ev),
      static_cast<T*>(trips), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 on success).  The caller
// guarantees n > 0, contiguous operands of the layout above, one dtype.
int edp_reduce_f64(const void* fo, const void* relo, const void* tiles,
                   const void* sp, const void* consts, void* ev, void* trips,
                   long long n, void* stream) {
  return launch<double>(fo, relo, tiles, sp, consts, ev, trips, n, stream);
}

int edp_reduce_f32(const void* fo, const void* relo, const void* tiles,
                   const void* sp, const void* consts, void* ev, void* trips,
                   long long n, void* stream) {
  return launch<float>(fo, relo, tiles, sp, consts, ev, trips, n, stream);
}

}  // extern "C"
