// The analytical cost model's per-mapping arithmetic, for Hopper (sm_90a).
// Two kernels share one per-row reduction (`reduce_row`):
//
// edp_reduce (K1) -- the Pallas TPU kernel src/repro/kernels/edp_reduce.py::
// edp_reduce (body `_edp_kernel`, numerics `reduce_edp_terms`): refetch trips,
// read-modify-write passes, energy, delay and EDP from operands already
// gathered in loop order.  Plain PyTorch twin:
// `repro_torch.kernels.edp_reduce.reduce_edp_terms`.
//   in   fo (B,2,6)  relo (B,2,3,6)  tiles (B,2,3)  sp (B,6)  consts (B,7)
//   out  ev (B,3) = [energy, delay, edp]   trips (B,6) = [W,I,O]@gb, @dram
// One thread per row, 256-thread blocks.  The co-design search no longer
// launches it (cost_forward below does its work); it stays as the TPU
// kernel's own function, held against `reduce_edp_terms`.
//
// cost_forward (K1b) -- the whole cost-model forward of
// `repro_torch.timeloop.batch_torch._forward` in one launch, the counterpart
// of the reference's one XLA program around the Pallas call
// (src/repro/timeloop/batch_jax.py `_forward`).  Plain PyTorch twin:
// `repro_torch.kernels.cost_forward.cost_forward_ref`.
//   in   factors (N,5,6) [lb, sx, sy, gb, dram] x [R, S, P, Q, C, K]
//        order_gb, order_dram (N,6) int64 loop orders
//        hwv (N,15)  layv (N,8)   (layouts in kernels/cost_forward.py)
//   out  valid (N,) bool   scal (4,N) = [energy, delay, edp, utility]
//        (inf / -inf where invalid)   features (N,14)
// Per row: the tiles, the validity checks, the gathers into loop order and
// the spatial factors (`_prep`), then `reduce_row`, then the 14 features and
// the -log10 utility.
//
// Numerics: every kernel mirrors its plain version operation for operation.
// Built with -fmad=false, so each product and sum rounds where PyTorch's
// does; divides are IEEE (no fast math); log1p / log10 are CUDA's math
// library functions, which PyTorch's CUDA ops call too.  Everything before
// the logs is integer-valued below 2^24 or a single divide, so the card gives
// the plain version's bits in float64 and float32.
//
// Bound: memory, and below it the launch.  A cost_forward row reads 30 + 15
// + 8 values and 12 int64 and writes 4 + 14 values and a byte: 665 B in
// float64 for a few hundred flops; the smoke search's 3,072-row forward
// moves ~2 MB, ~0.6 us at 3.35 TB/s, under a launch's few us.  So the design
// spends one launch per forward and keeps each thread's chain short: 64-row
// CTAs (3,072 rows fill 48 SMs), each staging the contiguous slabs of its
// rows' operands into shared memory with 16-byte cp.async copies, all in
// flight at once (~30 a thread; as blocking loads they paid the memory
// latency one after another), one thread per row reading its row there, and
// the strided (N,14) features written back through shared memory in 16-byte
// stores; the (4,N) scalars and the mask are written straight from
// registers, 32 neighbouring values a warp.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kDims = 6;
constexpr int kThreads = 256;   // edp_reduce's block
constexpr int kRows = 64;       // cost_forward's block: one thread per row
constexpr int kLevels = 5;
constexpr int kFactors = kLevels * kDims;
constexpr int kHw = 15;
constexpr int kLayer = 8;
constexpr int kFeatures = 14;

// factors' level axis and the dims (DIMS order R, S, P, Q, C, K)
enum { kLB, kSX, kSY, kGB, kDRAM };
enum { kR, kS, kP, kQ, kC, kK };
// hw_vec columns (validity bounds, then the consts block of edp_reduce)
enum { kLBW, kLBI, kLBO, kGBE, kMX, kMY, kDFW, kDFH, kEMAC };
// layer_vec columns: the six extents, then stride and macs
enum { kStride = 6, kMacs = 7 };
// Relevance of each dim to W (R S C K), I (R S P Q C) and O (P Q K), bit d.
__host__ __device__ constexpr unsigned rel_mask(int tensor) {
  return tensor == 0 ? 0x33u : tensor == 1 ? 0x1Fu : 0x2Cu;
}

// Timeloop refetch trips at one level: product of the relevant factors plus
// every factor outside the innermost active relevant loop (1 if none active).
template <typename T, typename R>
__device__ __forceinline__ T level_trips(const T* f, const R* r) {
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
template <typename T, typename R>
__device__ __forceinline__ T passes(const T* f, const R* r) {
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

// K1's function on one row: f (2,6) factors in loop order, r (2,3,6) 0/1
// relevance in loop order (T, or bool in cost_forward), tl (2,3) tiles, s (6)
// [sp_rel W I O, sp_all, used, macs], c (7) consts -> ev [energy, delay,
// edp], tr (6) trips.
template <typename T, typename R>
__device__ __forceinline__ void reduce_row(const T* f, const R* r,
                                           const T* tl, const T* s,
                                           const T* c, T (&ev)[3],
                                           T (&tr)[6]) {
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
  ev[0] = energy;
  ev[1] = delay;
  ev[2] = energy * delay;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
edp_reduce_kernel(const T* __restrict__ fo, const T* __restrict__ relo,
                  const T* __restrict__ tiles, const T* __restrict__ sp,
                  const T* __restrict__ consts, T* __restrict__ ev,
                  T* __restrict__ trips, long long n) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  T e[3], tr[6];
  reduce_row(fo + i * 12, relo + i * 36, tiles + i * 6, sp + i * 6,
             consts + i * 7, e, tr);
#pragma unroll
  for (int j = 0; j < 3; ++j) ev[i * 3 + j] = e[j];
#pragma unroll
  for (int j = 0; j < 6; ++j) trips[i * 6 + j] = tr[j];
}

__device__ __forceinline__ double inf_t(double) {
  return __longlong_as_double(0x7ff0000000000000LL);
}
__device__ __forceinline__ float inf_t(float) { return __int_as_float(0x7f800000); }
__device__ __forceinline__ double log1p_t(double x) { return log1p(x); }
__device__ __forceinline__ float log1p_t(float x) { return log1pf(x); }
__device__ __forceinline__ double log10_t(double x) { return log10(x); }
__device__ __forceinline__ float log10_t(float x) { return log10f(x); }

// Stage `bytes` (a multiple of 4) from global to shared memory, both
// 16-byte aligned: the block's threads issue 16-byte cp.async copies of
// neighbouring words, all in flight at once (the caller commits and waits),
// and copy the 4-byte tail.
__device__ __forceinline__ void stage(void* dst, const void* src, int bytes) {
  char* d = static_cast<char*>(dst);
  const char* s = static_cast<const char*>(src);
  const int n16 = bytes / 16;
  for (int i = threadIdx.x; i < n16; i += blockDim.x)
    hopper::cp_async16(d + 16 * i, s + 16 * i);
  for (int i = n16 * 4 + threadIdx.x; i < bytes / 4; i += blockDim.x)
    reinterpret_cast<uint32_t*>(d)[i] = reinterpret_cast<const uint32_t*>(s)[i];
}

// Copy `bytes` (a multiple of 4) from shared to global memory, both 16-byte
// aligned: 16-byte stores of neighbouring words, then the 4-byte tail.
__device__ __forceinline__ void unstage(void* dst, const void* src,
                                        int bytes) {
  const int n16 = bytes / 16;
  const uint4* s16 = static_cast<const uint4*>(src);
  uint4* d16 = static_cast<uint4*>(dst);
  for (int i = threadIdx.x; i < n16; i += blockDim.x) d16[i] = s16[i];
  const uint32_t* s4 = static_cast<const uint32_t*>(src);
  uint32_t* d4 = static_cast<uint32_t*>(dst);
  for (int i = n16 * 4 + threadIdx.x; i < bytes / 4; i += blockDim.x)
    d4[i] = s4[i];
}

template <typename T>
__device__ __forceinline__ T product(const T* v) {
  T p = v[0];
#pragma unroll
  for (int d = 1; d < kDims; ++d) p = p * v[d];
  return p;
}

// [W, I, O] tiles of per-dim extents f: R S C K, halo(P, R) halo(Q, S) C,
// P Q K, with halo(p, r) = (p - 1) * stride + r (ConvLayer.input_extent).
template <typename T>
__device__ __forceinline__ void tiles_of(const T* f, T stride, T* out) {
  out[0] = f[kR] * f[kS] * f[kC] * f[kK];
  const T hp = (f[kP] - T(1.0)) * stride + f[kR];
  const T hq = (f[kQ] - T(1.0)) * stride + f[kS];
  out[1] = hp * hq * f[kC];
  out[2] = f[kP] * f[kQ] * f[kK];
}

template <typename T>
__global__ void __launch_bounds__(kRows)
cost_forward_kernel(const T* __restrict__ factors,
                    const long long* __restrict__ order_gb,
                    const long long* __restrict__ order_dram,
                    const T* __restrict__ hwv, const T* __restrict__ layv,
                    bool* __restrict__ valid, T* __restrict__ scal,
                    T* __restrict__ feats, long long n) {
  __shared__ __align__(16) T s_fac[kRows * kFactors];
  __shared__ __align__(16) long long s_ord[2][kRows * kDims];
  __shared__ __align__(16) T s_hw[kRows * kHw];
  __shared__ __align__(16) T s_ly[kRows * kLayer];
  __shared__ __align__(16) T s_feat[kRows * kFeatures];

  const long long r0 = blockIdx.x * static_cast<long long>(kRows);
  const int rows = static_cast<int>(n - r0 < kRows ? n - r0 : kRows);
  const int sz = static_cast<int>(sizeof(T));
  stage(s_fac, factors + r0 * kFactors, rows * kFactors * sz);
  stage(s_ord[0], order_gb + r0 * kDims, rows * kDims * 8);
  stage(s_ord[1], order_dram + r0 * kDims, rows * kDims * 8);
  stage(s_hw, hwv + r0 * kHw, rows * kHw * sz);
  stage(s_ly, layv + r0 * kLayer, rows * kLayer * sz);
  hopper::cp_async_commit();
  hopper::cp_async_wait<0>();
  __syncthreads();

  const int t = threadIdx.x;
  if (t < rows) {
    T f[kLevels][kDims];
#pragma unroll
    for (int l = 0; l < kLevels; ++l)
#pragma unroll
      for (int d = 0; d < kDims; ++d) f[l][d] = s_fac[t * kFactors + l * kDims + d];
    const T* hw = s_hw + t * kHw;
    const T* ly = s_ly + t * kLayer;
    const T stride = ly[kStride];
    const T macs = ly[kMacs];

    // _prep: tiles at the local buffer and at the global buffer (the
    // product of the lb, sx, sy and gb factors), validity
    T tl[6];
    tiles_of(f[kLB], stride, tl);
    T cum[kDims];
#pragma unroll
    for (int d = 0; d < kDims; ++d) cum[d] = f[kLB][d] * f[kSX][d] * f[kSY][d] * f[kGB][d];
    tiles_of(cum, stride, tl + 3);

    bool ok = true;
#pragma unroll
    for (int d = 0; d < kDims; ++d)
      ok &= cum[d] * f[kDRAM][d] == ly[d];
    ok &= (hw[kDFW] != T(2.0)) | (f[kLB][kS] == ly[kS]);
    ok &= (hw[kDFH] != T(2.0)) | (f[kLB][kR] == ly[kR]);
    ok &= (tl[0] <= hw[kLBW]) & (tl[1] <= hw[kLBI]) & (tl[2] <= hw[kLBO]);
    const T gb_sum = tl[3] + tl[4] + tl[5];
    ok &= gb_sum <= hw[kGBE];
    const T sx = product(f[kSX]);
    const T sy = product(f[kSY]);
    ok &= (sx <= hw[kMX]) & (sy <= hw[kMY]);

    // spatial factors, and the gb / dram factors and relevance in loop order
    T sp[kDims];
#pragma unroll
    for (int d = 0; d < kDims; ++d) sp[d] = f[kSX][d] * f[kSY][d];
    T s[6];
#pragma unroll
    for (int ti = 0; ti < 3; ++ti) {
      T p = T(1.0);
#pragma unroll
      for (int d = 0; d < kDims; ++d) p = p * ((rel_mask(ti) >> d) & 1u ? sp[d] : T(1.0));
      s[ti] = p;
    }
    s[3] = product(sp);
    s[4] = sx * sy;
    s[5] = macs;
    T fo[2][kDims];
    bool relo[2][3][kDims];
#pragma unroll
    for (int li = 0; li < 2; ++li) {
      const long long* ord = s_ord[li] + t * kDims;
      const T* fl = f[li == 0 ? kGB : kDRAM];
#pragma unroll
      for (int p = 0; p < kDims; ++p) {
        const long long o = ord[p];
        T v = T(1.0);
        unsigned bit = 0u;
#pragma unroll
        for (int d = 0; d < kDims; ++d) {
          if (o == d) {
            v = fl[d];
            bit = 1u << d;
          }
        }
        fo[li][p] = v;
#pragma unroll
        for (int ti = 0; ti < 3; ++ti) relo[li][ti][p] = (rel_mask(ti) & bit) != 0u;
      }
    }

    T ev[3], tr[6];
    reduce_row(&fo[0][0], &relo[0][0][0], tl, s, hw + kEMAC, ev, tr);

    T* ft = s_feat + t * kFeatures;
    ft[0] = tl[1] / hw[kLBI];
    ft[1] = tl[0] / hw[kLBW];
    ft[2] = tl[2] / hw[kLBO];
    ft[3] = gb_sum / hw[kGBE];
    ft[4] = sx / hw[kMX];
    ft[5] = sy / hw[kMY];
#pragma unroll
    for (int j = 0; j < 6; ++j) ft[6 + j] = log1p_t(tr[j]);
    ft[12] = log1p_t(s[4]);
    ft[13] = log1p_t(macs / s[4]);

    const long long i = r0 + t;
    const T inf = inf_t(T(0.0));
    valid[i] = ok;
    scal[i] = ok ? ev[0] : inf;
    scal[n + i] = ok ? ev[1] : inf;
    scal[2 * n + i] = ok ? ev[2] : inf;
    scal[3 * n + i] = ok ? -log10_t(ev[2]) : -inf;
  }
  __syncthreads();
  unstage(feats + r0 * kFeatures, s_feat, rows * kFeatures * sz);
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

template <typename T>
int launch_forward(const void* factors, const void* order_gb,
                   const void* order_dram, const void* hwv, const void* layv,
                   void* valid, void* scal, void* feats, long long n,
                   void* stream) {
  const long long blocks = (n + kRows - 1) / kRows;
  cost_forward_kernel<T><<<static_cast<unsigned int>(blocks), kRows, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(factors), static_cast<const long long*>(order_gb),
      static_cast<const long long*>(order_dram), static_cast<const T*>(hwv),
      static_cast<const T*>(layv), static_cast<bool*>(valid),
      static_cast<T*>(scal), static_cast<T*>(feats), n);
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

// The same guarantees, and every operand 16-byte aligned; the orders are
// permutations of 0..5.
int cost_forward_f64(const void* factors, const void* order_gb,
                     const void* order_dram, const void* hwv,
                     const void* layv, void* valid, void* scal, void* feats,
                     long long n, void* stream) {
  return launch_forward<double>(factors, order_gb, order_dram, hwv, layv,
                                valid, scal, feats, n, stream);
}

int cost_forward_f32(const void* factors, const void* order_gb,
                     const void* order_dram, const void* hwv,
                     const void* layv, void* valid, void* scal, void* feats,
                     long long n, void* stream) {
  return launch_forward<float>(factors, order_gb, order_dram, hwv, layv,
                               valid, scal, feats, n, stream);
}

}  // extern "C"
