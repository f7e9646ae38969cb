// Causal GQA flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (body `_flash_kernel`); the plain PyTorch version is
// `repro_torch.kernels.ref.flash_attention_ref`, the oracle of the reference.
//
// Layout (row-major, contiguous):
//   q (B, Sq, H, hd), k and v (B, Sk, KV, hd), out (B, Sq, H, hd); H = g * KV.
//   Query head h reads KV head h / g (the reference's (B, S, KV, g, hd)
//   reshape).  Positions start at 0 for queries and keys; key j is visible to
//   query i when j <= i.
//
// Numerics, as the reference kernel:
//   * scores are an f32 dot of the input-dtype q and k, times hd^-0.5;
//   * masked scores are -1e30;
//   * running max m, sum l and accumulator acc in f32 (online softmax);
//   * p is rounded to v's dtype before the PV product, l sums the unrounded p;
//   * out = acc / max(l, 1e-30), rounded to q's dtype (round to nearest even).
// The bf16 kernel takes the max and masks on the unscaled scores s and
// computes p = exp(hd^-0.5 (s - m)) as 2^(s c - m c), c = hd^-0.5 log2(e),
// one FFMA and one SFU op (ex2.approx, the instruction behind __expf): equal
// in exact arithmetic, it moves p by about 1e-7 relative, far below the
// bf16 rounding of p.
//
// Two designs, one per dtype.
//
// bf16 -- `flash_mma_kernel`, the tensor cores.  One CTA of 4 warps per
// (64-row q tile, query head, batch); each warp owns 16 query rows.  QK^T
// and PV run as `mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32`: Q fragments
// are read once by `ldmatrix` and kept in registers, K fragments come by
// `ldmatrix` from K's (keys, hd) rows, V fragments by `ldmatrix.trans`.  K
// and V tiles of 64 keys arrive by `cp.async` into a double-buffered ring,
// so the next tile loads while this one computes.  P stays in registers: the
// f32 score accumulator, scaled, masked and exponentiated, is rounded to
// bf16 and reused directly as the A fragment of PV (FlashAttention-2).  The
// online softmax works on the accumulator fragments (row max and sum across
// the 4 lanes of a quad by shuffles; each lane keeps a partial l, summed
// once at the end).  hd = 8 is zero-padded to the mma's k of 16 for Q and K
// (exact) and keeps n = 8 for PV.  Shared rows are padded by 16 bytes so the
// 8 rows of an ldmatrix hit 8 different banks.  GQA keeps one query head per
// CTA (KV head h / g read from k and v): g query heads of one KV head load
// the same K/V tile from L2, not once.
//
// f32 -- `flash_fwd_kernel`, true FP32 on the CUDA cores (explicit fmaf,
// never TF32): one CTA of 256 threads (16 x 16) per (64-row q tile, query
// head, batch).  Q, K and V tiles are staged in shared memory as f32; each
// thread holds a 4 x 4 block of the 64 x 64 score tile (rows ty + 16i,
// columns tx + 16j) and the matching 4 rows of the output accumulator, so
// the running m and l of a row live in the 16 lanes that share ty and are
// reduced with warp shuffles.  K and Q rows are padded by one float so the
// 16 lanes reading 16 different key rows hit 16 banks.
//
// Both skip tiles above the diagonal and run the largest q tiles (most k
// tiles) first.  The skip is exact: the k tile at 0 is never fully masked
// for any query row (key 0 is visible to every query), so m is finite after
// the first tile, and a fully masked tile would add exp(-1e30 - m) = 0 to l
// and to acc with corr = exp(0) = 1.
//
// Bound: operations.  At the serve prefill shape (B 8, S 1088, H 15, hd 64)
// the causal work is ~2 * B * H * S^2 * hd = 18 GFLOP against 45 MB of
// q, k, v and out: at the bf16 tensor-core peak that is ~18 us, above the
// ~13 us the bytes take at 3.35 TB/s.  The bf16 kernel runs at ~6x that.
// Cutting its K/V reads from L2 (3 query heads a CTA, or 128-row q tiles)
// and deepening the cp.async ring did not move it, and neither did 32 rows
// a warp; folding the scale into exp2 and hoisting the ldmatrix addresses
// did (PERF.md).  What is left is each warp's serial chain of QK^T, softmax
// and PV at 12 warps an SM; a wgmma version is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kTile = 64;      // q rows and k columns per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
// p rounded to the value type before the PV product.
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }

template <int HD>
constexpr int smem_floats() {
  return 2 * kTile * (HD + 1) + kTile * HD + kTile * (kTile + 1);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int Sq, int Sk,
                 int H, int KV, float scale) {
  constexpr int QK = HD + 1;             // padded row stride of Qs and Ks
  constexpr int NJ = (HD + 15) / 16;     // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                      // [64][HD + 1]
  float* Ks = Qs + kTile * QK;           // [64][HD + 1]
  float* Vs = Ks + kTile * QK;           // [64][HD]
  float* Ps = Vs + kTile * HD;           // [64][65]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  // Largest q tiles (most k tiles) first.
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qt * kTile;

  const long long q_row = static_cast<long long>(H) * HD;
  const long long kv_row = static_cast<long long>(KV) * HD;
  const T* qb = q + (static_cast<long long>(b) * Sq + q0) * q_row + h * HD;
  for (int e = tid; e < kTile * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    Qs[r * QK + d] = to_f(qb[r * q_row + d]);
  }

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  const int n_kt = min(Sk / kTile, qt + 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's Ks, Vs and Ps are consumed
    const long long base = (static_cast<long long>(b) * Sk + k0) * kv_row +
                           static_cast<long long>(kvh) * HD;
    for (int e = tid; e < kTile * HD; e += kThreads) {
      const int r = e / HD, d = e % HD;
      Ks[r * QK + d] = to_f(k[base + r * kv_row + d]);
      Vs[r * HD + d] = to_f(v[base + r * kv_row + d]);
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * QK + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * QK + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float row_max = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        s[i][j] = kpos <= qpos ? s[i][j] * scale : kNeg;
        row_max = fmaxf(row_max, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off, 16));
      const float m_new = fmaxf(m[i], row_max);
      const float corr = expf(m[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        row_sum += p;
        Ps[(ty + 16 * i) * (kTile + 1) + tx + 16 * j] = round_to<T>(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off, 16);
      l[i] = l[i] * corr + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = acc[i][j] * corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * (kTile + 1) + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = tx + 16 * j;
        if (d < HD) {
          const float vv = Vs[c * HD + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }

  T* ob = out + (static_cast<long long>(b) * Sq + q0) * q_row + h * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float denom = fmaxf(l[i], 1e-30f);
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < HD) ob[r * q_row + d] = from_f<T>(acc[i][j] / denom);
    }
  }
}

template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v, void* out, int B,
              int Sq, int Sk, int H, int KV, float scale, cudaStream_t stream) {
  constexpr int bytes = smem_floats<HD>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(Sq / kTile, H, B);
  flash_fwd_kernel<T, HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, H, KV, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int H, int KV, int hd, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 8: return launch_hd<T, 8>(q, k, v, out, B, Sq, Sk, H, KV, scale, s);
    case 16: return launch_hd<T, 16>(q, k, v, out, B, Sq, Sk, H, KV, scale, s);
    case 32: return launch_hd<T, 32>(q, k, v, out, B, Sq, Sk, H, KV, scale, s);
    case 64: return launch_hd<T, 64>(q, k, v, out, B, Sq, Sk, H, KV, scale, s);
    case 128: return launch_hd<T, 128>(q, k, v, out, B, Sq, Sk, H, KV, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---- bf16: tensor cores -------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kWarps = 4;    // 16 query rows each
constexpr int kKvStages = 2;  // K/V tiles in the cp.async ring

template <int HD>
struct MmaTile {
  static constexpr int HDP = HD < 16 ? 16 : HD;  // Q/K row, padded to k16
  static constexpr int QK_STRIDE = HDP + 8;      // elements, +16 bytes
  static constexpr int V_STRIDE = HD + 8;
  static constexpr int Q_ELEMS = kTile * QK_STRIDE;
  static constexpr int K_ELEMS = kTile * QK_STRIDE;
  static constexpr int V_ELEMS = kTile * V_STRIDE;
  static constexpr int BYTES =
      2 * (Q_ELEMS + kKvStages * (K_ELEMS + V_ELEMS));
};

template <int HD>
__global__ void __launch_bounds__(kWarps * 32)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out, int Sq,
                 int Sk, int H, int KV, float scale) {
  using C = MmaTile<HD>;
  constexpr int NS = kKvStages;
  constexpr int NT = kWarps * 32;      // threads
  constexpr int KSTEPS = C::HDP / 16;  // k16 steps of QK^T
  constexpr int DBLK = HD / 8;         // n8 blocks of the output
  constexpr int CH = HD / 8;           // 16-byte chunks in a global row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [64][QK_STRIDE]
  bf16* Ks = Qs + C::Q_ELEMS;                    // [NS][64][QK_STRIDE]
  bf16* Vs = Ks + NS * C::K_ELEMS;               // [NS][64][V_STRIDE]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;  // fragment row within 8
  const int t = lane % 4;  // fragment column pair
  const int qt = gridDim.x - 1 - blockIdx.x;  // largest q tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qt * kTile;
  const long long q_row = static_cast<long long>(H) * HD;
  const long long kv_row = static_cast<long long>(KV) * HD;

  if (HD < 16) {  // zero the pad columns [HD, 16) of Q and the K buffers
    for (int r = tid; r < (1 + NS) * kTile; r += NT)
      *reinterpret_cast<uint4*>(Qs + r * C::QK_STRIDE + HD) =
          make_uint4(0, 0, 0, 0);
  }
  const bf16* qb = q + (static_cast<long long>(b) * Sq + q0) * q_row + h * HD;
  for (int e = tid; e < kTile * CH; e += NT) {
    const int r = e / CH, c = e % CH;
    hopper::cp_async16(Qs + r * C::QK_STRIDE + 8 * c, qb + r * q_row + 8 * c);
  }
  auto load_kv = [&](int kt, int buf) {
    const long long base = (static_cast<long long>(b) * Sk + kt * kTile) *
                               kv_row + static_cast<long long>(kvh) * HD;
    bf16* kd = Ks + buf * C::K_ELEMS;
    bf16* vd = Vs + buf * C::V_ELEMS;
    for (int e = tid; e < kTile * CH; e += NT) {
      const int r = e / CH, c = e % CH;
      hopper::cp_async16(kd + r * C::QK_STRIDE + 8 * c,
                         k + base + r * kv_row + 8 * c);
      hopper::cp_async16(vd + r * C::V_STRIDE + 8 * c,
                         v + base + r * kv_row + 8 * c);
    }
  };
  const int n_kt = min(Sk / kTile, qt + 1);
  // Group j holds K/V tile j (group 0 also Q); every step commits one group,
  // empty past the last tile, so "at most NS - 1 pending" means tile kt is in.
#pragma unroll
  for (int j = 0; j < NS - 1; ++j) {
    if (j < n_kt) load_kv(j, j);
    hopper::cp_async_commit();
  }

  // Shared addresses of this lane's ldmatrix rows: Q (A fragments), K (B
  // fragments of QK^T, two n8 blocks a load), V (B fragments of PV, trans).
  const uint32_t q_addr = hopper::smem_u32(
      Qs + (warp * 16 + lane % 16) * C::QK_STRIDE + (lane / 16) * 8);
  const uint32_t k_addr = hopper::smem_u32(
      Ks + (lane % 8 + (lane / 16) * 8) * C::QK_STRIDE + ((lane / 8) % 2) * 8);
  const uint32_t v_addr = hopper::smem_u32(
      Vs + (lane % 8 + ((lane / 8) % 2) * 8) * C::V_STRIDE + (lane / 16) * 8);
  // exp(scale * (s - m)) = 2^(s * c - m * c): max and masking on the raw
  // scores (scale > 0), one FFMA and one SFU op a score.
  const float c = scale * 1.4426950408889634f;

  uint32_t qf[KSTEPS][4];
  float o[DBLK][4];
#pragma unroll
  for (int d = 0; d < DBLK; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  float m[2] = {kNeg, kNeg};  // raw-score max of rows g and g + 8
  float l[2] = {0.f, 0.f};    // this lane's part of the row sums

  const int row0 = q0 + warp * 16 + g;
  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + NS - 1 < n_kt) load_kv(kt + NS - 1, (kt + NS - 1) % NS);
    hopper::cp_async_commit();
    hopper::cp_async_wait<NS - 1>();
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks)
        hopper::ldmatrix_x4(qf[ks], q_addr + ks * 32);
    }

    // S (16 x 64 per warp) = Q K^T, eight n8 blocks of keys.
    const uint32_t kb = k_addr + (kt % NS) * C::K_ELEMS * 2;
    float s[8][4];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
#pragma unroll
      for (int nb2 = 0; nb2 < 4; ++nb2) {
        uint32_t kf[4];
        hopper::ldmatrix_x4(kf, kb + (nb2 * 16 * C::QK_STRIDE + ks * 16) * 2);
        hopper::mma_16816_bf16(s[2 * nb2], qf[ks], kf[0], kf[1]);
        hopper::mma_16816_bf16(s[2 * nb2 + 1], qf[ks], kf[2], kf[3]);
      }
    }

    // Mask (the diagonal tile only), online softmax.
    const int k0 = kt * kTile;
    if (k0 + kTile > q0) {
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + nb * 8 + 2 * t + (e & 1) > row0 + 8 * (e / 2))
            s[nb][e] = kNeg;
    }
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], s[nb][e]);
    float corr[2], mc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = hopper::ex2_approx((m[r] - m_new) * c);
      m[r] = m_new;
      mc[r] = -m_new * c;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = hopper::ex2_approx(__fmaf_rn(s[nb][e], c, mc[e / 2]));
        sum[e / 2] += p;
        s[nb][e] = p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
#pragma unroll
    for (int d = 0; d < DBLK; ++d) {
      o[d][0] *= corr[0];
      o[d][1] *= corr[0];
      o[d][2] *= corr[1];
      o[d][3] *= corr[1];
    }

    // O += P V: p rounded to bf16 as the A fragment, 16 keys a step.
    const uint32_t vb = v_addr + (kt % NS) * C::V_ELEMS * 2;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      const uint32_t pa[4] = {
          hopper::pack_bf16(s[2 * kc][0], s[2 * kc][1]),
          hopper::pack_bf16(s[2 * kc][2], s[2 * kc][3]),
          hopper::pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
          hopper::pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
      const uint32_t vrow = vb + kc * 16 * C::V_STRIDE * 2;
      if constexpr (DBLK == 1) {
        uint32_t vf[2];
        hopper::ldmatrix_x2_trans(vf, vrow);
        hopper::mma_16816_bf16(o[0], pa, vf[0], vf[1]);
      } else {
#pragma unroll
        for (int d2 = 0; d2 < DBLK / 2; ++d2) {
          uint32_t vf[4];
          hopper::ldmatrix_x4_trans(vf, vrow + d2 * 32);
          hopper::mma_16816_bf16(o[2 * d2], pa, vf[0], vf[1]);
          hopper::mma_16816_bf16(o[2 * d2 + 1], pa, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();  // this buffer is refilled by a later iteration
  }

  float denom[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    denom[r] = fmaxf(l[r], 1e-30f);
  }
  bf16* ob = out + (static_cast<long long>(b) * Sq + row0) * q_row + h * HD +
             2 * t;
#pragma unroll
  for (int d = 0; d < DBLK; ++d) {
    *reinterpret_cast<__nv_bfloat162*>(ob + 8 * d) =
        __floats2bfloat162_rn(o[d][0] / denom[0], o[d][1] / denom[0]);
    *reinterpret_cast<__nv_bfloat162*>(ob + 8 * q_row + 8 * d) =
        __floats2bfloat162_rn(o[d][2] / denom[1], o[d][3] / denom[1]);
  }
}

template <int HD>
int launch_mma_hd(const void* q, const void* k, const void* v, void* out,
                  int B, int Sq, int Sk, int H, int KV, float scale,
                  cudaStream_t stream) {
  constexpr int bytes = MmaTile<HD>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_mma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(Sq / kTile, H, B);
  flash_mma_kernel<HD><<<grid, kWarps * 32, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), Sq, Sk, H, KV,
      scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16(const void* q, const void* k, const void* v, void* out, int B,
                int Sq, int Sk, int H, int KV, int hd, float scale,
                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 8: return launch_mma_hd<8>(q, k, v, out, B, Sq, Sk, H, KV, scale, s);
    case 16: return launch_mma_hd<16>(q, k, v, out, B, Sq, Sk, H, KV, scale, s);
    case 32: return launch_mma_hd<32>(q, k, v, out, B, Sq, Sk, H, KV, scale, s);
    case 64: return launch_mma_hd<64>(q, k, v, out, B, Sq, Sk, H, KV, scale, s);
    case 128:
      return launch_mma_hd<128>(q, k, v, out, B, Sq, Sk, H, KV, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the CUDA error code (0 on success).  The caller
// guarantees contiguous operands of the layout above, Sq and Sk multiples of
// 64, H a multiple of KV, hd in {8, 16, 32, 64, 128}; for bf16 also
// 16-byte-aligned base pointers (cp.async moves 16 bytes at a time).
int flash_attention_f32(const void* q, const void* k, const void* v, void* out,
                        int B, int Sq, int Sk, int H, int KV, int hd,
                        float scale, void* stream) {
  return launch<float>(q, k, v, out, B, Sq, Sk, H, KV, hd, scale, stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                         int B, int Sq, int Sk, int H, int KV, int hd,
                         float scale, void* stream) {
  return launch_bf16(q, k, v, out, B, Sq, Sk, H, KV, hd, scale, stream);
}

}  // extern "C"
