// Causal GQA flash-attention backward for Hopper (sm_90a): dQ, dK and dV of
// K3 (flash_attention.cu), from its saved output and log-sum-exp.
//
// The reference has no backward TPU kernel: it trains through `flash_sdpa`
// (src/repro/models/layers.py), whose online softmax `jax.value_and_grad`
// differentiates with P recomputed in the backward pass (a jax.checkpoint on
// each k step).  This file computes the same gradient for the port's K3.  Its
// plain PyTorch version is `repro_torch.kernels.ref.flash_attention_bwd_ref`.
//
// Layout (row-major, contiguous), as K3's: q, out, dout, dq (B, Sq, H, hd);
// k, v, dk, dv (B, Sk, KV, hd); lse and the scratch delta f32 (B, H, Sq).  H
// = g * KV, query head h reads KV head h / g.  Sq and Sk are multiples of 64
// and hd one of {8, 16, 32, 64, 128, 160} (the wrapper pads, as for K3); key
// j is visible to query i when j <= i and j < sk_valid.
//
// The FlashAttention-2 equations, deterministic, with no atomics:
//   P  = exp(scale * Q K^T - lse)   (0 where masked)
//   D  = rowsum(dO o O)
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - D)
//   dK = scale * dS^T Q,  dQ = scale * dS K
// Three kernels, one launch each:
//   1. `flash_bwd_delta_kernel`: D, one warp a (row, head).
//   2. `flash_bwd_dkdv_kernel`: one CTA of 256 threads per (64-key tile, KV
//      head, batch).  K and V stay in shared memory; the CTA walks the g
//      query heads of its KV head and, for each, the 64-row q tiles from the
//      diagonal down, recomputing P and dP there and adding P^T dO and dS^T Q
//      into dV and dK held in registers.  GQA's sum over the g heads and the
//      sum over q tiles stay inside the CTA, in one fixed order.
//   3. `flash_bwd_dq_kernel`: one CTA per (64-row q tile, query head, batch)
//      over the k tiles up to the diagonal, recomputing P and dP and adding
//      dS K into dQ in registers.
// Every product accumulates in f32 by explicit fmaf (true FP32 on the CUDA
// cores, never TF32; the library is built with -fmad=false); operands of
// either I/O type (f32 or bf16) are widened to f32 as they enter shared
// memory and the gradients are rounded once to that type at the end.
//
// Tiles and threads.  A [64][64] score tile gives each thread 4 rows (ty +
// 16 i) x 4 keys (tx + 16 j), so S and dP come from one loop over d that
// reads 4 q, 4 dO, 4 K and 4 V values for 32 FMAs: the q and dO rows are the
// same for the 16 lanes of a half-warp (broadcasts), and the K and V rows
// are 16 distinct rows whose stride hd + 1 (odd) puts them in 16 banks.  A
// [64][hd] accumulator gives each thread RM rows (ry + NRG i) x CM columns
// (cx + NCG j): NCG = 16 column groups (8 at hd 8), so the columns a warp
// reads are consecutive.  P and dS are stored [q][k] with rows of 80 floats,
// so the two row groups of a warp's stores land in opposite halves of the
// banks.  At hd 160, K, V, Q and dO ([64][161] f32 each), P, dS ([64][80])
// and the tile's lse and D take 206,336 bytes of the 232,448 a CTA may use;
// at hd 64 108,032, two CTAs an SM.
//
// Bound: operations.  The minimum is five causal products (QK^T, dO V^T,
// P^T dO, dS^T Q, dS K), 5 * 2 * B * H * (S^2 / 2) * hd flops; this design
// does seven (the dQ kernel recomputes QK^T and dO V^T).  At the train shape
// (B 8, S 1024, H 15, hd 64) that is 40 GFLOP, 0.60 ms at the f32 CUDA-core
// peak (67 TFLOP/s) against ~0.03 ms for its ~100 MB of operands.  This
// simple design is bound by its shared-memory reads (one 4-byte LDS per two
// FMAs in the score loop); the tensor cores (mma.sync / wgmma on the
// forward's fragments) are the next step (ROADMAP.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;      // q rows and keys of a tile
constexpr int kThreads = 256;  // threads of the dK/dV and dQ kernels
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int HD>
struct BwdTile {
  static constexpr int ROW = HD + 1;      // a [64][HD] tile's row, padded
  static constexpr int T = kTile * ROW;   // floats of one such tile
  static constexpr int PROW = kTile + 16;  // a [64][64] P or dS tile's row
  static constexpr int P = kTile * PROW;
  static constexpr int NCG = HD >= 16 ? 16 : HD;  // accumulator column groups
  static constexpr int CM = HD / NCG;             // columns a thread
  static constexpr int NRG = kThreads / NCG;      // row groups
  static constexpr int RM = kTile / NRG;          // rows a thread
  // dK/dV: K, V, Q, dO, P, dS, lse, D.  dQ: Q, dO, K, V, dS, lse, D.
  static constexpr int DKDV_BYTES = 4 * (4 * T + 2 * P + 2 * kTile);
  static constexpr int DQ_BYTES = 4 * (4 * T + P + 2 * kTile);
  // Two CTAs an SM where both fit (hd <= 64: 2 x 108 KB, <= 128 registers).
  static constexpr int MIN_CTAS = HD <= 64 ? 2 : 1;
  static_assert(NRG * NCG == kThreads && RM * NRG == kTile, "micro tiles");
};

// A [64][HD] tile of rows `stride` elements apart, widened to f32 into rows
// of HD + 1 floats.  Consecutive threads read consecutive columns.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long stride) {
  for (int e = threadIdx.x; e < kTile * HD; e += kThreads) {
    const int r = e / HD, c = e % HD;
    dst[r * (HD + 1) + c] = to_f32(src[r * stride + c]);
  }
}

// The 64 rows' lse (times log2 e) and D of query head h, rows q0..q0+63.
__device__ __forceinline__ void load_rows(float* ls, float* ds,
                                          const float* lse, const float* delta,
                                          long long at) {
  if (threadIdx.x < kTile) {
    ls[threadIdx.x] = lse[at + threadIdx.x] * kLog2e;
    ds[threadIdx.x] = delta[at + threadIdx.x];
  }
}

// P and dS of one (q tile, k tile) pair at this thread's 4 x 4 scores: S =
// Q K^T and dP = dO V^T in one loop over d, then P = 2^(s c - lse log2 e)
// under the causal and sk_valid masks, dS = P (dP - D).
template <int HD>
__device__ __forceinline__ void p_and_ds(float (&p)[4][4], float (&ds)[4][4],
                                         const float* Qs, const float* dOs,
                                         const float* Ks, const float* Vs,
                                         const float* Ls, const float* Ds,
                                         int q0, int k0, int sk_valid,
                                         float c) {
  constexpr int R = HD + 1;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float a[4], o[4], kk[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = Qs[(ty + 16 * i) * R + d];
      o[i] = dOs[(ty + 16 * i) * R + d];
      kk[i] = Ks[(tx + 16 * i) * R + d];
      vv[i] = Vs[(tx + 16 * i) * R + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i], kk[j], s[i][j]);
        dp[i][j] = fmaf(o[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty + 16 * i;
    const float nl = -Ls[row], dd = Ds[row];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + tx + 16 * j;
      const bool seen = key <= q0 + row && key < sk_valid;
      p[i][j] = seen ? exp2f(fmaf(s[i][j], c, nl)) : 0.f;
      ds[i][j] = p[i][j] * (dp[i][j] - dd);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                       float* __restrict__ delta, int rows, int Sq, int H,
                       int hd) {
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (r >= rows) return;
  const T* o = out + static_cast<long long>(r) * hd;
  const T* g = dout + static_cast<long long>(r) * hd;
  float sum = 0.f;
  for (int d = lane; d < hd; d += 32) sum = fmaf(to_f32(o[d]), to_f32(g[d]), sum);
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) {
    const int h = r % H;
    const long long bi = r / H;  // b * Sq + i
    const long long b = bi / Sq, i = bi % Sq;
    delta[(b * H + h) * Sq + i] = sum;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, BwdTile<HD>::MIN_CTAS)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int Sq, int Sk, int sk_valid, int H,
                      int KV, float scale) {
  using C = BwdTile<HD>;
  constexpr int R = C::ROW, PR = C::PROW, NCG = C::NCG, NRG = C::NRG;
  constexpr int CM = C::CM, RM = C::RM;
  extern __shared__ float4 bwd_smem[];
  float* Ks = reinterpret_cast<float*>(bwd_smem);
  float* Vs = Ks + C::T;
  float* Qs = Vs + C::T;
  float* dOs = Qs + C::T;
  float* Ps = dOs + C::T;
  float* dSs = Ps + C::P;
  float* Ls = dSs + C::P;
  float* Ds = Ls + kTile;

  const int tid = threadIdx.x;
  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * kTile;
  const int g = H / KV;
  const long long q_row = static_cast<long long>(H) * HD;
  const long long kv_row = static_cast<long long>(KV) * HD;
  const long long kv_at = (static_cast<long long>(b) * Sk + k0) * kv_row +
                          static_cast<long long>(kvh) * HD;
  load_tile<T, HD>(Ks, k + kv_at, kv_row);
  load_tile<T, HD>(Vs, v + kv_at, kv_row);

  const int ty = tid / 16, tx = tid % 16;     // score micro tile
  const int ry = tid / NCG, cx = tid % NCG;   // accumulator micro tile
  float dka[RM][CM], dva[RM][CM];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < CM; ++j) dka[i][j] = dva[i][j] = 0.f;
  const float c = scale * kLog2e;
  // Query rows from k0 on see this tile; none does past the last true key.
  const int qt_end = k0 < sk_valid ? Sq / kTile : kt;

  for (int hh = 0; hh < g; ++hh) {
    const int h = kvh * g + hh;
    for (int qt = kt; qt < qt_end; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();  // the previous tile's Q, dO, P and dS are consumed
      const long long q_at = (static_cast<long long>(b) * Sq + q0) * q_row +
                             static_cast<long long>(h) * HD;
      load_tile<T, HD>(Qs, q + q_at, q_row);
      load_tile<T, HD>(dOs, dout + q_at, q_row);
      load_rows(Ls, Ds, lse, delta, (static_cast<long long>(b) * H + h) * Sq + q0);
      __syncthreads();

      float p[4][4], ds[4][4];
      p_and_ds<HD>(p, ds, Qs, dOs, Ks, Vs, Ls, Ds, q0, k0, sk_valid, c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          Ps[(ty + 16 * i) * PR + tx + 16 * j] = p[i][j];
          dSs[(ty + 16 * i) * PR + tx + 16 * j] = ds[i][j];
        }
      __syncthreads();

      // dV += P^T dO and dK += dS^T Q over the tile's 64 query rows.
#pragma unroll 4
      for (int r = 0; r < kTile; ++r) {
        float pr[RM], sr[RM], o[CM], a[CM];
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          pr[i] = Ps[r * PR + ry + NRG * i];
          sr[i] = dSs[r * PR + ry + NRG * i];
        }
#pragma unroll
        for (int j = 0; j < CM; ++j) {
          o[j] = dOs[r * R + cx + NCG * j];
          a[j] = Qs[r * R + cx + NCG * j];
        }
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < CM; ++j) {
            dva[i][j] = fmaf(pr[i], o[j], dva[i][j]);
            dka[i][j] = fmaf(sr[i], a[j], dka[i][j]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const long long at = kv_at + (ry + NRG * i) * kv_row;
#pragma unroll
    for (int j = 0; j < CM; ++j) {
      dk[at + cx + NCG * j] = from_f32<T>(dka[i][j] * scale);
      dv[at + cx + NCG * j] = from_f32<T>(dva[i][j]);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, BwdTile<HD>::MIN_CTAS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int Sq, int Sk, int sk_valid, int H, int KV, float scale) {
  using C = BwdTile<HD>;
  constexpr int R = C::ROW, PR = C::PROW, NCG = C::NCG, NRG = C::NRG;
  constexpr int CM = C::CM, RM = C::RM;
  extern __shared__ float4 bwd_smem[];
  float* Qs = reinterpret_cast<float*>(bwd_smem);
  float* dOs = Qs + C::T;
  float* Ks = dOs + C::T;
  float* Vs = Ks + C::T;
  float* dSs = Vs + C::T;
  float* Ls = dSs + C::P;
  float* Ds = Ls + kTile;

  const int tid = threadIdx.x;
  const int qt = gridDim.x - 1 - blockIdx.x;  // most k tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kTile;
  const int kvh = h / (H / KV);
  const long long q_row = static_cast<long long>(H) * HD;
  const long long kv_row = static_cast<long long>(KV) * HD;
  const long long q_at = (static_cast<long long>(b) * Sq + q0) * q_row +
                         static_cast<long long>(h) * HD;
  load_tile<T, HD>(Qs, q + q_at, q_row);
  load_tile<T, HD>(dOs, dout + q_at, q_row);
  load_rows(Ls, Ds, lse, delta, (static_cast<long long>(b) * H + h) * Sq + q0);

  const int ty = tid / 16, tx = tid % 16;
  const int ry = tid / NCG, cx = tid % NCG;
  float acc[RM][CM];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < CM; ++j) acc[i][j] = 0.f;
  const float c = scale * kLog2e;
  // k tiles up to the diagonal and up to the last true key.
  const int n_kt = min(min(Sk / kTile, qt + 1), (sk_valid + kTile - 1) / kTile);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's K and dS are consumed
    const long long kv_at = (static_cast<long long>(b) * Sk + k0) * kv_row +
                            static_cast<long long>(kvh) * HD;
    load_tile<T, HD>(Ks, k + kv_at, kv_row);
    load_tile<T, HD>(Vs, v + kv_at, kv_row);
    __syncthreads();

    float p[4][4], ds[4][4];
    p_and_ds<HD>(p, ds, Qs, dOs, Ks, Vs, Ls, Ds, q0, k0, sk_valid, c);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dSs[(ty + 16 * i) * PR + tx + 16 * j] = ds[i][j];
    __syncthreads();

    // dQ += dS K over the tile's 64 keys.
#pragma unroll 4
    for (int key = 0; key < kTile; ++key) {
      float sr[RM], kk[CM];
#pragma unroll
      for (int i = 0; i < RM; ++i) sr[i] = dSs[(ry + NRG * i) * PR + key];
#pragma unroll
      for (int j = 0; j < CM; ++j) kk[j] = Ks[key * R + cx + NCG * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CM; ++j) acc[i][j] = fmaf(sr[i], kk[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const long long at = q_at + (ry + NRG * i) * q_row;
#pragma unroll
    for (int j = 0; j < CM; ++j)
      dq[at + cx + NCG * j] = from_f32<T>(acc[i][j] * scale);
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

template <typename T, int HD>
int launch_hd(const T* q, const T* k, const T* v, const T* out, const T* dout,
              const float* lse, float* delta, T* dq, T* dk, T* dv, int B,
              int Sq, int Sk, int sk_valid, int H, int KV, float scale,
              cudaStream_t stream) {
  using C = BwdTile<HD>;
  cudaError_t err = allow_smem(flash_bwd_dkdv_kernel<T, HD>, C::DKDV_BYTES);
  if (err == cudaSuccess)
    err = allow_smem(flash_bwd_dq_kernel<T, HD>, C::DQ_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = B * Sq * H;
  constexpr int warps = kThreads / 32;
  flash_bwd_delta_kernel<T><<<(rows + warps - 1) / warps, kThreads, 0, stream>>>(
      out, dout, delta, rows, Sq, H, HD);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_kernel<T, HD>
      <<<dim3(Sk / kTile, KV, B), kThreads, C::DKDV_BYTES, stream>>>(
          q, k, v, dout, lse, delta, dk, dv, Sq, Sk, sk_valid, H, KV, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<T, HD>
      <<<dim3(Sq / kTile, H, B), kThreads, C::DQ_BYTES, stream>>>(
          q, k, v, dout, lse, delta, dq, Sq, Sk, sk_valid, H, KV, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const void* lse, void* delta, void* dq, void* dk,
           void* dv, int B, int Sq, int Sk, int sk_valid, int H, int KV, int hd,
           float scale, void* stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* ot = static_cast<const T*>(out);
  const T* gt = static_cast<const T*>(dout);
  const float* lf = static_cast<const float*>(lse);
  float* df = static_cast<float*>(delta);
  T* dqt = static_cast<T*>(dq);
  T* dkt = static_cast<T*>(dk);
  T* dvt = static_cast<T*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K3_BWD(HD)                                                           \
  case HD:                                                                   \
    return launch_hd<T, HD>(qt, kt, vt, ot, gt, lf, df, dqt, dkt, dvt, B, Sq, \
                            Sk, sk_valid, H, KV, scale, s)
  switch (hd) {
    K3_BWD(8);
    K3_BWD(16);
    K3_BWD(32);
    K3_BWD(64);
    K3_BWD(128);
    K3_BWD(160);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef K3_BWD
}

}  // namespace

extern "C" {

// Launch the three kernels on `stream`; returns the CUDA error code (0 on
// success).  The caller guarantees contiguous operands of the layout above,
// Sq and Sk multiples of 64, Sk - 64 < sk_valid <= Sk, H a multiple of KV,
// hd in {8, 16, 32, 64, 128, 160}; `lse` as K3 wrote it, `delta` an f32
// (B, H, Sq) scratch buffer the first kernel fills.
int flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                            const void* out, const void* dout, const void* lse,
                            void* delta, void* dq, void* dk, void* dv, int B,
                            int Sq, int Sk, int sk_valid, int H, int KV, int hd,
                            float scale, void* stream) {
  return launch<float>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, Sq, Sk,
                       sk_valid, H, KV, hd, scale, stream);
}

int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                             const void* out, const void* dout,
                             const void* lse, void* delta, void* dq, void* dk,
                             void* dv, int B, int Sq, int Sk, int sk_valid,
                             int H, int KV, int hd, float scale,
                             void* stream) {
  return launch<bf16>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, Sq, Sk,
                      sk_valid, H, KV, hd, scale, stream);
}

// Dynamic shared memory of a CTA of the dK/dV kernel (`dq` zero) or of the
// dQ kernel (`dq` nonzero) at head dim `hd`; -1 for an hd not compiled.
int flash_attention_bwd_smem_bytes(int hd, int dq) {
  switch (hd) {
#define K3_BWD_SMEM(HD) \
  case HD: return dq ? BwdTile<HD>::DQ_BYTES : BwdTile<HD>::DKDV_BYTES
    K3_BWD_SMEM(8);
    K3_BWD_SMEM(16);
    K3_BWD_SMEM(32);
    K3_BWD_SMEM(64);
    K3_BWD_SMEM(128);
    K3_BWD_SMEM(160);
#undef K3_BWD_SMEM
    default: return -1;
  }
}

}  // extern "C"
