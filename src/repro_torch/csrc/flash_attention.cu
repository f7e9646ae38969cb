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
//
// Design: one CTA of 256 threads (16 x 16) per (64-row q tile, query head,
// batch).  Q, K and V tiles are staged in shared memory as f32 (exact for
// bf16 inputs); each thread holds a 4 x 4 block of the 64 x 64 score tile
// (rows ty + 16i, columns tx + 16j) and the matching 4 rows of the output
// accumulator, so the running m and l of a row live in the 16 lanes that
// share ty and are reduced with warp shuffles.  K and Q rows are padded by
// one float so the 16 lanes reading 16 different key rows hit 16 banks.
// Products run on the CUDA cores in f32 (explicit fmaf), not the tensor
// cores: this is the simple first kernel.
//
// Tiles above the diagonal are skipped.  That is exact: the k tile at 0 is
// never fully masked for any query row (key 0 is visible to every query), so
// m is finite after the first tile, and a fully masked tile would add
// exp(-1e30 - m) = 0 to l and to acc with corr = exp(0) = 1.
//
// Bound: operations.  At the serve prefill shape (B 8, S 1088, H 15, hd 64)
// the causal work is ~2 * B * H * S^2 * hd = 18 GFLOP against 45 MB of
// q, k, v and out: at the bf16 tensor-core peak that is ~18 us, above the
// ~13 us the bytes take at 3.35 TB/s.  This kernel runs on the f32 CUDA cores, so it sits
// well above that bound; the tensor-core (wgmma) version is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;      // q rows and k columns per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
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

}  // namespace

extern "C" {

// Launch on `stream`; returns the CUDA error code (0 on success).  The caller
// guarantees contiguous operands of the layout above, Sq and Sk multiples of
// 64, H a multiple of KV, hd in {8, 16, 32, 64, 128}.
int flash_attention_f32(const void* q, const void* k, const void* v, void* out,
                        int B, int Sq, int Sk, int H, int KV, int hd,
                        float scale, void* stream) {
  return launch<float>(q, k, v, out, B, Sq, Sk, H, KV, hd, scale, stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                         int B, int Sq, int Sk, int H, int KV, int hd,
                         float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, H, KV, hd, scale,
                               stream);
}

}  // extern "C"
