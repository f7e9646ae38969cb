// Block-tiled matrix product for Hopper (sm_90a): out = x @ w.
//
// Replaces the Pallas TPU kernel src/repro/kernels/tiled_matmul.py::
// tiled_matmul (body `_matmul_kernel`); the plain PyTorch version is
// `repro_torch.kernels.ref.matmul_ref`.
//
// Layout (row-major, contiguous): x (M, K), w (K, N), out (M, N), one dtype
// (float or bfloat16); the sum is kept in f32 and rounded once to the output
// type (round to nearest even).  The f32 entry is true FP32: the products run
// on the CUDA cores (explicit fmaf), never in TF32.
//
// Design: one CTA per (bm x bn) output block, walking K in steps of bk -- the
// loop inside the block takes the place of the TPU grid's innermost K axis,
// and the accumulator lives in registers instead of a VMEM scratch tile.
// Each thread owns a 4 x 4 block of outputs (rows ty + i * bm/4, columns
// tx + j * bn/4), so the CTA has bm * bn / 16 threads.  The x tile is staged
// transposed ([bk][bm]) and the w tile as is ([bk][bn]) in dynamic shared
// memory, in the input dtype.  bm, bn and bk are run-time values; the
// Python wrapper checks the constraints (`block_is_valid`): divisibility of
// the dims, bm and bn multiples of 4 with a whole number of warps and at most
// 1024 threads, and (bm*bk + bk*bn) * itemsize within the 227 KB a block may
// claim on H100.
//
// Bound: operations for the serve projections (M 8704, K 960 or 2560, N 320
// to 5120: 2MNK = 5.3-86 GFLOP against 7-36 MB), at the bf16 tensor-core
// peak for bf16 and 67 TFLOP/s for f32.  This first kernel uses the CUDA
// cores and no cp.async/TMA pipelining, so it sits well above that bound;
// the wgmma version is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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

template <typename T>
__global__ void __launch_bounds__(1024)
tiled_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    T* __restrict__ out, int M, int N, int K, int bm, int bn,
                    int bk) {
  extern __shared__ unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);  // [bk][bm]
  T* Bs = As + bm * bk;                     // [bk][bn]

  const int tcols = bn / 4;
  const int trows = bm / 4;
  const int nthreads = blockDim.x;
  const int tid = threadIdx.x;
  const int tx = tid % tcols;
  const int ty = tid / tcols;
  const long long m0 = static_cast<long long>(blockIdx.y) * bm;
  const long long n0 = static_cast<long long>(blockIdx.x) * bn;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += bk) {
    for (int e = tid; e < bm * bk; e += nthreads) {
      const int r = e / bk, c = e % bk;
      As[c * bm + r] = x[(m0 + r) * K + k0 + c];
    }
    for (int e = tid; e < bk * bn; e += nthreads) {
      const int r = e / bn, c = e % bn;
      Bs[r * bn + c] = w[static_cast<long long>(k0 + r) * N + n0 + c];
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < bk; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = to_f(As[kk * bm + ty + i * trows]);
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = to_f(Bs[kk * bn + tx + j * tcols]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[(m0 + ty + i * trows) * N + n0 + tx + j * tcols] =
          from_f<T>(acc[i][j]);
}

template <typename T>
int launch(const void* x, const void* w, void* out, int M, int N, int K,
           int bm, int bn, int bk, void* stream) {
  const int bytes = (bm * bk + bk * bn) * static_cast<int>(sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      tiled_matmul_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(N / bn, M / bm);
  tiled_matmul_kernel<T><<<grid, bm * bn / 16, bytes,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out),
      M, N, K, bm, bn, bk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the CUDA error code (0 on success).  The caller
// guarantees contiguous operands and a block shape that `block_is_valid`
// accepts for (M, K, N).
int tiled_matmul_f32(const void* x, const void* w, void* out, int M, int N,
                     int K, int bm, int bn, int bk, void* stream) {
  return launch<float>(x, w, out, M, N, K, bm, bn, bk, stream);
}

int tiled_matmul_bf16(const void* x, const void* w, void* out, int M, int N,
                      int K, int bm, int bn, int bk, void* stream) {
  return launch<__nv_bfloat16>(x, w, out, M, N, K, bm, bn, bk, stream);
}

}  // extern "C"
