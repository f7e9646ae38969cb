// Block-tiled matrix product for Hopper (sm_90a): out = x @ w.
//
// Replaces the Pallas TPU kernel src/repro/kernels/tiled_matmul.py::
// tiled_matmul (body `_matmul_kernel`); the plain PyTorch version is
// `repro_torch.kernels.ref.matmul_ref`.
//
// Layout (row-major, contiguous): x (M, K), w (K, N), out (M, N), one dtype
// (float or bfloat16); the sum is kept in f32 and rounded once to the output
// type (round to nearest even).
//
// Bound: operations for the serve projections (M 8704, K 960 or 2560, N 320
// to 5120: 2MNK = 5.3-86 GFLOP against 7-36 MB), at the bf16 tensor-core
// peak for bf16 and 67 TFLOP/s for f32.  Two designs, one per dtype:
//
// bf16 -- `wgmma_tma_kernel`, the tensor cores fed by TMA.  One CTA per
// (BM x BN) output block, BM = 64 * NWG (one wgmma m64 row band per consumer
// warpgroup, NWG in {1, 2}), BN in {64, 128, 256}, walking K in steps of bk
// (a multiple of 64, one 128-byte swizzle row of bf16).  One producer warp
// issues TMA loads (`cp.async.bulk.tensor.2d`) of the x and w tiles into a
// ring of kStages stages in dynamic shared memory, each with a full and an
// empty mbarrier; the consumer warpgroups run `wgmma.mma_async m64nBNk16`
// on the stages that have arrived, keep the f32 accumulator in registers,
// and release a stage once `wgmma.wait_group 1` shows its products done.
// x tiles are K-major (rows of 64 k at 128 bytes, swizzled); w is (K, N)
// row-major, so its tiles are MN-major: TMA boxes of 64 n x bk k, one box
// per 64 columns, read by wgmma with the transpose bit set for B.  The
// epilogue rounds once to bf16 into the drained ring, in the 128-byte
// swizzled layout of 64-column boxes (no bank conflicts), and TMA stores the
// boxes whole instead of writing 16 bytes of 8 rows a warp store from
// registers.  Tensor maps are encoded on the host with
// cuTensorMapEncodeTiled, fetched through cudaGetDriverEntryPoint (no
// -lcuda), and passed as __grid_constant__.
//
// f32 -- `sgemm_8x8_kernel`, true FP32 on the CUDA cores (explicit fmaf,
// never TF32; the sums run in k order).  The classic register-tiled SGEMM:
// one CTA per (BM x BN) block, BM, BN in {64, 128}, BM * BN / 64 threads,
// each owning 8 x 8 outputs as two 4-row halves (rows 4 ty + i and BM/2 +
// 4 ty + i) by two 4-column halves (columns 4 tx + j and BN/2 + 4 tx + j);
// a warp is 4 ty x 8 tx, so each quarter-warp's LDS.128 of w reads 128
// contiguous bytes (all 32 banks once) and its LDS.128 of x one broadcast
// address.  A k step of one thread is 4 LDS.128 for 64 FFMA, so the loop is
// bound by FMA issue, not by shared memory.  The x tile is staged transposed
// (As[bk][bm]): read from global as float4 along k into registers, stored
// as four scalars (a warp's lanes on 32 neighbouring rows m, so the stores
// hit 32 banks); the w tile goes in as it is (Bs[bk][bn]) by 16-byte
// cp.async.  Two stages in dynamic shared memory and one __syncthreads a k
// step: tile k+1's loads are in flight while tile k computes.  The epilogue
// stores float4 runs of 4 columns straight from registers.
//
// The Python wrapper checks each design's constraints (`block_is_valid`).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kStages = 4;       // TMA ring depth of the bf16 kernel
constexpr int kSwizzleRow = 64;  // bf16 values in one 128-byte swizzle row

template <int BN>
__device__ __forceinline__ void wgmma_k16(float (&acc)[BN / 2], uint64_t da,
                                          uint64_t db);
template <>
__device__ __forceinline__ void wgmma_k16<64>(float (&acc)[32], uint64_t da,
                                              uint64_t db) {
  hopper::wgmma_m64n64k16_bf16(acc, da, db);
}
template <>
__device__ __forceinline__ void wgmma_k16<128>(float (&acc)[64], uint64_t da,
                                               uint64_t db) {
  hopper::wgmma_m64n128k16_bf16(acc, da, db);
}
template <>
__device__ __forceinline__ void wgmma_k16<256>(float (&acc)[128], uint64_t da,
                                               uint64_t db) {
  hopper::wgmma_m64n256k16_bf16(acc, da, db);
}

// Shared memory of one bf16 CTA: the ring, its 2 * kStages barriers, and
// 1 KB of slack to align the ring to the 1024-byte swizzle atom.
__host__ __device__ constexpr int wgmma_smem_bytes(int bm, int bk, int bn) {
  return kStages * (bm * bk + bk * bn) * 2 + 2 * kStages * 8 + 1024;
}

template <int NWG, int BN>
__global__ void __launch_bounds__(NWG * 128 + 32)
wgmma_tma_kernel(const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap wmap,
                 const __grid_constant__ CUtensorMap omap, int K, int bk) {
  constexpr int BM = 64 * NWG;
  extern __shared__ unsigned char smem_raw[];
  // The ring starts on a 1024-byte boundary of the shared window.
  unsigned char* smem =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  const int a_bytes = BM * bk * 2;   // bk / 64 boxes of BM rows x 128 B
  const int b_bytes = bk * BN * 2;   // BN / 64 boxes of bk rows x 128 B
  const int stage_bytes = a_bytes + b_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * stage_bytes);
  uint64_t* empty = full + kStages;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_kt = K / bk;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], NWG);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp == NWG * 4) {
    // Producer warp: one lane keeps up to kStages tiles in flight.
    if (lane == 0) {
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) hopper::mbar_wait(&empty[s], (kt / kStages - 1) & 1);
        hopper::mbar_arrive_expect_tx(&full[s], stage_bytes);
        unsigned char* a = smem + s * stage_bytes;
        unsigned char* b = a + a_bytes;
        const int k0 = kt * bk;
        for (int j = 0; j < bk / kSwizzleRow; ++j)
          hopper::tma_load_2d(a + j * BM * 128, &xmap, &full[s],
                              k0 + j * kSwizzleRow, m0);
        for (int j = 0; j < BN / kSwizzleRow; ++j)
          hopper::tma_load_2d(b + j * bk * 128, &wmap, &full[s],
                              n0 + j * kSwizzleRow, k0);
      }
    }
    return;
  }

  // Consumer warpgroup wg owns rows [64 wg, 64 wg + 64) of the block.
  const int wg = warp / 4;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  // A (x, K-major): 8-row groups 1024 B apart (SBO); the k16 step moves 32 B
  // along the swizzled row, a new 64-k box every 4 steps.  B (w, MN-major):
  // 8-k-row groups 1024 B apart (SBO), 64-column boxes bk * 128 B apart (LBO);
  // the k16 step moves 16 rows, 2048 B.
  const uint32_t lbo_b = static_cast<uint32_t>(bk) * 128;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt % kStages;
    hopper::mbar_wait(&full[s], (kt / kStages) & 1);
    const uint32_t a_base =
        hopper::smem_u32(smem + s * stage_bytes) + wg * 64 * 128;
    const uint32_t b_base = hopper::smem_u32(smem + s * stage_bytes + a_bytes);
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
    for (int kk = 0; kk < bk / 16; ++kk) {
      const uint64_t da = hopper::gmma_desc_sw128(
          a_base + (kk / 4) * BM * 128 + (kk % 4) * 32, 16, 1024);
      const uint64_t db =
          hopper::gmma_desc_sw128(b_base + kk * 2048, lbo_b, 1024);
      wgmma_k16<BN>(acc, da, db);
    }
    hopper::wgmma_commit();
    hopper::fence_regs(acc);
    hopper::wgmma_wait<1>();
    hopper::fence_regs(acc);
    // The previous tile's products are done: hand its stage back.
    if (kt > 0 && threadIdx.x % 128 == 0)
      hopper::mbar_arrive(&empty[(kt - 1) % kStages]);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);

  // Every consumer is done with the ring: it becomes the output tile, BN /
  // 64 boxes of BM rows x 128 bytes, each row's 16-byte chunks swizzled by
  // the row (chunk c at c ^ (row % 8)), as the TMA store's 128B swizzle
  // expects.  Accumulator layout of m64nBN: n8 block j holds (row r, cols
  // 8j + 2(l%4) + {0, 1}) in acc[4j], acc[4j+1] and row r + 8 in acc[4j+2],
  // acc[4j+3], r = 16 * (warp % 4) + l / 4; so the 8 rows of a warp's store
  // land in 8 different chunks and the warp's 32 lanes in 32 banks.
  hopper::named_barrier(1, NWG * 128);
  const int r = wg * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    unsigned char* box = smem + (j / 8) * BM * 128;
    const int chunk = j % 8;
    *reinterpret_cast<__nv_bfloat162*>(
        box + r * 128 + ((chunk ^ (r % 8)) * 16) + 4 * (lane % 4)) =
        __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<__nv_bfloat162*>(
        box + (r + 8) * 128 + ((chunk ^ ((r + 8) % 8)) * 16) +
        4 * (lane % 4)) = __floats2bfloat162_rn(acc[4 * j + 2],
                                                acc[4 * j + 3]);
  }
  hopper::fence_proxy_async_smem();
  hopper::named_barrier(1, NWG * 128);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int b = 0; b < BN / kSwizzleRow; ++b)
      hopper::tma_store_2d(&omap, smem + b * BM * 128, n0 + b * kSwizzleRow,
                           m0);
    hopper::bulk_commit();
    hopper::bulk_wait_read_all();
  }
}

template <int BM, int BN, int BK>
__global__ void __launch_bounds__(BM * BN / 64)
sgemm_8x8_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 float* __restrict__ out, int N, int K) {
  constexpr int kThreadsPerCta = BM * BN / 64;
  constexpr int kWarpsN = BN / 64;                  // warps along n
  constexpr int kAVecs = BM * BK / 4 / kThreadsPerCta;  // float4 of x a thread
  constexpr int kBVecs = BK * BN / 4 / kThreadsPerCta;  // 16-byte copies of w
  static_assert(kAVecs >= 1 && kBVecs >= 1, "tile too small for the CTA");
  extern __shared__ float4 sgemm_smem[];
  float* As = reinterpret_cast<float*>(sgemm_smem);  // [2][BK][BM]
  float* Bs = As + 2 * BK * BM;                     // [2][BK][BN]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int tx = (warp % kWarpsN) * 8 + lane % 8;
  const int ty = (warp / kWarpsN) * 4 + lane / 8;
  const float* xb = x + static_cast<long long>(blockIdx.y) * BM * K;
  const float* wb = w + static_cast<long long>(blockIdx.x) * BN;

  float4 a_stage[kAVecs];
  auto load_a = [&](int k0) {
#pragma unroll
    for (int v = 0; v < kAVecs; ++v) {
      const int e = tid + v * kThreadsPerCta;
      const int m = e % BM, kq = e / BM;
      a_stage[v] = *reinterpret_cast<const float4*>(
          xb + static_cast<long long>(m) * K + k0 + kq * 4);
    }
  };
  auto store_a = [&](float* dst) {
#pragma unroll
    for (int v = 0; v < kAVecs; ++v) {
      const int e = tid + v * kThreadsPerCta;
      const int m = e % BM, kq = e / BM;
      dst[(kq * 4 + 0) * BM + m] = a_stage[v].x;
      dst[(kq * 4 + 1) * BM + m] = a_stage[v].y;
      dst[(kq * 4 + 2) * BM + m] = a_stage[v].z;
      dst[(kq * 4 + 3) * BM + m] = a_stage[v].w;
    }
  };
  auto load_b = [&](int k0, float* dst) {
#pragma unroll
    for (int v = 0; v < kBVecs; ++v) {
      const int e = tid + v * kThreadsPerCta;
      const int kr = e / (BN / 4), nq = e % (BN / 4);
      hopper::cp_async16(dst + kr * BN + nq * 4,
                         wb + static_cast<long long>(k0 + kr) * N + nq * 4);
    }
    hopper::cp_async_commit();
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load_b(0, Bs);
  load_a(0);
  store_a(As);
  hopper::cp_async_wait<0>();
  __syncthreads();

  const int n_kt = K / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < n_kt;
    if (more) {
      load_b((kt + 1) * BK, Bs + (cur ^ 1) * BK * BN);
      load_a((kt + 1) * BK);
    }
    const float* a_s = As + cur * BK * BM;
    const float* b_s = Bs + cur * BK * BN;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(a_s + kk * BM + ty * 4);
      const float4 a1 =
          *reinterpret_cast<const float4*>(a_s + kk * BM + BM / 2 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(b_s + kk * BN + tx * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(b_s + kk * BN + BN / 2 + tx * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) {
      store_a(As + (cur ^ 1) * BK * BM);
      hopper::cp_async_wait<0>();
    }
    __syncthreads();
  }

  float* ob = out + static_cast<long long>(blockIdx.y) * BM * N +
              static_cast<long long>(blockIdx.x) * BN;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = (i < 4 ? 0 : BM / 2) + ty * 4 + i % 4;
    float* o = ob + static_cast<long long>(row) * N;
    *reinterpret_cast<float4*>(o + tx * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(o + BN / 2 + tx * 4) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

// Shared memory of one f32 CTA: two stages of the x and w tiles.
__host__ __device__ constexpr int sgemm_smem_bytes(int bm, int bk, int bn) {
  return 2 * (bm + bn) * bk * 4;
}

template <int BM, int BN, int BK>
int launch_sgemm(const float* x, const float* w, float* out, int M, int N,
                 int K, cudaStream_t stream) {
  const int bytes = sgemm_smem_bytes(BM, BK, BN);
  cudaError_t err = cudaFuncSetAttribute(
      sgemm_8x8_kernel<BM, BN, BK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(N / BN, M / BM);
  sgemm_8x8_kernel<BM, BN, BK><<<grid, BM * BN / 64, bytes, stream>>>(
      x, w, out, N, K);
  return static_cast<int>(cudaGetLastError());
}

template <int BM, int BN>
int launch_sgemm_bk(const float* x, const float* w, float* out, int M, int N,
                    int K, int bk, cudaStream_t stream) {
  if (bk == 8) return launch_sgemm<BM, BN, 8>(x, w, out, M, N, K, stream);
  if (bk == 16) return launch_sgemm<BM, BN, 16>(x, w, out, M, N, K, stream);
  if (bk == 32) return launch_sgemm<BM, BN, 32>(x, w, out, M, N, K, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

int launch_f32(const void* xv, const void* wv, void* outv, int M, int N,
               int K, int bm, int bn, int bk, void* stream) {
  const float* x = static_cast<const float*>(xv);
  const float* w = static_cast<const float*>(wv);
  float* out = static_cast<float*>(outv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bm == 64 && bn == 64)
    return launch_sgemm_bk<64, 64>(x, w, out, M, N, K, bk, s);
  if (bm == 64 && bn == 128)
    return launch_sgemm_bk<64, 128>(x, w, out, M, N, K, bk, s);
  if (bm == 128 && bn == 64)
    return launch_sgemm_bk<128, 64>(x, w, out, M, N, K, bk, s);
  if (bm == 128 && bn == 128)
    return launch_sgemm_bk<128, 128>(x, w, out, M, N, K, bk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 2-d bf16 row-major (rows, cols) tensor, boxes of (box_rows, 64 columns),
// 128-byte swizzle.
bool bf16_map(CUtensorMap* map, const void* base, int rows, int cols,
              int box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {kSwizzleRow, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NWG, int BN>
int launch_wgmma(const CUtensorMap& xmap, const CUtensorMap& wmap,
                 const CUtensorMap& omap, int M, int N, int K, int bk,
                 cudaStream_t stream) {
  const int bytes = wgmma_smem_bytes(64 * NWG, bk, BN);
  cudaError_t err = cudaFuncSetAttribute(
      wgmma_tma_kernel<NWG, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(N / BN, M / (64 * NWG));
  wgmma_tma_kernel<NWG, BN><<<grid, NWG * 128 + 32, bytes, stream>>>(
      xmap, wmap, omap, K, bk);
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16(const void* x, const void* w, void* out, int M, int N, int K,
                int bm, int bn, int bk, void* stream) {
  CUtensorMap xmap, wmap, omap;
  if (!bf16_map(&xmap, x, M, K, bm) || !bf16_map(&wmap, w, K, N, bk) ||
      !bf16_map(&omap, out, M, N, bm))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bm == 64 && bn == 64)
    return launch_wgmma<1, 64>(xmap, wmap, omap, M, N, K, bk, s);
  if (bm == 64 && bn == 128)
    return launch_wgmma<1, 128>(xmap, wmap, omap, M, N, K, bk, s);
  if (bm == 128 && bn == 64)
    return launch_wgmma<2, 64>(xmap, wmap, omap, M, N, K, bk, s);
  if (bm == 128 && bn == 128)
    return launch_wgmma<2, 128>(xmap, wmap, omap, M, N, K, bk, s);
  if (bm == 64 && bn == 256)
    return launch_wgmma<1, 256>(xmap, wmap, omap, M, N, K, bk, s);
  if (bm == 128 && bn == 256)
    return launch_wgmma<2, 256>(xmap, wmap, omap, M, N, K, bk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the CUDA error code (0 on success).  The caller
// guarantees contiguous operands and a block shape that `block_is_valid`
// accepts for (M, K, N) and the dtype.
//
// f32 on the CUDA cores: bm, bn in {64, 128}, bk in {8, 16, 32};
// 16-byte-aligned operands.
int tiled_matmul_f32(const void* x, const void* w, void* out, int M, int N,
                     int K, int bm, int bn, int bk, void* stream) {
  return launch_f32(x, w, out, M, N, K, bm, bn, bk, stream);
}

// bf16 through wgmma + TMA: bm in {64, 128}, bn in {64, 128, 256}, bk a
// multiple of 64 with wgmma_smem_bytes(bm, bk, bn) within the 227 KB a block
// may claim; 16-byte-aligned operands.
int tiled_matmul_bf16(const void* x, const void* w, void* out, int M, int N,
                      int K, int bm, int bn, int bk, void* stream) {
  return launch_bf16(x, w, out, M, N, K, bm, bn, bk, stream);
}

}  // extern "C"
