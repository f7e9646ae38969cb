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
// Three kernels, one launch each, in both designs:
//   1. `flash_bwd_delta_kernel`: D, G lanes a (row, head) reading 16-byte
//      chunks of O and dO (G = 8 at hd 64 in bf16), so a warp's loads are
//      contiguous; the lanes' sums meet by shuffles.
//   2. dK/dV: one CTA per (KV head, batch, 64-key tile).  K and V stay in
//      shared memory; the CTA walks the g query heads of its KV head and,
//      for each, the 64-row q tiles from the diagonal down, recomputing P and
//      dP there and adding P^T dO and dS^T Q into dV and dK held in
//      registers.  Q and dO tiles (with their rows' lse and D) arrive by
//      cp.async into a two-stage ring, so the next one loads while this one
//      computes.  GQA's sum over the g heads and the sum over q tiles stay
//      inside the CTA, in one fixed order.
//   3. dQ: one CTA per (query head, batch, 64-row q tile), largest q tiles
//      first, over the k tiles up to the diagonal (K and V tiles through the
//      same kind of ring), recomputing P and dP and adding dS K into dQ held
//      in registers.
// Two calls on the same operands give the same bits.  Both designs skip
// tiles above the diagonal and mask only the diagonal tile and the tile of
// the last true key.
//
// Bound: operations.  The minimum is five causal products (QK^T, dO V^T,
// P^T dO, dS^T Q, dS K), 5 * 2 * B * H * (S^2 / 2) * hd flops; both designs
// do seven (the dQ kernel recomputes QK^T and dO V^T rather than sum dQ
// across CTAs with atomics).  At the train shape (B 8, S 1024, H 15, hd 64)
// that is 40 GFLOP: 0.041 ms at the bf16 tensor-core peak (989 TFLOP/s) and
// 0.60 ms at the f32 CUDA-core peak (67 TFLOP/s), against ~0.03 ms for its
// ~100 MB of operands.
//
// bf16 -- `flash_bwd_dkdv_mma_kernel` / `flash_bwd_dq_mma_kernel`, the tensor
// cores (`mma.sync.m16n8k16` bf16 -> f32, the forward's fragments; path
// "mma_sync").  4 warps a CTA.
//   * dK/dV: each warp owns 16 keys.  S^T = K Q^T and dP^T = V dO^T take
//     this warp's K and V rows as A fragments (`ldmatrix`) and Q and dO as B
//     fragments from their [q][hd] rows (`ldmatrix`, two n8 query blocks a
//     load).  P^T = 2^(S^T c - lse log2 e) and dS^T = P^T (dP^T - D) are
//     formed in the accumulators (lse and D of a lane's query columns from
//     the ring), rounded to bf16 and reused directly as the A fragments of
//     dV += P^T dO and dK += dS^T Q, whose B fragments are dO and Q through
//     `ldmatrix.trans`.  P and dS never touch shared memory.  Above hd 64 a
//     warp takes the q tile in two halves of 32 queries, so its S^T and dP^T
//     (16 + 16 registers) leave room for dK and dV (2 x hd / 2); on the
//     diagonal tile a half whose queries all precede the warp's keys is
//     skipped.
//   * dQ: each warp owns 16 q rows.  S = Q K^T and dP = dO V^T take Q and dO
//     as A fragments (read once and held up to hd 64, re-read by `ldmatrix`
//     from the resident tiles above it) and K and V as B fragments from
//     their [key][hd] rows; dS is formed in the accumulators and reused as
//     the A fragment of dQ += dS K, K through `ldmatrix.trans`.  Up to hd
//     64 a warp takes the k tile in two halves of 32 keys (on the diagonal
//     tile, warps 0 and 1 skip the half past their rows).
//   * Registers: up to hd 64 both kernels are bound to 168 a thread, three
//     CTAs (12 warps) an SM; at hd 64 the whole call ran 12% faster than
//     with two CTAs (214 and 174 registers), and the dQ warp's key halves
//     keep it from spilling there at the same speed (PERF.md).
//   * hd 8 is zero-padded to the mma's k of 16 where hd is the product's k
//     (S^T, dP^T, S, dP: the pad columns of every tile are zeroed once; the
//     copies never write them), and keeps n = 8 where hd is its n (dK, dV,
//     dQ).  Shared rows are padded by 16 bytes, so the 8 rows of an
//     `ldmatrix` hit 8 different bank groups.
//   * Rounding: P and dS are rounded to bf16 before their products (the
//     f32 plain version does not round them); every sum is f32, and each
//     gradient is rounded once to bf16 at the end.
//   * What bounds it: the shared-memory reads that feed the mma (every warp
//     reads each B fragment: one ldmatrix.x4, 512 bytes, a two mma, as in
//     the forward) beside the tensor cores' mma.sync rate, and a warp's
//     serial chain of products on 16 rows.  `wgmma`, with 64-row
//     warpgroup tiles and B straight from shared memory, is the next step.
//
// f32 -- `flash_bwd_dkdv_simt_kernel` / `flash_bwd_dq_simt_kernel`, true FP32
// on the CUDA cores (explicit fmaf, never TF32; the library is built with
// -fmad=false; path "simt_4x8").  128 threads a CTA up to hd 64 (256 above).
//   * The operand each lane of a quarter-warp reads a different part of is
//     stored transposed, and the operand they share is stored as it is: dK/dV
//     holds K^T and V^T [hd][64] (transposed once, on their way in) and takes
//     Q and dO [64][hd] by cp.async; dQ holds Q^T and dO^T and takes K and V.
//     Every inner-loop read is one 16-byte LDS, conflict-free (8 lanes on 8
//     neighbouring float4) or a broadcast (8 lanes on one): a warp's 16-byte
//     shared load is served a quarter-warp at a time, so shared-memory time
//     follows the floats each lane reads per FMA.
//   * A thread holds 4 keys x 8 queries of S^T and dP^T (dQ: 4 rows x 8
//     keys): per 4 d, 4 + 4 LDS.128 of K^T and V^T and 8 + 8 of Q and dO
//     feed 256 FMAs, 3/8 of a float a FMA.  The accumulators hold 4 keys
//     (rows) x 8 columns of dK and dV (dQ) at hd 64: per query (key), one
//     LDS.128 of P (dS) and two of dO (Q) feed 32 FMAs, also 3/8.  Above hd
//     64, 256 threads hold 4 x 4 scores and 2 rows of the accumulators, so
//     2 x 2 x 20 accumulators at hd 160 leave room for the scores.
//   * P and dS cross threads through shared memory (the score tile's owner
//     of a key is not the accumulator's), as [q][key] (dQ: dS^T [key][row])
//     64 x 64 floats: a quarter-warp writes 32 neighbouring floats of one
//     row, and reads one float4 all 8 lanes share, so the layout needs no
//     padding.  dK/dV has room for one such tile at two CTAs an SM: it holds
//     P for dV += P^T dO, then dS for dK += dS^T Q (four barriers a q tile).
//   * Shared memory at hd 64: dK/dV 115,712 bytes (K^T, V^T, two stages of
//     Q, dO, lse and D, and P), dQ 114,688 (Q^T, dO^T, two stages of K and
//     V, and dS^T): two CTAs (8 warps) an SM.  hd 160 takes one stage.
//   * What bounds it: the FMA issue rate and the shared-memory reads that
//     feed it (3/8 of a float a FMA against the 1/4 at which the two
//     balance), at 8 warps an SM.
//
// Registers a thread (ptxas, -Xptxas -v, CUDA 12.8), hd 8 / 16 / 32 / 64 /
// 128 / 160, no instance spilling:
//   bf16 dK/dV 114 / 135 / 162 / 168 / 235 / 255, dQ 80 / 96 / 122 / 168 /
//   246 / 246;
//   f32  dK/dV 168 / 155 / 168 / 200 / 181 / 197, dQ 150 / 160 / 168 / 189 /
//   159 / 156;
//   D 24-36.
// `python -m repro_torch.kernels.ab` rebuilds this file with its
// `static constexpr` knobs set otherwise and times each variant's kernels
// beside it (PERF.md: two CTAs an SM, a dQ warp on 64 keys, a dK/dV warp on
// 32 queries).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kTile = 64;      // q rows and keys of a tile
constexpr int kStages = 2;     // tiles in a cp.async ring
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

// A 16-byte chunk of f32 or bf16 values, widened to f32 (a bf16 is the high
// half of its f32, so the widening is exact).
__device__ __forceinline__ void load_chunk(float (&f)[4], const float* p) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  f[0] = t.x, f[1] = t.y, f[2] = t.z, f[3] = t.w;
}
__device__ __forceinline__ void load_chunk(float (&f)[8], const bf16* p) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// ---- D = rowsum(dO o O) -------------------------------------------------

constexpr int kDeltaThreads = 256;

// G lanes a row of HD values, each reading 16-byte chunks of O and dO (the
// rows of out and dout are contiguous, so a warp's loads are too); the
// lanes' sums are reduced by shuffles.
template <typename T, int HD>
struct DeltaTile {
  static constexpr int EPC = 16 / sizeof(T);  // values a 16-byte chunk
  static constexpr int CH = HD / EPC;         // chunks a row
  static constexpr int G = CH >= 32 ? 32 : CH >= 16 ? 16 : CH >= 8 ? 8
                           : CH >= 4 ? 4 : CH >= 2 ? 2 : 1;
};

template <typename T, int HD>
__global__ void __launch_bounds__(kDeltaThreads)
flash_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                       float* __restrict__ delta, int rows, int Sq, int H) {
  using C = DeltaTile<T, HD>;
  constexpr int EPC = C::EPC, G = C::G;
  const int r = (blockIdx.x * kDeltaThreads + threadIdx.x) / G;
  const int l = threadIdx.x % G;
  float sum = 0.f;
  if (r < rows) {
    const T* o = out + static_cast<long long>(r) * HD;
    const T* g = dout + static_cast<long long>(r) * HD;
    for (int c = l; c < C::CH; c += G) {
      float a[EPC], b[EPC];
      load_chunk(a, o + c * EPC);
      load_chunk(b, g + c * EPC);
#pragma unroll
      for (int e = 0; e < EPC; ++e) sum = fmaf(a[e], b[e], sum);
    }
  }
#pragma unroll
  for (int off = G / 2; off > 0; off /= 2)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (r < rows && l == 0) {
    const int h = r % H;
    const long long bi = r / H;  // b * Sq + i
    const long long b = bi / Sq, i = bi % Sq;
    delta[(b * H + h) * Sq + i] = sum;
  }
}

// The 64 lse and 64 D values of query head h's rows q0..q0+63 into `ls` and
// `ds` by cp.async, 16 chunks each (`at` is a multiple of 64).
__device__ __forceinline__ void copy_lse_delta(float* ls, float* ds,
                                          const float* lse, const float* delta,
                                          long long at) {
  const int c = threadIdx.x % 16;
  if (threadIdx.x < 16)
    hopper::cp_async16(ls + 4 * c, lse + at + 4 * c);
  else if (threadIdx.x < 32)
    hopper::cp_async16(ds + 4 * c, delta + at + 4 * c);
}

// ---- bf16: tensor cores -------------------------------------------------

constexpr int kMmaThreads = 128;  // 4 warps of 16 keys (dK/dV) or rows (dQ)

template <int HD>
struct MmaBwdTile {
  static constexpr int HDP = HD < 16 ? 16 : HD;  // hd as a product's k
  static constexpr int STRIDE = HDP + 8;         // row, elements (+16 bytes)
  static constexpr int ELEMS = kTile * STRIDE;   // a [64][STRIDE] tile
  // Queries of S^T a dK/dV warp holds at once: two halves of the q tile
  // above hd 64.
  static constexpr int QC = HD > 64 ? 32 : kTile;
  // Keys of S and dP a dQ warp holds at once: two halves of the k tile up
  // to hd 64, so it fits three CTAs' registers without spilling.
  static constexpr int KC = HD <= 64 ? 32 : kTile;
  // Q's and dO's A fragments, held by a dQ warp up to hd 64 (read once),
  // re-read by ldmatrix every k tile above it.
  static constexpr bool HOLD_Q = HD <= 64;
  // CTAs an SM the launch bounds ask registers for: three up to hd 64
  // (at most 168 registers a thread); above, up to 255 a thread.
  static constexpr int DKDV_MIN_CTAS = HD <= 64 ? 3 : 1;
  static constexpr int DQ_MIN_CTAS = HD <= 64 ? 3 : 1;
  // dK/dV: K, V and a ring of (Q, dO, lse, D); dQ: Q, dO and a ring of (K,
  // V).
  static constexpr int DKDV_BYTES =
      2 * (2 + 2 * kStages) * ELEMS + 4 * kStages * 2 * kTile;
  static constexpr int DQ_BYTES = 2 * (2 + 2 * kStages) * ELEMS;
};

template <int HD>
__global__ void __launch_bounds__(kMmaThreads,
                                  MmaBwdTile<HD>::DKDV_MIN_CTAS)
flash_bwd_dkdv_mma_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq,
                          int Sk, int sk_valid, int H, int KV, float scale) {
  using C = MmaBwdTile<HD>;
  constexpr int ST = C::STRIDE, QC = C::QC;
  constexpr int KSTEPS = C::HDP / 16;  // k16 steps of S^T and dP^T
  constexpr int NB = QC / 8;           // n8 query blocks of S^T
  constexpr int DBLK = HD / 8;         // n8 blocks of dK and dV
  constexpr int CH = HD / 8;           // 16-byte chunks of a global row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [64][ST]
  bf16* Vs = Ks + C::ELEMS;                      // [64][ST]
  bf16* Qs = Vs + C::ELEMS;                      // [kStages][64][ST]
  bf16* dOs = Qs + kStages * C::ELEMS;           // [kStages][64][ST]
  float* Ls = reinterpret_cast<float*>(dOs + kStages * C::ELEMS);  // [2][64]
  float* Dl = Ls + kStages * kTile;                                // [2][64]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, tc = lane % 4;  // fragment row, column pair
  const int kvh = blockIdx.x, b = blockIdx.y, kt = blockIdx.z;
  const int k0 = kt * kTile;
  const int g = H / KV;
  const long long q_row = static_cast<long long>(H) * HD;
  const long long kv_row = static_cast<long long>(KV) * HD;
  const long long kv_at = (static_cast<long long>(b) * Sk + k0) * kv_row +
                          static_cast<long long>(kvh) * HD;

  if (HD < 16) {  // zero the pad columns [HD, 16) of every tile
    for (int r = tid; r < (2 + 2 * kStages) * kTile; r += kMmaThreads)
      *reinterpret_cast<uint4*>(Ks + r * ST + HD) = make_uint4(0, 0, 0, 0);
  }
  for (int e = tid; e < kTile * CH; e += kMmaThreads) {
    const int r = e / CH, c = e % CH;
    hopper::cp_async16(Ks + r * ST + 8 * c, k + kv_at + r * kv_row + 8 * c);
    hopper::cp_async16(Vs + r * ST + 8 * c, v + kv_at + r * kv_row + 8 * c);
  }
  // Items: (head hh, q tile kt + i) for every q tile from the diagonal down;
  // none past the last true key.
  const int nq = k0 < sk_valid ? max(Sq / kTile - kt, 0) : 0;
  const int n_items = g * nq;
  auto load_q = [&](int item, int buf) {
    const int h = kvh * g + item / nq;
    const int q0 = (kt + item % nq) * kTile;
    const long long q_at = (static_cast<long long>(b) * Sq + q0) * q_row +
                           static_cast<long long>(h) * HD;
    bf16* qd = Qs + buf * C::ELEMS;
    bf16* od = dOs + buf * C::ELEMS;
    for (int e = tid; e < kTile * CH; e += kMmaThreads) {
      const int r = e / CH, c = e % CH;
      hopper::cp_async16(qd + r * ST + 8 * c, q + q_at + r * q_row + 8 * c);
      hopper::cp_async16(od + r * ST + 8 * c, dout + q_at + r * q_row + 8 * c);
    }
    copy_lse_delta(Ls + buf * kTile, Dl + buf * kTile, lse, delta,
              (static_cast<long long>(b) * H + h) * Sq + q0);
  };
  if (n_items > 0) load_q(0, 0);
  hopper::cp_async_commit();  // K, V and item 0

  // Shared addresses of this lane's ldmatrix rows: this warp's K and V rows
  // (A fragments of S^T and dP^T); Q and dO rows as B fragments of S^T and
  // dP^T (two n8 query blocks a load) and, transposed, of dK and dV (two n8
  // hd blocks a load).
  const int a_off = (warp * 16 + lane % 16) * ST + (lane / 16) * 8;
  const uint32_t k_a = hopper::smem_u32(Ks + a_off);
  const uint32_t v_a = hopper::smem_u32(Vs + a_off);
  const uint32_t b_off =
      2 * ((lane % 8 + (lane / 16) * 8) * ST + ((lane / 8) % 2) * 8);
  const uint32_t t_off =
      2 * ((lane % 8 + ((lane / 8) % 2) * 8) * ST + (lane / 16) * 8);
  const uint32_t q_s = hopper::smem_u32(Qs), o_s = hopper::smem_u32(dOs);
  // exp(scale s - lse) = 2^(s c - lse log2 e), one FFMA and one SFU op a
  // score.
  const float c = scale * kLog2e;
  const int key_lo = k0 + warp * 16 + gr;  // this lane's keys: + 0 and + 8

  float dka[DBLK][4], dva[DBLK][4];
#pragma unroll
  for (int d = 0; d < DBLK; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[d][e] = dva[d][e] = 0.f;

  for (int it = 0; it < n_items; ++it) {
    hopper::cp_async_wait<0>();
    __syncthreads();  // item it has landed; item it - 1 is consumed
    if (it + 1 < n_items) load_q(it + 1, (it + 1) % kStages);
    hopper::cp_async_commit();
    const int buf = it % kStages;
    const int q0 = (kt + it % nq) * kTile;
    const uint32_t qb = q_s + buf * C::ELEMS * 2;
    const uint32_t ob = o_s + buf * C::ELEMS * 2;
    const float* lr = Ls + buf * kTile;
    const float* dr = Dl + buf * kTile;
    // Only the diagonal tile (q0 == k0) and the tile of the last true key
    // mask.
    const bool diag = q0 < k0 + kTile;
    const bool mask = diag || k0 + kTile > sk_valid;

#pragma unroll
    for (int qc = 0; qc < kTile / QC; ++qc) {
      // On the diagonal, a half whose queries all precede this warp's keys
      // adds nothing.
      if (diag && qc * QC + QC <= warp * 16) continue;
      float s[NB][4], dp[NB][4];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
      // S^T (16 keys x QC queries) = K Q^T and dP^T = V dO^T.
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        uint32_t ka[4], va[4];
        hopper::ldmatrix_x4(ka, k_a + ks * 32);
        hopper::ldmatrix_x4(va, v_a + ks * 32);
#pragma unroll
        for (int nb2 = 0; nb2 < NB / 2; ++nb2) {
          const uint32_t off = 2 * ((qc * QC + nb2 * 16) * ST + ks * 16);
          uint32_t qf[4], of[4];
          hopper::ldmatrix_x4(qf, qb + b_off + off);
          hopper::ldmatrix_x4(of, ob + b_off + off);
          hopper::mma_16816_bf16(s[2 * nb2], ka, qf[0], qf[1]);
          hopper::mma_16816_bf16(s[2 * nb2 + 1], ka, qf[2], qf[3]);
          hopper::mma_16816_bf16(dp[2 * nb2], va, of[0], of[1]);
          hopper::mma_16816_bf16(dp[2 * nb2 + 1], va, of[2], of[3]);
        }
      }
      // P^T and dS^T in the accumulators: columns are queries.
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const int qi = qc * QC + nb * 8 + 2 * tc;  // column of e = 0 (and 2)
        const float2 l2 = *reinterpret_cast<const float2*>(lr + qi);
        const float2 d2 = *reinterpret_cast<const float2*>(dr + qi);
        const float nl[2] = {-l2.x * kLog2e, -l2.y * kLog2e};
        const float dd[2] = {d2.x, d2.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key_lo + 8 * (e / 2);
          float p = hopper::ex2_approx(__fmaf_rn(s[nb][e], c, nl[e & 1]));
          if (mask && (key > q0 + qi + (e & 1) || key >= sk_valid)) p = 0.f;
          s[nb][e] = p;
          dp[nb][e] = p * (dp[nb][e] - dd[e & 1]);
        }
      }
      // dV += P^T dO and dK += dS^T Q, 16 queries a step: P^T and dS^T
      // rounded to bf16 as the A fragments.
#pragma unroll
      for (int kc = 0; kc < QC / 16; ++kc) {
        const uint32_t pa[4] = {
            hopper::pack_bf16(s[2 * kc][0], s[2 * kc][1]),
            hopper::pack_bf16(s[2 * kc][2], s[2 * kc][3]),
            hopper::pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
            hopper::pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
        const uint32_t da[4] = {
            hopper::pack_bf16(dp[2 * kc][0], dp[2 * kc][1]),
            hopper::pack_bf16(dp[2 * kc][2], dp[2 * kc][3]),
            hopper::pack_bf16(dp[2 * kc + 1][0], dp[2 * kc + 1][1]),
            hopper::pack_bf16(dp[2 * kc + 1][2], dp[2 * kc + 1][3])};
        const uint32_t row = t_off + 2 * (qc * QC + kc * 16) * ST;
        if constexpr (DBLK == 1) {
          uint32_t of[2], qf[2];
          hopper::ldmatrix_x2_trans(of, ob + row);
          hopper::ldmatrix_x2_trans(qf, qb + row);
          hopper::mma_16816_bf16(dva[0], pa, of[0], of[1]);
          hopper::mma_16816_bf16(dka[0], da, qf[0], qf[1]);
        } else {
#pragma unroll
          for (int d2 = 0; d2 < DBLK / 2; ++d2) {
            uint32_t of[4], qf[4];
            hopper::ldmatrix_x4_trans(of, ob + row + d2 * 32);
            hopper::ldmatrix_x4_trans(qf, qb + row + d2 * 32);
            hopper::mma_16816_bf16(dva[2 * d2], pa, of[0], of[1]);
            hopper::mma_16816_bf16(dva[2 * d2 + 1], pa, of[2], of[3]);
            hopper::mma_16816_bf16(dka[2 * d2], da, qf[0], qf[1]);
            hopper::mma_16816_bf16(dka[2 * d2 + 1], da, qf[2], qf[3]);
          }
        }
      }
    }
  }

  // dK = scale dS^T Q and dV = P^T dO, rounded once to bf16: rows gr and gr
  // + 8 of this warp's keys, columns 2 tc and 2 tc + 1 of each n8 block.
  bf16* dkr = dk + kv_at + (warp * 16 + gr) * kv_row + 2 * tc;
  bf16* dvr = dv + kv_at + (warp * 16 + gr) * kv_row + 2 * tc;
#pragma unroll
  for (int d = 0; d < DBLK; ++d) {
    *reinterpret_cast<__nv_bfloat162*>(dkr + 8 * d) =
        __floats2bfloat162_rn(dka[d][0] * scale, dka[d][1] * scale);
    *reinterpret_cast<__nv_bfloat162*>(dkr + 8 * kv_row + 8 * d) =
        __floats2bfloat162_rn(dka[d][2] * scale, dka[d][3] * scale);
    *reinterpret_cast<__nv_bfloat162*>(dvr + 8 * d) =
        __floats2bfloat162_rn(dva[d][0], dva[d][1]);
    *reinterpret_cast<__nv_bfloat162*>(dvr + 8 * kv_row + 8 * d) =
        __floats2bfloat162_rn(dva[d][2], dva[d][3]);
  }
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads, MmaBwdTile<HD>::DQ_MIN_CTAS)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, bf16* __restrict__ dq,
                        int Sq, int Sk, int sk_valid, int H, int KV,
                        float scale) {
  using C = MmaBwdTile<HD>;
  constexpr int ST = C::STRIDE, KC = C::KC;
  constexpr int KSTEPS = C::HDP / 16;  // k16 steps of S and dP
  constexpr int NB = KC / 8;           // n8 key blocks of S
  constexpr int DBLK = HD / 8;         // n8 blocks of dQ
  constexpr int CH = HD / 8;
  constexpr int HQ = C::HOLD_Q ? KSTEPS : 1;  // fragments held
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [64][ST]
  bf16* dOs = Qs + C::ELEMS;                     // [64][ST]
  bf16* Ks = dOs + C::ELEMS;                     // [kStages][64][ST]
  bf16* Vs = Ks + kStages * C::ELEMS;            // [kStages][64][ST]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, tc = lane % 4;
  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;  // most k tiles first
  const int q0 = qt * kTile;
  const int kvh = h / (H / KV);
  const long long q_row = static_cast<long long>(H) * HD;
  const long long kv_row = static_cast<long long>(KV) * HD;
  const long long q_at = (static_cast<long long>(b) * Sq + q0) * q_row +
                         static_cast<long long>(h) * HD;

  if (HD < 16) {
    for (int r = tid; r < (2 + 2 * kStages) * kTile; r += kMmaThreads)
      *reinterpret_cast<uint4*>(Qs + r * ST + HD) = make_uint4(0, 0, 0, 0);
  }
  for (int e = tid; e < kTile * CH; e += kMmaThreads) {
    const int r = e / CH, c = e % CH;
    hopper::cp_async16(Qs + r * ST + 8 * c, q + q_at + r * q_row + 8 * c);
    hopper::cp_async16(dOs + r * ST + 8 * c, dout + q_at + r * q_row + 8 * c);
  }
  auto load_kv = [&](int kt, int buf) {
    const long long at = (static_cast<long long>(b) * Sk + kt * kTile) *
                             kv_row + static_cast<long long>(kvh) * HD;
    bf16* kd = Ks + buf * C::ELEMS;
    bf16* vd = Vs + buf * C::ELEMS;
    for (int e = tid; e < kTile * CH; e += kMmaThreads) {
      const int r = e / CH, c = e % CH;
      hopper::cp_async16(kd + r * ST + 8 * c, k + at + r * kv_row + 8 * c);
      hopper::cp_async16(vd + r * ST + 8 * c, v + at + r * kv_row + 8 * c);
    }
  };
  // k tiles up to the diagonal and up to the last true key.
  const int n_kt =
      min(min(Sk / kTile, qt + 1), (sk_valid + kTile - 1) / kTile);
  if (n_kt > 0) load_kv(0, 0);
  hopper::cp_async_commit();  // Q, dO and K/V tile 0

  // This lane's rows gr and gr + 8 of the warp: lse (as -lse log2 e) and D.
  const int row0 = q0 + warp * 16 + gr;
  const long long at = (static_cast<long long>(b) * H + h) * Sq + row0;
  const float nl[2] = {-lse[at] * kLog2e, -lse[at + 8] * kLog2e};
  const float dd[2] = {delta[at], delta[at + 8]};

  // ldmatrix rows: Q and dO (A fragments), K and V as B fragments of S and
  // dP (two n8 key blocks a load) and K, transposed, of dQ (two n8 hd
  // blocks a load).
  const int a_off = (warp * 16 + lane % 16) * ST + (lane / 16) * 8;
  const uint32_t q_a = hopper::smem_u32(Qs + a_off);
  const uint32_t o_a = hopper::smem_u32(dOs + a_off);
  const uint32_t b_off =
      2 * ((lane % 8 + (lane / 16) * 8) * ST + ((lane / 8) % 2) * 8);
  const uint32_t t_off =
      2 * ((lane % 8 + ((lane / 8) % 2) * 8) * ST + (lane / 16) * 8);
  const uint32_t k_s = hopper::smem_u32(Ks), v_s = hopper::smem_u32(Vs);
  const float c = scale * kLog2e;

  uint32_t qf[HQ][4], of[HQ][4];
  float acc[DBLK][4];
#pragma unroll
  for (int d = 0; d < DBLK; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    hopper::cp_async_wait<0>();
    __syncthreads();  // K/V tile kt has landed; tile kt - 1 is consumed
    if (kt + 1 < n_kt) load_kv(kt + 1, (kt + 1) % kStages);
    hopper::cp_async_commit();
    if (C::HOLD_Q && kt == 0) {
#pragma unroll
      for (int ks = 0; ks < HQ; ++ks) {
        hopper::ldmatrix_x4(qf[ks], q_a + ks * 32);
        hopper::ldmatrix_x4(of[ks], o_a + ks * 32);
      }
    }
    const int buf = kt % kStages;
    const uint32_t kb = k_s + buf * C::ELEMS * 2;
    const uint32_t vb = v_s + buf * C::ELEMS * 2;

    const int k0 = kt * kTile;
    const bool diag = k0 + kTile > q0;
    const bool mask = diag || k0 + kTile > sk_valid;
#pragma unroll
    for (int kh = 0; kh < kTile / KC; ++kh) {
      // On the diagonal, a half whose keys all follow this warp's rows
      // adds nothing.
      if (diag && kh * KC > warp * 16 + 15) continue;
      // S (16 rows x KC keys) = Q K^T and dP = dO V^T.
      float s[NB][4], dp[NB][4];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        if (!C::HOLD_Q) {
          hopper::ldmatrix_x4(qf[0], q_a + ks * 32);
          hopper::ldmatrix_x4(of[0], o_a + ks * 32);
        }
#pragma unroll
        for (int nb2 = 0; nb2 < NB / 2; ++nb2) {
          const uint32_t off = 2 * ((kh * KC + nb2 * 16) * ST + ks * 16);
          uint32_t kf[4], vf[4];
          hopper::ldmatrix_x4(kf, kb + b_off + off);
          hopper::ldmatrix_x4(vf, vb + b_off + off);
          hopper::mma_16816_bf16(s[2 * nb2], qf[ks % HQ], kf[0], kf[1]);
          hopper::mma_16816_bf16(s[2 * nb2 + 1], qf[ks % HQ], kf[2], kf[3]);
          hopper::mma_16816_bf16(dp[2 * nb2], of[ks % HQ], vf[0], vf[1]);
          hopper::mma_16816_bf16(dp[2 * nb2 + 1], of[ks % HQ], vf[2], vf[3]);
        }
      }
      // dS = P (dP - D) in the accumulators (dp holds it).
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + kh * KC + nb * 8 + 2 * tc + (e & 1);
          float p = hopper::ex2_approx(__fmaf_rn(s[nb][e], c, nl[e / 2]));
          if (mask && (key > row0 + 8 * (e / 2) || key >= sk_valid)) p = 0.f;
          dp[nb][e] = p * (dp[nb][e] - dd[e / 2]);
        }
      // dQ += dS K, 16 keys a step: dS rounded to bf16 as the A fragment.
#pragma unroll
      for (int kc = 0; kc < KC / 16; ++kc) {
        const uint32_t da[4] = {
            hopper::pack_bf16(dp[2 * kc][0], dp[2 * kc][1]),
            hopper::pack_bf16(dp[2 * kc][2], dp[2 * kc][3]),
            hopper::pack_bf16(dp[2 * kc + 1][0], dp[2 * kc + 1][1]),
            hopper::pack_bf16(dp[2 * kc + 1][2], dp[2 * kc + 1][3])};
        const uint32_t row = kb + t_off + 2 * (kh * KC + kc * 16) * ST;
        if constexpr (DBLK == 1) {
          uint32_t kf[2];
          hopper::ldmatrix_x2_trans(kf, row);
          hopper::mma_16816_bf16(acc[0], da, kf[0], kf[1]);
        } else {
#pragma unroll
          for (int d2 = 0; d2 < DBLK / 2; ++d2) {
            uint32_t kf[4];
            hopper::ldmatrix_x4_trans(kf, row + d2 * 32);
            hopper::mma_16816_bf16(acc[2 * d2], da, kf[0], kf[1]);
            hopper::mma_16816_bf16(acc[2 * d2 + 1], da, kf[2], kf[3]);
          }
        }
      }
    }
  }

  bf16* dqr = dq + q_at + (warp * 16 + gr) * q_row + 2 * tc;
#pragma unroll
  for (int d = 0; d < DBLK; ++d) {
    *reinterpret_cast<__nv_bfloat162*>(dqr + 8 * d) =
        __floats2bfloat162_rn(acc[d][0] * scale, acc[d][1] * scale);
    *reinterpret_cast<__nv_bfloat162*>(dqr + 8 * q_row + 8 * d) =
        __floats2bfloat162_rn(acc[d][2] * scale, acc[d][3] * scale);
  }
}

// ---- f32: CUDA cores ----------------------------------------------------

template <int HD>
struct SimtBwdTile {
  static constexpr int NT = HD <= 64 ? 128 : 256;  // threads
  // Scores a thread: 4 keys (dQ: rows) x SQ queries (dQ: keys).
  static constexpr int SQ = kTile * kTile / 4 / NT;
  // Accumulators a thread: RK keys (dQ: rows) x NV vectors of VW columns.
  static constexpr int RK = kTile * 8 / NT;
  static constexpr int VW = HD >= 32 ? 4 : HD / 8;
  static constexpr int NV = HD / (8 * VW);
  static constexpr int T = kTile * HD;  // floats of a [64][HD] or [HD][64] tile
  // Two stages up to hd 128; one at hd 160, where two would not fit.
  static constexpr int STAGES = HD <= 128 ? kStages : 1;
  // dK/dV: K^T, V^T, STAGES x (Q, dO, lse, D), P / dS [64][64].  dQ: Q^T,
  // dO^T, STAGES x (K, V), dS^T [64][64].
  static constexpr int DKDV_BYTES =
      4 * (2 * T + STAGES * (2 * T + 2 * kTile) + kTile * kTile);
  static constexpr int DQ_BYTES = 4 * (2 * T + STAGES * 2 * T + kTile * kTile);
  // Two CTAs an SM up to hd 64 (2 x 115,712 bytes of the SM's 228 KB).
  static constexpr int MIN_CTAS = HD <= 64 ? 2 : 1;
  static_assert(SQ * NT * 4 == kTile * kTile && RK * NT == 8 * kTile, "tiles");
};

// W floats from `p` (16-byte aligned for W >= 4) as float4, float2 or float.
template <int W>
__device__ __forceinline__ void load_vec(float (&r)[W], const float* p) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int i = 0; i < W; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + i);
      r[i] = t.x, r[i + 1] = t.y, r[i + 2] = t.z, r[i + 3] = t.w;
    }
  } else if constexpr (W == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    r[0] = t.x, r[1] = t.y;
  } else {
    r[0] = *p;
  }
}

template <int W>
__device__ __forceinline__ void store_vec(float* p, const float (&r)[W]) {
  if constexpr (W == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  } else if constexpr (W == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(r[0], r[1]);
  } else {
    *p = r[0];
  }
}

// Rows r0..r0+63 of `a` and `b` (`stride` floats apart, HD columns) into
// [HD][64] at `at` and `bt`: float4 loads along d, then scalar stores whose
// lanes sit on neighbouring rows.
template <int HD, int NT>
__device__ __forceinline__ void load_transposed(float* at, float* bt,
                                                const float* a, const float* b,
                                                long long stride) {
  for (int e = threadIdx.x; e < kTile * (HD / 4); e += NT) {
    const int r = e % kTile, c = e / kTile;
    const float4 x = *reinterpret_cast<const float4*>(a + r * stride + 4 * c);
    const float4 y = *reinterpret_cast<const float4*>(b + r * stride + 4 * c);
    float* ad = at + 4 * c * kTile + r;
    float* bd = bt + 4 * c * kTile + r;
    ad[0] = x.x, ad[kTile] = x.y, ad[2 * kTile] = x.z, ad[3 * kTile] = x.w;
    bd[0] = y.x, bd[kTile] = y.y, bd[2 * kTile] = y.z, bd[3 * kTile] = y.w;
  }
}

// Rows r0..r0+63 of `a` and `b` (`stride` floats apart, HD columns) into
// [64][HD] at `ad` and `bd` by cp.async.
template <int HD, int NT>
__device__ __forceinline__ void copy_tiles(float* ad, float* bd,
                                                const float* a, const float* b,
                                                long long stride) {
  for (int e = threadIdx.x; e < kTile * (HD / 4); e += NT) {
    const int r = e / (HD / 4), c = e % (HD / 4);
    hopper::cp_async16(ad + r * HD + 4 * c, a + r * stride + 4 * c);
    hopper::cp_async16(bd + r * HD + 4 * c, b + r * stride + 4 * c);
  }
}

// The score tile: s (x) = A B^T and dp (y) = C D^T over HD, where a thread's
// 4 A rows are a float4 of the transposed tiles `at` / `ct` ([HD][64],
// column 4 ax) and its SQ B rows (SQ by + j) are rows of `b` / `d` ([64][HD],
// one float4 along d each, shared by a quarter-warp).
template <int HD, int SQ>
__device__ __forceinline__ void score_tile(float (&x)[4][SQ],
                                           float (&y)[4][SQ], const float* at,
                                           const float* ct, const float* b,
                                           const float* d, int ax, int by) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < SQ; ++j) x[i][j] = y[i][j] = 0.f;
#pragma unroll 2
  for (int d4 = 0; d4 < HD / 4; ++d4) {
    float av[4][4], cv[4][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      load_vec<4>(av[e], at + (4 * d4 + e) * kTile + 4 * ax);
      load_vec<4>(cv[e], ct + (4 * d4 + e) * kTile + 4 * ax);
    }
#pragma unroll
    for (int j = 0; j < SQ; ++j) {
      float bv[4], dv[4];
      load_vec<4>(bv, b + (SQ * by + j) * HD + 4 * d4);
      load_vec<4>(dv, d + (SQ * by + j) * HD + 4 * d4);
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          x[i][j] = fmaf(av[e][i], bv[e], x[i][j]);
          y[i][j] = fmaf(cv[e][i], dv[e], y[i][j]);
        }
    }
  }
}

// acc (RK rows x NV VW columns) += W^T X over 64: per step r, one vector of
// RK from w ([64][64], row r, column RK ay: a quarter-warp's broadcast) and
// NV of VW from x ([64][HD], row r, columns VW ax + 8 VW jv).
template <int HD, int RK, int VW, int NV>
__device__ __forceinline__ void accumulate(float (&acc)[RK][NV * VW],
                                           const float* w, const float* x,
                                           int ay, int ax) {
#pragma unroll 4
  for (int r = 0; r < kTile; ++r) {
    float wv[RK];
    load_vec<RK>(wv, w + r * kTile + RK * ay);
#pragma unroll
    for (int jv = 0; jv < NV; ++jv) {
      float xv[VW];
      load_vec<VW>(xv, x + r * HD + VW * ax + 8 * VW * jv);
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int w2 = 0; w2 < VW; ++w2)
          acc[i][jv * VW + w2] = fmaf(wv[i], xv[w2], acc[i][jv * VW + w2]);
    }
  }
}

// A thread's accumulators, times `mul`, to RK rows of `out` (`stride`
// floats apart), columns VW ax + 8 VW jv.
template <int RK, int VW, int NV>
__device__ __forceinline__ void store_rows(float* out, long long stride,
                                           const float (&acc)[RK][NV * VW],
                                           float mul, int ax) {
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int jv = 0; jv < NV; ++jv) {
      float r[VW];
#pragma unroll
      for (int w = 0; w < VW; ++w) r[w] = acc[i][jv * VW + w] * mul;
      store_vec<VW>(out + i * stride + VW * ax + 8 * VW * jv, r);
    }
}

template <int HD>
__global__ void __launch_bounds__(SimtBwdTile<HD>::NT,
                                  SimtBwdTile<HD>::MIN_CTAS)
flash_bwd_dkdv_simt_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ dk, float* __restrict__ dv,
                           int Sq, int Sk, int sk_valid, int H, int KV,
                           float scale) {
  using C = SimtBwdTile<HD>;
  constexpr int NT = C::NT, SQ = C::SQ, RK = C::RK, VW = C::VW, NV = C::NV;
  extern __shared__ float4 simt_smem[];
  float* Kt = reinterpret_cast<float*>(simt_smem);  // K^T [HD][64]
  float* Vt = Kt + C::T;                            // V^T [HD][64]
  float* Qs = Vt + C::T;                            // [STAGES][64][HD]
  float* dOs = Qs + C::STAGES * C::T;               // [STAGES][64][HD]
  float* Ls = dOs + C::STAGES * C::T;               // [STAGES][64]
  float* Dl = Ls + C::STAGES * kTile;               // [STAGES][64]
  float* Ps = Dl + C::STAGES * kTile;               // P, then dS: [q][key]

  const int tid = threadIdx.x;
  const int kvh = blockIdx.x, b = blockIdx.y, kt = blockIdx.z;
  const int k0 = kt * kTile;
  const int g = H / KV;
  const long long q_row = static_cast<long long>(H) * HD;
  const long long kv_row = static_cast<long long>(KV) * HD;
  const long long kv_at = (static_cast<long long>(b) * Sk + k0) * kv_row +
                          static_cast<long long>(kvh) * HD;
  const int nq = k0 < sk_valid ? max(Sq / kTile - kt, 0) : 0;
  const int n_items = g * nq;
  auto load_q = [&](int item, int buf) {
    const int h = kvh * g + item / nq;
    const int q0 = (kt + item % nq) * kTile;
    const long long q_at = (static_cast<long long>(b) * Sq + q0) * q_row +
                           static_cast<long long>(h) * HD;
    copy_tiles<HD, NT>(Qs + buf * C::T, dOs + buf * C::T, q + q_at,
                            dout + q_at, q_row);
    copy_lse_delta(Ls + buf * kTile, Dl + buf * kTile, lse, delta,
              (static_cast<long long>(b) * H + h) * Sq + q0);
  };
  if (n_items > 0) load_q(0, 0);
  hopper::cp_async_commit();
  load_transposed<HD, NT>(Kt, Vt, k + kv_at, v + kv_at, kv_row);

  const int kx = tid % 16, qy = tid / 16;  // scores: keys 4 kx + i, queries SQ qy + j
  const int ad = tid % 8, ak = tid / 8;    // dK, dV: keys RK ak + i
  const float c = scale * kLog2e;
  float dka[RK][NV * VW], dva[RK][NV * VW];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int j = 0; j < NV * VW; ++j) dka[i][j] = dva[i][j] = 0.f;

  for (int it = 0; it < n_items; ++it) {
    if constexpr (C::STAGES == 1) {
      if (it > 0) {
        __syncthreads();  // item it - 1 is consumed
        load_q(it, 0);
        hopper::cp_async_commit();
      }
    }
    hopper::cp_async_wait<0>();
    __syncthreads();  // item it has landed (and K^T, V^T are stored)
    if constexpr (C::STAGES == 2) {
      if (it + 1 < n_items) load_q(it + 1, (it + 1) % 2);
      hopper::cp_async_commit();
    }
    const int buf = it % C::STAGES;
    const int q0 = (kt + it % nq) * kTile;
    const float* qs = Qs + buf * C::T;
    const float* os = dOs + buf * C::T;

    float s[4][SQ], dp[4][SQ];
    score_tile<HD, SQ>(s, dp, Kt, Vt, qs, os, kx, qy);
    const bool mask = q0 < k0 + kTile || k0 + kTile > sk_valid;
    float lv[SQ], dl[SQ];
    load_vec<SQ>(lv, Ls + buf * kTile + SQ * qy);
    load_vec<SQ>(dl, Dl + buf * kTile + SQ * qy);
#pragma unroll
    for (int j = 0; j < SQ; ++j) {
      const float nl = -lv[j] * kLog2e;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + 4 * kx + i;
        float p = exp2f(fmaf(s[i][j], c, nl));
        if (mask && (key > q0 + SQ * qy + j || key >= sk_valid)) p = 0.f;
        s[i][j] = p;
        dp[i][j] = p * (dp[i][j] - dl[j]);
      }
    }
    // P [q][key]: a quarter-warp writes 32 neighbouring floats of a row.
#pragma unroll
    for (int j = 0; j < SQ; ++j)
      *reinterpret_cast<float4*>(Ps + (SQ * qy + j) * kTile + 4 * kx) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();
    accumulate<HD, RK, VW, NV>(dva, Ps, os, ak, ad);  // dV += P^T dO
    __syncthreads();  // every warp is done with P
#pragma unroll
    for (int j = 0; j < SQ; ++j)
      *reinterpret_cast<float4*>(Ps + (SQ * qy + j) * kTile + 4 * kx) =
          make_float4(dp[0][j], dp[1][j], dp[2][j], dp[3][j]);
    __syncthreads();
    accumulate<HD, RK, VW, NV>(dka, Ps, qs, ak, ad);  // dK += dS^T Q
  }

  const long long at = kv_at + RK * ak * kv_row;
  store_rows<RK, VW, NV>(dk + at, kv_row, dka, scale, ad);
  store_rows<RK, VW, NV>(dv + at, kv_row, dva, 1.f, ad);
}

template <int HD>
__global__ void __launch_bounds__(SimtBwdTile<HD>::NT,
                                  SimtBwdTile<HD>::MIN_CTAS)
flash_bwd_dq_simt_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dq, int Sq, int Sk, int sk_valid,
                         int H, int KV, float scale) {
  using C = SimtBwdTile<HD>;
  constexpr int NT = C::NT, SQ = C::SQ, RK = C::RK, VW = C::VW, NV = C::NV;
  extern __shared__ float4 simt_smem[];
  float* Qt = reinterpret_cast<float*>(simt_smem);  // Q^T [HD][64]
  float* dOt = Qt + C::T;                           // dO^T [HD][64]
  float* Ks = dOt + C::T;                           // [STAGES][64][HD]
  float* Vs = Ks + C::STAGES * C::T;                // [STAGES][64][HD]
  float* dSt = Vs + C::STAGES * C::T;               // dS^T [key][row]

  const int tid = threadIdx.x;
  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;  // most k tiles first
  const int q0 = qt * kTile;
  const int kvh = h / (H / KV);
  const long long q_row = static_cast<long long>(H) * HD;
  const long long kv_row = static_cast<long long>(KV) * HD;
  const long long q_at = (static_cast<long long>(b) * Sq + q0) * q_row +
                         static_cast<long long>(h) * HD;
  const int n_kt =
      min(min(Sk / kTile, qt + 1), (sk_valid + kTile - 1) / kTile);
  auto load_kv = [&](int kt, int buf) {
    const long long at = (static_cast<long long>(b) * Sk + kt * kTile) *
                             kv_row + static_cast<long long>(kvh) * HD;
    copy_tiles<HD, NT>(Ks + buf * C::T, Vs + buf * C::T, k + at, v + at,
                            kv_row);
  };
  if (n_kt > 0) load_kv(0, 0);
  hopper::cp_async_commit();
  load_transposed<HD, NT>(Qt, dOt, q + q_at, dout + q_at, q_row);

  const int rx = tid % 16, ky = tid / 16;  // scores: rows 4 rx + i, keys SQ ky + j
  const int ad = tid % 8, ar = tid / 8;    // dQ: rows RK ar + i
  const long long at = (static_cast<long long>(b) * H + h) * Sq + q0 + 4 * rx;
  float nl[4], dl[4];
  load_vec<4>(nl, lse + at);
  load_vec<4>(dl, delta + at);
#pragma unroll
  for (int i = 0; i < 4; ++i) nl[i] = -nl[i] * kLog2e;
  const float c = scale * kLog2e;
  float acc[RK][NV * VW];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int j = 0; j < NV * VW; ++j) acc[i][j] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    if constexpr (C::STAGES == 1) {
      if (kt > 0) {
        __syncthreads();  // tile kt - 1 is consumed
        load_kv(kt, 0);
        hopper::cp_async_commit();
      }
    }
    hopper::cp_async_wait<0>();
    __syncthreads();  // tile kt has landed (and Q^T, dO^T are stored)
    if constexpr (C::STAGES == 2) {
      if (kt + 1 < n_kt) load_kv(kt + 1, (kt + 1) % 2);
      hopper::cp_async_commit();
    }
    const int buf = kt % C::STAGES;
    const int k0 = kt * kTile;
    const float* ks = Ks + buf * C::T;

    float s[4][SQ], dp[4][SQ];
    score_tile<HD, SQ>(s, dp, Qt, dOt, ks, Vs + buf * C::T, rx, ky);
    const bool mask = k0 + kTile > q0 || k0 + kTile > sk_valid;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * rx + i;
#pragma unroll
      for (int j = 0; j < SQ; ++j) {
        const int key = k0 + SQ * ky + j;
        float p = exp2f(fmaf(s[i][j], c, nl[i]));
        if (mask && (key > row || key >= sk_valid)) p = 0.f;
        dp[i][j] = p * (dp[i][j] - dl[i]);
      }
    }
    // dS^T [key][row]: a quarter-warp writes 32 neighbouring floats of a
    // key's row.
#pragma unroll
    for (int j = 0; j < SQ; ++j)
      *reinterpret_cast<float4*>(dSt + (SQ * ky + j) * kTile + 4 * rx) =
          make_float4(dp[0][j], dp[1][j], dp[2][j], dp[3][j]);
    __syncthreads();
    accumulate<HD, RK, VW, NV>(acc, dSt, ks, ar, ad);  // dQ += dS K
  }

  store_rows<RK, VW, NV>(dq + q_at + RK * ar * q_row, q_row, acc, scale, ad);
}

// ---- launch ---------------------------------------------------------------

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
int launch_delta(const T* out, const T* dout, float* delta, int B, int Sq,
                 int H, cudaStream_t stream) {
  const int rows = B * Sq * H;
  constexpr int per_cta = kDeltaThreads / DeltaTile<T, HD>::G;  // rows
  flash_bwd_delta_kernel<T, HD><<<(rows + per_cta - 1) / per_cta,
                                  kDeltaThreads, 0, stream>>>(
      out, dout, delta, rows, Sq, H);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_mma_hd(const bf16* q, const bf16* k, const bf16* v, const bf16* out,
                  const bf16* dout, const float* lse, float* delta, bf16* dq,
                  bf16* dk, bf16* dv, int B, int Sq, int Sk, int sk_valid,
                  int H, int KV, float scale, cudaStream_t stream) {
  using C = MmaBwdTile<HD>;
  cudaError_t err = allow_smem(flash_bwd_dkdv_mma_kernel<HD>, C::DKDV_BYTES);
  if (err == cudaSuccess)
    err = allow_smem(flash_bwd_dq_mma_kernel<HD>, C::DQ_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  int rc = launch_delta<bf16, HD>(out, dout, delta, B, Sq, H, stream);
  if (rc != 0) return rc;
  flash_bwd_dkdv_mma_kernel<HD>
      <<<dim3(KV, B, Sk / kTile), kMmaThreads, C::DKDV_BYTES, stream>>>(
          q, k, v, dout, lse, delta, dk, dv, Sq, Sk, sk_valid, H, KV, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_mma_kernel<HD>
      <<<dim3(H, B, Sq / kTile), kMmaThreads, C::DQ_BYTES, stream>>>(
          q, k, v, dout, lse, delta, dq, Sq, Sk, sk_valid, H, KV, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_simt_hd(const float* q, const float* k, const float* v,
                   const float* out, const float* dout, const float* lse,
                   float* delta, float* dq, float* dk, float* dv, int B,
                   int Sq, int Sk, int sk_valid, int H, int KV, float scale,
                   cudaStream_t stream) {
  using C = SimtBwdTile<HD>;
  cudaError_t err = allow_smem(flash_bwd_dkdv_simt_kernel<HD>, C::DKDV_BYTES);
  if (err == cudaSuccess)
    err = allow_smem(flash_bwd_dq_simt_kernel<HD>, C::DQ_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  int rc = launch_delta<float, HD>(out, dout, delta, B, Sq, H, stream);
  if (rc != 0) return rc;
  flash_bwd_dkdv_simt_kernel<HD>
      <<<dim3(KV, B, Sk / kTile), C::NT, C::DKDV_BYTES, stream>>>(
          q, k, v, dout, lse, delta, dk, dv, Sq, Sk, sk_valid, H, KV, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_simt_kernel<HD>
      <<<dim3(H, B, Sq / kTile), C::NT, C::DQ_BYTES, stream>>>(
          q, k, v, dout, lse, delta, dq, Sq, Sk, sk_valid, H, KV, scale);
  return static_cast<int>(cudaGetLastError());
}

#define K3_BWD_CASES(CASE) \
  CASE(8);                 \
  CASE(16);                \
  CASE(32);                \
  CASE(64);                \
  CASE(128);               \
  CASE(160)

}  // namespace

extern "C" {

// Launch the three kernels on `stream`; returns the CUDA error code (0 on
// success).  The caller guarantees contiguous operands of the layout above,
// 16-byte-aligned base pointers (cp.async and 16-byte loads), Sq and Sk
// multiples of 64, Sk - 64 < sk_valid <= Sk, H a multiple of KV, hd in {8,
// 16, 32, 64, 128, 160}; `lse` as K3 wrote it, `delta` an f32 (B, H, Sq)
// scratch buffer the first kernel fills.
int flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                            const void* out, const void* dout, const void* lse,
                            void* delta, void* dq, void* dk, void* dv, int B,
                            int Sq, int Sk, int sk_valid, int H, int KV, int hd,
                            float scale, void* stream) {
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* of = static_cast<const float*>(out);
  const float* gf = static_cast<const float*>(dout);
  const float* lf = static_cast<const float*>(lse);
  float* df = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
#define K3_BWD_SIMT(HD)                                                      \
  case HD:                                                                   \
    return launch_simt_hd<HD>(qf, kf, vf, of, gf, lf, df,                    \
                              static_cast<float*>(dq), static_cast<float*>(dk), \
                              static_cast<float*>(dv), B, Sq, Sk, sk_valid, H, \
                              KV, scale, s)
    K3_BWD_CASES(K3_BWD_SIMT);
#undef K3_BWD_SIMT
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                             const void* out, const void* dout,
                             const void* lse, void* delta, void* dq, void* dk,
                             void* dv, int B, int Sq, int Sk, int sk_valid,
                             int H, int KV, int hd, float scale,
                             void* stream) {
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* ob = static_cast<const bf16*>(out);
  const bf16* gb = static_cast<const bf16*>(dout);
  const float* lf = static_cast<const float*>(lse);
  float* df = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
#define K3_BWD_MMA(HD)                                                       \
  case HD:                                                                   \
    return launch_mma_hd<HD>(qb, kb, vb, ob, gb, lf, df,                     \
                             static_cast<bf16*>(dq), static_cast<bf16*>(dk), \
                             static_cast<bf16*>(dv), B, Sq, Sk, sk_valid, H, \
                             KV, scale, s)
    K3_BWD_CASES(K3_BWD_MMA);
#undef K3_BWD_MMA
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory a CTA of the dK/dV kernel (`dq` zero) or of the dQ
// kernel (`dq` nonzero) at head dim `hd` is launched with, in the bf16
// design (`bf16` nonzero, `MmaBwdTile`) or the f32 one (`SimtBwdTile`); -1
// for an hd that is not compiled.
int flash_attention_bwd_smem_bytes(int hd, int dq, int bf16) {
  switch (hd) {
#define K3_BWD_SMEM(HD)                                                      \
  case HD:                                                                   \
    return bf16 ? (dq ? MmaBwdTile<HD>::DQ_BYTES : MmaBwdTile<HD>::DKDV_BYTES) \
                : (dq ? SimtBwdTile<HD>::DQ_BYTES                            \
                      : SimtBwdTile<HD>::DKDV_BYTES)
    K3_BWD_CASES(K3_BWD_SMEM);
#undef K3_BWD_SMEM
    default: return -1;
  }
}

}  // extern "C"
