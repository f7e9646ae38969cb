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
//   query i when j <= i and j < sk_valid.  Sq and Sk are multiples of 64: the
//   wrapper pads the sequences with zeros at the end and passes the true key
//   count as sk_valid (a padded key j >= sk_valid could otherwise be seen by
//   a query i >= sk_valid when Sq > Sk), and pads hd with zero columns up to
//   a compiled head dim, passing the true hd^-0.5 as the scale.
//
// Numerics, as the reference kernel:
//   * scores are an f32 dot of the input-dtype q and k, times hd^-0.5;
//   * masked scores are -1e30;
//   * running max m, sum l and accumulator acc in f32 (online softmax);
//   * p is rounded to v's dtype before the PV product, l sums the unrounded p;
//   * out = acc / max(l, 1e-30), rounded to q's dtype (round to nearest even).
// Both kernels take the max and mask on the unscaled scores s and compute
// p = exp(hd^-0.5 (s - m)) as 2^(s c - m c), c = hd^-0.5 log2(e): one FFMA
// and one 2^x a score (bf16: ex2.approx, the instruction behind __expf;
// f32: exp2f).  Equal in exact arithmetic, it moves p by about 1e-7
// relative.
//
// Log-sum-exp, for training: given an `lse` buffer, each kernel also writes
// every row's lse = m * hd^-0.5 + ln(l) (natural log of the scaled scores'
// sum of exponentials; m is the raw-score max, l the sum of 2^(s c - m c)),
// f32 (B, H, Sq), which the backward (flash_attention_bwd.cu) turns back into
// P = exp(scale s - lse).  Each design's body is one device function with the
// store as a template flag (LSE), inlined into two kernels: serving passes no
// buffer and launches `flash_mma_kernel` / `flash_simt_kernel`, with the
// parameters and code they had before the store existed; training launches
// `flash_mma_lse_kernel` / `flash_simt_lse_kernel`.
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
// f32 -- `flash_simt_kernel`, true FP32 on the CUDA cores (explicit fmaf,
// never TF32): the register-tiled SGEMM of tiled_matmul.cu twice a k tile,
// with the online softmax between.  One CTA of 256 threads per (128-row q
// tile, query head, batch) walks k tiles of 64 keys.  A thread owns 4 query
// rows (4 ty + i) and 8 keys (tx + 8 j) of the score tile, and the same 4
// rows of the output (NV vectors of VW columns), so m, l and
// the correction stay in registers; a row's keys lie in the 8 lanes that
// share ty and its max is reduced by 3 shuffles (l stays a per-lane part,
// summed once at the end).  Shared memory holds Q^T [hd][128], K^T
// [hd][64] (a thread's keys in two float4 runs), V [64][hd] in two stages
// (one above hd 128, where two would not fit)
// and P^T [64][128 + 4], so every inner-loop read is one 16-byte LDS that
// is conflict-free or a broadcast: 3 of them feed 32 FMAs in QK^T and
// 1 + NV feed 4 NV VW in PV; a quarter-warp's P^T stores go to 8
// neighbouring rows, which the padding puts in 8 bank groups.  V tiles
// come by cp.async in a two-stage ring (with one stage, during their own
// tile's QK^T).  K is transposed on its way in
// (cp.async cannot): the next tile moves in two parts, each loaded as
// float4 into registers before a half of PV and stored after it, 32 lanes
// on 32 neighbouring keys.  P^T is written and read by one warp.  Two
// barriers a k tile.  When Sq is an odd multiple of 64 the smallest q tile
// is the half one: its first four warps own no row.  A warp skips a k tile
// that starts past its last row, and masks only a tile that reaches past
// its first.  hd 8 and 16 keep their output columns below one 16-byte
// vector (VW 1 and 2) instead of guarding a wider one.
//
// Both skip tiles above the diagonal and run the largest q tiles (most k
// tiles) first.  The skip is exact: the k tile at 0 is never fully masked
// for any query row (key 0 is visible to every query), so m is finite after
// the first tile, and a fully masked tile would add exp(-1e30 - m) = 0 to l
// and to acc with corr = exp(0) = 1.  The sk_valid bound masks keys of the
// last k tile only (the wrapper pads fewer than 64 keys), in the same pass
// as the diagonal.
//
// Bound: operations.  At the serve prefill shape (B 8, S 1088, H 15, hd 64)
// the causal work is ~2 * B * H * S^2 * hd = 18 GFLOP against 45 MB of
// q, k, v and out: at the bf16 tensor-core peak that is ~18 us, above the
// ~13 us the bytes take at 3.35 TB/s; in f32 on the CUDA cores (67 TFLOP/s)
// it is 0.27 ms.  The bf16 kernel runs at ~6x its bound.
// Cutting its K/V reads from L2 (3 query heads a CTA, or 128-row q tiles)
// and deepening the cp.async ring did not move it, and neither did 32 rows
// a warp; folding the scale into exp2 and hoisting the ldmatrix addresses
// did (PERF.md).  What is left is each warp's serial chain of QK^T, softmax
// and PV at 12 warps an SM; a wgmma version is the next step.  The f32
// kernel is bound by the rate FMAs dispatch, and by the shared-memory
// reads that feed them: a warp's 16-byte LDS is served a quarter-warp at a
// time, so the shared-memory cycles follow the floats each lane reads per
// FMA, 1/4 + 1/8 for a 4 x 8 register tile.  Its design keeps that and
// every other instruction (exp2f, shuffles, staging) small beside the
// FMAs, and two CTAs (16 warps) an SM at hd 64 (113 KB of shared memory
// and at most 128 registers each).  An 8 x 8 tile reads a third fewer
// floats per FMA but needs 64 score and 64 output registers a thread, and
// ran slower (PERF.md).  With the warps' skip its 128-row q tiles compute
// the scores of two 64-row tiles (6% above the causal triangle at S 1088)
// for half the K/V staging a query.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kTile = 64;  // keys per k tile; also q rows per bf16 q tile
constexpr float kNeg = -1e30f;

// ---- f32: CUDA cores ----------------------------------------------------

constexpr int kSimtRows = 128;  // q rows per CTA
constexpr int kSimtThreads = 256;  // 32 row groups x 8 key groups
constexpr int kSimtKParts = 2;  // the next K tile moves in this many parts

template <int HD>
struct SimtTile {
  static constexpr int QT = HD * kSimtRows;     // Q^T [HD][128]
  static constexpr int KT = HD * kTile;         // K^T [HD][64]
  static constexpr int V = kTile * HD;          // V [64][HD], one stage
  // Two V stages up to hd 128; one above, where two would not fit a CTA's
  // 227 KB (hd 160: 238,592 bytes with two, 197,632 with one).
  static constexpr int V_STAGES = HD <= 128 ? 2 : 1;
  static constexpr int PT_ROW = kSimtRows + 4;  // P^T row, padded
  static constexpr int PT = kTile * PT_ROW;      // P^T [64][128 + 4]
  static constexpr int BYTES = 4 * (QT + KT + V_STAGES * V + PT);
  // A thread's output columns: NV vectors of VW, at VW * tx + 8 * VW * j.
  static constexpr int VW = HD >= 32 ? 4 : HD / 8;
  static constexpr int NV = HD / (8 * VW);
  // Two CTAs an SM where both fit (2 x 113 KB of shared memory, the SM's
  // 228 KB, and at most 128 registers at hd 64).
  static constexpr int MIN_CTAS = HD <= 64 ? 2 : 1;
};

template <int W>
__device__ __forceinline__ void load_vec(float (&r)[W], const float* p) {
  if constexpr (W == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    r[0] = t.x, r[1] = t.y, r[2] = t.z, r[3] = t.w;
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

template <int HD, bool LSE>
__device__ __forceinline__ void flash_simt_body(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out,
    float* __restrict__ lse, int Sq, int Sk, int sk_valid, int H, int KV,
    float scale) {
  using C = SimtTile<HD>;
  constexpr int R = kSimtRows, NT = kSimtThreads;
  constexpr int VW = C::VW, NV = C::NV;
  constexpr int CH = HD / 4;                         // float4 of a row
  constexpr int Q_STEP = NT / R;                     // Q float4 columns a pass
  constexpr int K_STEP = NT / kTile;                 // K float4 columns a pass
  constexpr int K_VECS = (CH + K_STEP - 1) / K_STEP;  // hd 8: not all threads
  constexpr int K_PARTS = K_VECS < kSimtKParts ? K_VECS : kSimtKParts;
  constexpr int K_PART = K_VECS / K_PARTS;           // float4 held a part
  constexpr int V_STEP = NT / CH;                    // V rows a pass
  // hd 160: 40 float4 a row do not divide 256 threads; the last 16 idle.
  constexpr int V_THREADS = V_STEP * CH;
  constexpr int V_VECS = (kTile + V_STEP - 1) / V_STEP;
  constexpr int PV_KEYS = kTile / K_PARTS;           // PV keys a part
  static_assert(K_VECS % K_PARTS == 0, "K staging parts");
  extern __shared__ float4 simt_smem[];
  float* Qt = reinterpret_cast<float*>(simt_smem);  // [HD][128]
  float* Kt = Qt + C::QT;                           // [HD][64]
  float* Vs = Kt + C::KT;                           // [V_STAGES][64][HD]
  float* Pt = Vs + C::V_STAGES * C::V;              // [64][128 + 4]

  const int tid = threadIdx.x;
  const int tx = tid % 8;  // keys tx + 8 j (j < 8)
  const int ty = tid / 8;  // rows 4 ty + i (i < 4); a warp is 4 ty x 8 tx
  const int warp = tid / 32;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  // Largest q tiles (most k tiles) first, over every (head, batch).  When
  // Sq is an odd multiple of 64, tile 0 starts 64 rows before row 0: its
  // first four warps own no row and skip every k tile.
  const int lead = (R - Sq % R) % R;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * R - lead;
  const int w_first = q0 + 16 * warp;  // this warp's rows
  const int w_last = w_first + 15;
  const int kvh = h / (H / KV);
  const long long q_row = static_cast<long long>(H) * HD;
  const long long kv_row = static_cast<long long>(KV) * HD;
  const long long kv_tile = kTile * kv_row;

  // Staging.  A thread's row and column are fixed and its passes step by
  // constant offsets, so no address is held per pass.  Q and K go in
  // transposed: float4 loads along d into registers, then scalar stores
  // whose 32 lanes sit on 32 neighbouring rows (no bank conflict).  V goes
  // in as it is, by cp.async.
  const int q_r = tid % R, q_c = tid / R;
  const int k_key = tid % kTile, k_c = tid / kTile;
  const int v_key = tid / CH, v_c = tid % CH;
  const float* q_src = q + (static_cast<long long>(b) * Sq + q0 + q_r) * q_row +
                       static_cast<long long>(h) * HD + 4 * q_c;
  const float* k_src = k + (static_cast<long long>(b) * Sk + k_key) * kv_row +
                       static_cast<long long>(kvh) * HD + 4 * k_c;
  const float* v_src = v + (static_cast<long long>(b) * Sk + v_key) * kv_row +
                       static_cast<long long>(kvh) * HD + 4 * v_c;
  // K^T's column of key tx + 8 j is 4 tx + j (j < 4) or 32 + 4 tx + j - 4,
  // so a thread's 8 keys are two float4 runs there, and the 8 lanes of a
  // quarter-warp write its P^T rows to 8 neighbouring rows.
  float* k_dst = Kt + 4 * k_c * kTile + (k_key / 32) * 32 + 4 * (k_key % 8) +
                 (k_key % 32) / 8;
  float* v_dst = Vs + v_key * HD + 4 * v_c;

  float4 k_stage[K_PART];
  auto load_k = [&](int kt, int part) {
    const float* src = k_src + kt * kv_tile;
#pragma unroll
    for (int i = 0; i < K_PART; ++i) {
      const int p = part * K_PART + i;
      if (k_c + K_STEP * p < CH)
        k_stage[i] = *reinterpret_cast<const float4*>(src + 4 * K_STEP * p);
    }
  };
  auto store_k = [&](int part) {
#pragma unroll
    for (int i = 0; i < K_PART; ++i) {
      const int p = part * K_PART + i;
      if (k_c + K_STEP * p < CH) {
        float* dst = k_dst + 4 * K_STEP * p * kTile;
        dst[0 * kTile] = k_stage[i].x;
        dst[1 * kTile] = k_stage[i].y;
        dst[2 * kTile] = k_stage[i].z;
        dst[3 * kTile] = k_stage[i].w;
      }
    }
  };
  auto load_v = [&](int kt, int buf) {
    const float* src = v_src + kt * kv_tile;
    float* dst = v_dst + buf * C::V;
#pragma unroll 1
    for (int p = 0; p < V_VECS; ++p) {
      if (tid < V_THREADS && v_key + V_STEP * p < kTile)
        hopper::cp_async16(dst + V_STEP * p * HD, src);
      src += V_STEP * kv_row;
    }
  };

  load_v(0, 0);
  hopper::cp_async_commit();
#pragma unroll
  for (int p = 0; p < CH / Q_STEP; ++p) {
    const float4 x =
        q0 + q_r >= 0
            ? *reinterpret_cast<const float4*>(q_src + 4 * Q_STEP * p)
            : make_float4(0.f, 0.f, 0.f, 0.f);
    float* dst = Qt + 4 * (q_c + Q_STEP * p) * R + q_r;
    dst[0 * R] = x.x;
    dst[1 * R] = x.y;
    dst[2 * R] = x.z;
    dst[3 * R] = x.w;
  }
#pragma unroll
  for (int part = 0; part < K_PARTS; ++part) {
    load_k(0, part);
    store_k(part);
  }
  __syncthreads();

  // exp(scale * (s - m)) = 2^(s * c - m * c): max and masking on the raw
  // scores (scale > 0), one FFMA and one exp2f a score.
  const float cexp = scale * 1.4426950408889634f;
  float o[4][NV * VW];
  float m[4], l[4];  // raw-score max of each row; this lane's part of l
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NV * VW; ++j) o[i][j] = 0.f;
  }
  const float* q_s = Qt + 4 * ty;
  const float* k_s = Kt + 4 * tx;
  const float* p_s = Pt + 4 * ty;
  constexpr int PR = C::PT_ROW;

  const int n_kt = min(Sk / kTile, (q0 + R) / kTile);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    const bool more = kt + 1 < n_kt;
    // Two stages: V tile kt + 1 loads during tile kt.  One stage: V tile kt
    // loads during its own QK^T (tile 0 before the loop).
    if constexpr (C::V_STAGES == 2) {
      if (more) load_v(kt + 1, (kt + 1) % 2);
    } else {
      if (kt > 0) load_v(kt, 0);
    }
    hopper::cp_async_commit();
    // A warp whose rows all precede the tile's first key skips it: its
    // scores would all be masked, adding 0 to l and acc with corr = 1.
    const bool active = k0 <= w_last;
    if (active) {
      float s[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
      // S = Q K^T: per d, one LDS.128 of Q^T (a broadcast to the 8 lanes
      // of a row group) and two of K^T (128 contiguous bytes each) feed 32
      // FMAs.
#pragma unroll 16
      for (int d = 0; d < HD; ++d) {
        float a[4], k_lo[4], k_hi[4];
        load_vec<4>(a, q_s + d * R);
        load_vec<4>(k_lo, k_s + d * kTile);
        load_vec<4>(k_hi, k_s + d * kTile + 32);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(a[i], k_lo[j], s[i][j]);
            s[i][j + 4] = fmaf(a[i], k_hi[j], s[i][j + 4]);
          }
      }

      // Mask (tiles that reach past the warp's first row or past the last
      // true key), online softmax.
      if (k0 + kTile - 1 > w_first || k0 + kTile > sk_valid) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (k0 + tx + 8 * j > q0 + 4 * ty + i ||
                k0 + tx + 8 * j >= sk_valid)
              s[i][j] = kNeg;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float mx = s[i][0];
#pragma unroll
        for (int j = 1; j < 8; ++j) mx = fmaxf(mx, s[i][j]);
        // The row's 64 keys lie in the 8 lanes that share ty.
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        const float m_new = fmaxf(m[i], mx);
        const float corr = exp2f((m[i] - m_new) * cexp);
        const float mc = -m_new * cexp;
        m[i] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = exp2f(fmaf(s[i][j], cexp, mc));
          sum += s[i][j];
        }
        l[i] = fmaf(l[i], corr, sum);
#pragma unroll
        for (int j = 0; j < NV * VW; ++j) o[i][j] *= corr;
      }
      // P^T [key][row]: one 16-byte store of a key's 4 rows; rows padded
      // by 4 floats, the 8 lanes of a quarter-warp hit 8 bank groups.  A
      // row group's P^T is written and read by its own warp only.
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<float4*>(Pt + (tx + 8 * j) * PR + 4 * ty) =
            make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    if (more) load_k(kt + 1, 0);
    hopper::cp_async_wait<C::V_STAGES - 1>();
    __syncthreads();  // V tile kt has landed; every warp is done with K^T

    // O += P V: per key, one LDS.128 of P^T (a broadcast to the row group)
    // and NV of V (contiguous across the 8 lanes) feed 4 NV VW FMAs.  The
    // next K tile moves in parts between blocks of keys, so each part's
    // loads overlap a block of products.
    const float* v_s = Vs + (kt % C::V_STAGES) * C::V + VW * tx;
#pragma unroll
    for (int part = 0; part < K_PARTS; ++part) {
      if (active) {
#pragma unroll 16
        for (int c = part * PV_KEYS; c < (part + 1) * PV_KEYS; ++c) {
          float p[4];
          load_vec<4>(p, p_s + c * PR);
#pragma unroll
          for (int jv = 0; jv < NV; ++jv) {
            float vv[VW];
            load_vec<VW>(vv, v_s + c * HD + 8 * VW * jv);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int w = 0; w < VW; ++w)
                o[i][jv * VW + w] = fmaf(p[i], vv[w], o[i][jv * VW + w]);
          }
        }
      }
      if (more) {
        store_k(part);
        if (part + 1 < K_PARTS) load_k(kt + 1, part + 1);
      }
    }
    __syncthreads();  // K^T holds tile kt + 1; V and P^T may be refilled
  }

  if (w_last < 0) return;  // the rows before row 0 of a leading tile
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 4);
    const float denom = fmaxf(l[i], 1e-30f);
    if constexpr (LSE) {
      if (tx == 0)
        lse[(static_cast<long long>(b) * H + h) * Sq + q0 + 4 * ty + i] =
            m[i] * scale + logf(denom);
    }
    float* orow = out + (static_cast<long long>(b) * Sq + q0 + 4 * ty + i) *
                            q_row + static_cast<long long>(h) * HD + VW * tx;
#pragma unroll
    for (int jv = 0; jv < NV; ++jv) {
      float r[VW];
#pragma unroll
      for (int w = 0; w < VW; ++w) r[w] = o[i][jv * VW + w] / denom;
      store_vec<VW>(orow + 8 * VW * jv, r);
    }
  }
}

// The serving kernel keeps the parameters and code it had before the lse
// store existed; the training kernel also stores the lse.
template <int HD>
__global__ void __launch_bounds__(kSimtThreads, SimtTile<HD>::MIN_CTAS)
flash_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out,
                  int Sq, int Sk, int sk_valid, int H, int KV, float scale) {
  flash_simt_body<HD, false>(q, k, v, out, nullptr, Sq, Sk, sk_valid, H, KV,
                             scale);
}

template <int HD>
__global__ void __launch_bounds__(kSimtThreads, SimtTile<HD>::MIN_CTAS)
flash_simt_lse_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out,
                      float* __restrict__ lse, int Sq, int Sk, int sk_valid,
                      int H, int KV, float scale) {
  flash_simt_body<HD, true>(q, k, v, out, lse, Sq, Sk, sk_valid, H, KV, scale);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool carveout) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && carveout)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

template <int HD, bool LSE>
int launch_simt_hd(const float* q, const float* k, const float* v, float* out,
                   float* lse, int B, int Sq, int Sk, int sk_valid, int H,
                   int KV, float scale, cudaStream_t stream) {
  constexpr int bytes = SimtTile<HD>::BYTES;
  const cudaError_t err =
      LSE ? allow_smem(flash_simt_lse_kernel<HD>, bytes, true)
          : allow_smem(flash_simt_kernel<HD>, bytes, true);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, B, (Sq + kSimtRows - 1) / kSimtRows);
  if constexpr (LSE)
    flash_simt_lse_kernel<HD><<<grid, kSimtThreads, bytes, stream>>>(
        q, k, v, out, lse, Sq, Sk, sk_valid, H, KV, scale);
  else
    flash_simt_kernel<HD><<<grid, kSimtThreads, bytes, stream>>>(
        q, k, v, out, Sq, Sk, sk_valid, H, KV, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(const void* q, const void* k, const void* v, void* out,
               void* lse, int B, int Sq, int Sk, int sk_valid, int H, int KV,
               int hd, float scale, void* stream) {
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(out);
  float* lf = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K3_SIMT(HD)                                                         \
  case HD:                                                                  \
    return lf ? launch_simt_hd<HD, true>(qf, kf, vf, of, lf, B, Sq, Sk,     \
                                         sk_valid, H, KV, scale, s)         \
              : launch_simt_hd<HD, false>(qf, kf, vf, of, lf, B, Sq, Sk,    \
                                          sk_valid, H, KV, scale, s)
  switch (hd) {
    K3_SIMT(8);
    K3_SIMT(16);
    K3_SIMT(32);
    K3_SIMT(64);
    K3_SIMT(128);
    K3_SIMT(160);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef K3_SIMT
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

template <int HD, bool LSE>
__device__ __forceinline__ void flash_mma_body(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ out,
    float* __restrict__ lse, int Sq, int Sk, int sk_valid, int H, int KV,
    float scale) {
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

    // Mask (the diagonal tile and the tile of the last true key), online
    // softmax.
    const int k0 = kt * kTile;
    if (k0 + kTile > q0 || k0 + kTile > sk_valid) {
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + nb * 8 + 2 * t + (e & 1);
          if (key > row0 + 8 * (e / 2) || key >= sk_valid) s[nb][e] = kNeg;
        }
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
  if constexpr (LSE) {
    if (t == 0) {
      float* lrow = lse + (static_cast<long long>(b) * H + h) * Sq + row0;
      lrow[0] = m[0] * scale + logf(denom[0]);
      lrow[8] = m[1] * scale + logf(denom[1]);
    }
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
__global__ void __launch_bounds__(kWarps * 32)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out, int Sq,
                 int Sk, int sk_valid, int H, int KV, float scale) {
  flash_mma_body<HD, false>(q, k, v, out, nullptr, Sq, Sk, sk_valid, H, KV,
                            scale);
}

template <int HD>
__global__ void __launch_bounds__(kWarps * 32)
flash_mma_lse_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     float* __restrict__ lse, int Sq, int Sk, int sk_valid,
                     int H, int KV, float scale) {
  flash_mma_body<HD, true>(q, k, v, out, lse, Sq, Sk, sk_valid, H, KV, scale);
}

template <int HD, bool LSE>
int launch_mma_hd(const void* q, const void* k, const void* v, void* out,
                  float* lse, int B, int Sq, int Sk, int sk_valid, int H,
                  int KV, float scale, cudaStream_t stream) {
  constexpr int bytes = MmaTile<HD>::BYTES;
  const cudaError_t err =
      LSE ? allow_smem(flash_mma_lse_kernel<HD>, bytes, false)
          : allow_smem(flash_mma_kernel<HD>, bytes, false);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(Sq / kTile, H, B);
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  bf16* ob = static_cast<bf16*>(out);
  if constexpr (LSE)
    flash_mma_lse_kernel<HD><<<grid, kWarps * 32, bytes, stream>>>(
        qb, kb, vb, ob, lse, Sq, Sk, sk_valid, H, KV, scale);
  else
    flash_mma_kernel<HD><<<grid, kWarps * 32, bytes, stream>>>(
        qb, kb, vb, ob, Sq, Sk, sk_valid, H, KV, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16(const void* q, const void* k, const void* v, void* out,
                void* lse, int B, int Sq, int Sk, int sk_valid, int H, int KV,
                int hd, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lf = static_cast<float*>(lse);
#define K3_MMA(HD)                                                          \
  case HD:                                                                  \
    return lf ? launch_mma_hd<HD, true>(q, k, v, out, lf, B, Sq, Sk,        \
                                        sk_valid, H, KV, scale, s)          \
              : launch_mma_hd<HD, false>(q, k, v, out, lf, B, Sq, Sk,       \
                                         sk_valid, H, KV, scale, s)
  switch (hd) {
    K3_MMA(8);
    K3_MMA(16);
    K3_MMA(32);
    K3_MMA(64);
    K3_MMA(128);
    K3_MMA(160);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef K3_MMA
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the CUDA error code (0 on success).  The caller
// guarantees contiguous operands of the layout above, Sq and Sk multiples of
// 64, Sk - 64 < sk_valid <= Sk, H a multiple of KV, hd in {8, 16, 32, 64,
// 128, 160}, and 16-byte-aligned base pointers (cp.async and the f32
// kernel's loads and stores move 16 bytes at a time).  `lse` is null, or an
// f32 (B, H, Sq) buffer that receives each row's log-sum-exp of the scaled
// scores, m * scale + ln(l) (natural log; the backward's P = exp(scale s -
// lse)).  A null `lse` runs the instances without the store (LSE false),
// the code the serving path has always run.
int flash_attention_f32(const void* q, const void* k, const void* v, void* out,
                        void* lse, int B, int Sq, int Sk, int sk_valid, int H,
                        int KV, int hd, float scale, void* stream) {
  return launch_f32(q, k, v, out, lse, B, Sq, Sk, sk_valid, H, KV, hd, scale,
                    stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                         void* lse, int B, int Sq, int Sk, int sk_valid, int H,
                         int KV, int hd, float scale, void* stream) {
  return launch_bf16(q, k, v, out, lse, B, Sq, Sk, sk_valid, H, KV, hd, scale,
                     stream);
}

// Dynamic shared memory a CTA of the kernel for `hd` is launched with (bf16
// when `bf16` is nonzero, else f32); -1 for an hd that is not compiled.
int flash_attention_smem_bytes(int hd, int bf16) {
  switch (hd) {
    case 8: return bf16 ? MmaTile<8>::BYTES : SimtTile<8>::BYTES;
    case 16: return bf16 ? MmaTile<16>::BYTES : SimtTile<16>::BYTES;
    case 32: return bf16 ? MmaTile<32>::BYTES : SimtTile<32>::BYTES;
    case 64: return bf16 ? MmaTile<64>::BYTES : SimtTile<64>::BYTES;
    case 128: return bf16 ? MmaTile<128>::BYTES : SimtTile<128>::BYTES;
    case 160: return bf16 ? MmaTile<160>::BYTES : SimtTile<160>::BYTES;
    default: return -1;
  }
}

}  // extern "C"
