// The GP's whole hyperparameter fit for Hopper (sm_90a): K4, gp_fit_kernel.
// Plain PyTorch twin of the algorithm: tests/gp_fit_reference.py gp_fit_ref;
// the eager fit it replaces on the card: repro_torch.core.gp._fit.
//
//   in   X (L,b,d)  y (L,b)  mask (L,b): each run's rows, real rows first
//        p0         the initial parameters, one block a key in sorted key
//                   order, each block (L, width) row-major:
//                     linear  log_bias, log_tau, log_w (L,d), mean_const
//                     se      log_alpha, log_ell, log_tau, mean_const
//        bc (2,steps)  Adam's bias corrections 1 - 0.9^t, then 1 - 0.999^t
//   out  p1         the fitted parameters, the same layout
//
// One CTA a run fits it on its n real rows (the mask's sum; padding trails
// and has no influence on the NLL): `steps` steps of Adam on the negative
// marginal log-likelihood, betas 0.9 / 0.999, eps 1e-8 outside the square
// root, each with the gradient in closed form,
//
//   dNLL/dtheta = 0.5 tr(W dK/dtheta),  W = K^-1 - alpha alpha^T,
//   alpha = K^-1 r,  r = y - mean_const:
//
//   log_w_j     w_j^2 x_j^T W x_j          log_alpha  sum W o K_se
//   log_bias    b^2 1^T W 1                log_ell    sum W o K_se o d^2 / ell^2
//   log_tau     noise tr W (0 when pinned) mean_const -sum alpha
//
// Three forms, the objective the eager fit uses for the shape:
//   kCholLinear, kCholSe  K (n <= 64) in shared memory; a right-looking
//       Cholesky factor with one barrier a column (L stored transposed in
//       the upper triangle, its diagonal apart, so a column's readers never
//       meet its writers); Z = L^-1 by substitution, 4 or 8 lanes a column;
//       q = Z r, alpha = Z^T q.  Linear: Y = Z [X, 1], and
//         x_j^T W x_j = |Y_:j|^2 - (Y_:j^T q)^2,  tr W = |Z|_F^2 - |alpha|^2,
//       never K^-1, whose entries reach 1 / noise in the pinned-noise fits
//       (cond K ~ 1e12) while these stay of order one.  SE (noisy, well
//       conditioned): K^-1 = Z^T Z and W on the fly.
//   kWoodbury  a stacked linear fit above 32 padded rows: K = V V^T + D I
//       with V = [X w, b] (n x (d+1)) and D = noise + jitter, so with
//       G = V^T V / D, A = I + G = L_A L_A^T, S = L_A^-1 G, s = A^-1 V^T r / D:
//         V^T alpha = s,   v_j^T K^-1 v_j = (I - A^-1)_jj = G_jj - |S_:j|^2,
//         tr K^-1 = (n - sum L_A^-1 o S) / D,   alpha = (r - V s) / D,
//       O(n d^2) a step, never the n x n inverse.
// A non-positive (or NaN) pivot makes that step's gradient NaN, so the
// run's parameters turn NaN, as the eager fit's do.
//
// Numerics: float64 throughout, built with -fmad=false; Adam's update is
// `_fit`'s, operation for operation (a divide by a host scalar is a multiply
// by its reciprocal there, as PyTorch's CUDA division by a scalar does).
// The gradients are those of the eager fit's autograd in exact arithmetic,
// not bit for bit.
//
// Bound: the latency of one CTA's dependent chain.  A step is ~10^5 flops a
// run; a stack is 1-10 runs, so the card holds a CTA a run on separate SMs
// and the time is the step's critical path (n barriers of the factor, n
// short substitution steps) times the steps.  Everything a step touches
// lives in shared memory; global memory is read once and written once.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 32;
constexpr int kMaxParams = kMaxD + 3;
constexpr int kMaxCholRows = 64;
constexpr int kMaxWoodRows = 512;
constexpr int kTile = 16;           // the factor's update: 16 x 16 threads
constexpr int kPerThread = 4;       // rows (and columns) a thread updates, <= 64 / 16
constexpr double kJitter = 1e-6;

enum Form { kCholLinear = 0, kCholSe = 1, kWoodbury = 2 };

__host__ __device__ inline int odd_pitch(int n) { return n | 1; }

// Offsets (in doubles) of each shared array; `total` is the CTA's count.
struct Carve {
  size_t A, B, C, S, X, y, r, alpha, q, rd, wv, u, sv, hv, prm, m1, m2, grad,
      red, total;
};

__host__ __device__ inline Carve carve(int form, int rows, int d) {
  Carve c{};
  size_t o = 0;
  const int m = d + 1;
  if (form == kWoodbury) {
    const size_t sq = (size_t)m * odd_pitch(m);
    c.A = o; o += sq;          // I + G, then its factor
    c.B = o; o += sq;          // L_A^-1
    c.C = o; o += sq;          // G
    c.S = o; o += sq;          // L_A^-1 G
    c.X = o; o += (size_t)rows * d;
    c.y = o; o += rows;
    c.r = o; o += rows;
    c.alpha = o; o += rows;
    c.rd = o; o += m;
    c.wv = o; o += m;
    c.u = o; o += m;
    c.q = o; o += m;
    c.sv = o; o += m;
    c.hv = o; o += m;
  } else {
    const size_t sq = (size_t)rows * odd_pitch(rows);
    c.A = o; o += sq;          // K, its factor, then (SE) K^-1
    c.B = o; o += sq;          // L^-1
    // SE: the squared distances; linear: X w, then L^-1 [X, 1]
    c.C = o; o += form == kCholSe ? sq : (size_t)rows * m;
    c.S = c.C;
    c.X = o; o += (size_t)rows * d;
    c.y = o; o += rows;
    c.r = o; o += rows;
    c.alpha = o; o += rows;
    c.q = o; o += rows;
    c.rd = o; o += rows;
    c.wv = o; o += m;
    c.u = c.sv = c.hv = c.wv;
  }
  c.prm = o; o += kMaxParams;
  c.m1 = o; o += kMaxParams;
  c.m2 = o; o += kMaxParams;
  c.grad = o; o += kMaxParams;
  c.red = o; o += kWarps * 4;
  c.total = o;
  return c;
}

__device__ inline double nan_value() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

// Block-wide sums of N values, the same bits in every thread (the butterfly
// adds a + b in one lane and b + a in its partner; the warps' partials are
// added in one order).  Every thread calls it.
template <int N>
__device__ inline void block_sum(double (&v)[N], double* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] += __shfl_xor_sync(0xffffffffu, v[k], o);
  if ((threadIdx.x & 31) == 0)
#pragma unroll
    for (int k = 0; k < N; ++k) red[(threadIdx.x >> 5) * N + k] = v[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k) {
    double acc = 0.0;
    for (int w = 0; w < kWarps; ++w) acc += red[w * N + k];
    v[k] = acc;
  }
  __syncthreads();
}

// Right-looking Cholesky factor of the n x n (n <= 64) symmetric matrix in
// A's lower triangle (pitch P): 1 / L's diagonal to rd, its strictly lower
// part to A's upper triangle (A[k][i] = L[i][k]).  A column is scaled by
// the pivot's reciprocal, as LAPACK's unblocked factor does: one divide a
// column, not one an entry (a divide is the longest op on the chain).  Column k is read in step k
// (A[i][k], i >= k) and written to row k; the trailing update writes A[i][j],
// i >= j > k: no address is both read and written in a step, so one barrier
// a column.  False (every thread alike) on a pivot that is not positive.
__device__ bool factor(double* A, int P, int n, double* rd) {
  const int tx = threadIdx.x % kTile, ty = threadIdx.x / kTile;
  for (int k = 0; k < n; ++k) {
    const double akk = A[k * P + k];
    if (!(akk > 0.0)) return false;
    const double rs = 1.0 / sqrt(akk);
    double li[kPerThread], lj[kPerThread];
#pragma unroll
    for (int a = 0; a < kPerThread; ++a) {
      const int i = k + 1 + ty + kTile * a, j = k + 1 + tx + kTile * a;
      li[a] = i < n ? A[i * P + k] * rs : 0.0;
      lj[a] = j < n ? A[j * P + k] * rs : 0.0;
    }
    if (threadIdx.x == 0) rd[k] = rs;
#pragma unroll
    for (int a = 0; a < kPerThread; ++a) {
      const int i = k + 1 + ty + kTile * a;
      if (i >= n) continue;
      if (tx == 0) A[k * P + i] = li[a];
#pragma unroll
      for (int c = 0; c < kPerThread; ++c) {
        const int j = k + 1 + tx + kTile * c;
        if (j <= i) A[i * P + j] -= li[a] * lj[c];
      }
    }
    __syncthreads();
  }
  return true;
}

// Z = L^-1 (lower, diagonal included) into Z (pitch P) from `factor`'s
// output, by forward substitution, Z_ic = -(sum_{c<=k<i} L_ik Z_kc) / L_ii:
// 8 lanes a column up to 32 columns, 4 up to 64, their partial sums joined
// by shuffles.  Ends with a barrier.
__device__ void invert_lower(const double* A, int P, int n, const double* rd,
                             double* Z) {
  const int lanes = n <= 32 ? 8 : 4;
  const int c = threadIdx.x / lanes, lane = threadIdx.x % lanes;
  const bool on = c < n;
  if (on && lane == 0) Z[c * P + c] = rd[c];
  __syncwarp();
  for (int i = 1; i < n; ++i) {
    double part = 0.0;
    if (on && i > c)
      for (int k = c + lane; k < i; k += lanes)
        part += A[k * P + i] * Z[k * P + c];
    for (int o = 1; o < lanes; o <<= 1)
      part += __shfl_xor_sync(0xffffffffu, part, o);
    if (on && i > c && lane == 0) Z[i * P + c] = -part * rd[i];
    __syncwarp();
  }
  __syncthreads();
}

// One step's gradient of the Cholesky forms into g[0..np); false where the
// factor fails.  Parameters (internal order): linear log_w[0..d), log_bias,
// log_tau, mean_const; se log_alpha, log_ell, log_tau, mean_const.
template <int FORM>
__device__ bool grad_cholesky(double* sm, const Carve& c, int n, int d,
                              int P) {
  const int tid = threadIdx.x;
  const int np = FORM == kCholSe ? 4 : d + 3;
  double *A = sm + c.A, *B = sm + c.B, *C = sm + c.C, *X = sm + c.X;
  double *r = sm + c.r, *alpha = sm + c.alpha, *q = sm + c.q;
  const double* prm = sm + c.prm;
  const double noise = exp(2.0 * prm[np - 2]);
  const double dg = noise + kJitter;
  const double cst = prm[np - 1];
  double a2 = 0.0, ell2 = 0.0, b2 = 0.0;
  if (FORM == kCholSe) {
    const double al = exp(prm[0]), el = exp(prm[1]);
    a2 = al * al;
    ell2 = el * el;
  } else {
    const double bb = exp(prm[d]);
    b2 = bb * bb;
    for (int j = tid; j < d; j += kThreads) sm[c.wv + j] = exp(prm[j]);
  }
  for (int i = tid; i < n; i += kThreads) r[i] = sm[c.y + i] - cst;
  if (FORM == kCholLinear) {
    __syncthreads();
    for (int idx = tid; idx < n * d; idx += kThreads)
      C[idx] = X[idx] * sm[c.wv + idx % d];
  }
  __syncthreads();
  for (int idx = tid; idx < n * n; idx += kThreads) {
    const int i = idx / n, k = idx - i * n;
    double v;
    if (FORM == kCholSe) {
      v = a2 * exp(-C[i * P + k] / ell2);
    } else {
      double acc = 0.0;
      for (int j = 0; j < d; ++j) acc += C[i * d + j] * C[k * d + j];
      v = acc + b2;
    }
    if (i == k) v += dg;
    A[i * P + k] = v;
  }
  __syncthreads();
  if (!factor(A, P, n, sm + c.rd)) return false;
  invert_lower(A, P, n, sm + c.rd, B);
  const int m = d + 1;
  double* g = sm + c.grad;
  // q = Z r (Z = L^-1 in B); SE: K^-1 = Z^T Z into A (the factor is
  // spent); linear: Y = Z [X, 1] into C (X w is spent) and |Z|_F^2.
  double zz[1] = {0.0};
  for (int k = tid; k < n; k += kThreads) {
    double acc = 0.0;
    for (int i = 0; i <= k; ++i) acc += B[k * P + i] * r[i];
    q[k] = acc;
  }
  if (FORM == kCholSe) {
    for (int idx = tid; idx < n * n; idx += kThreads) {
      const int i = idx / n, j = idx - i * n;
      if (j > i) continue;
      double acc = 0.0;
      for (int k = i; k < n; ++k) acc += B[k * P + i] * B[k * P + j];
      A[i * P + j] = acc;
      A[j * P + i] = acc;
    }
  } else {
    for (int idx = tid; idx < n * m; idx += kThreads) {
      const int i = idx / m, j = idx - i * m;
      double acc = 0.0;
      for (int k = 0; k <= i; ++k)
        acc += B[i * P + k] * (j < d ? X[k * d + j] : 1.0);
      C[idx] = acc;
    }
    for (int idx = tid; idx < n * n; idx += kThreads) {
      const int i = idx / n, k = idx - i * n;
      if (k <= i) zz[0] += B[i * P + k] * B[i * P + k];
    }
  }
  __syncthreads();
  // alpha = Z^T q
  for (int i = tid; i < n; i += kThreads) {
    double acc = 0.0;
    for (int k = i; k < n; ++k) acc += B[k * P + i] * q[k];
    alpha[i] = acc;
  }
  __syncthreads();
  if (FORM == kCholSe) {
    // W = K^-1 - alpha alpha^T on the fly: sum W o K_se, sum W o K_se o d^2,
    // tr W, sum alpha.
    double part[4] = {0.0, 0.0, 0.0, 0.0};
    for (int idx = tid; idx < n * n; idx += kThreads) {
      const int i = idx / n, j = idx - i * n;
      const double w = A[i * P + j] - alpha[i] * alpha[j];
      const double ks = a2 * exp(-C[i * P + j] / ell2);
      part[0] += w * ks;
      part[1] += w * ks * C[i * P + j];
      if (i == j) part[2] += w;
    }
    for (int i = tid; i < n; i += kThreads) part[3] += alpha[i];
    block_sum(part, sm + c.red);
    if (tid == 0) {
      g[0] = part[0];
      g[1] = part[1] / ell2;
      g[2] = noise * part[2];
      g[3] = -part[3];
    }
  } else {
    // x^T K^-1 x' = (Z x)^T (Z x'), x^T alpha = (Z x)^T q: the gradient
    // never forms K^-1, whose entries reach 1 / noise while these products
    // stay of order one.  Column d of Y is Z 1.
    double part[2] = {zz[0], 0.0};
    for (int i = tid; i < n; i += kThreads) part[1] += alpha[i] * alpha[i];
    block_sum(part, sm + c.red);
    for (int j = tid; j < m; j += kThreads) {
      double s1 = 0.0, s2 = 0.0;
      for (int i = 0; i < n; ++i) {
        const double yij = C[i * m + j];
        s1 += yij * yij;
        s2 += yij * q[i];
      }
      const double scale = j < d ? sm[c.wv + j] * sm[c.wv + j] : b2;
      g[j] = scale * (s1 - s2 * s2);
      if (j == d) g[d + 2] = -s2;
    }
    if (tid == 0) g[d + 1] = noise * (part[0] - part[1]);
  }
  __syncthreads();
  return true;
}

// One step's gradient of the Woodbury form (linear, m = d + 1 <= 33
// columns of V) into g[0..d+3); false where A's factor fails.
__device__ bool grad_woodbury(double* sm, const Carve& c, int n, int d) {
  const int tid = threadIdx.x;
  const int m = d + 1, Q = odd_pitch(m);
  double *A = sm + c.A, *Li = sm + c.B, *G = sm + c.C, *S = sm + c.S;
  double *X = sm + c.X, *r = sm + c.r, *alpha = sm + c.alpha;
  double *wv = sm + c.wv, *u = sm + c.u, *q = sm + c.q, *sv = sm + c.sv;
  double* hv = sm + c.hv;
  const double* prm = sm + c.prm;
  const double noise = exp(2.0 * prm[d + 1]);
  const double dg = noise + kJitter;
  const double cst = prm[d + 2];
  for (int j = tid; j < m; j += kThreads) wv[j] = exp(prm[j]);
  for (int i = tid; i < n; i += kThreads) r[i] = sm[c.y + i] - cst;
  __syncthreads();
  // G = V^T V / D (and A = I + G), u = V^T r / D; V_ij = x_ij w_j, V_id = b.
  const int pairs = m * (m + 1) / 2;
  for (int t = tid; t < pairs + m; t += kThreads) {
    if (t < pairs) {
      int j = (int)((sqrt(8.0 * t + 1.0) - 1.0) * 0.5);
      while (j * (j + 1) / 2 > t) --j;
      while ((j + 1) * (j + 2) / 2 <= t) ++j;
      const int k = t - j * (j + 1) / 2;
      double acc = 0.0;
      for (int i = 0; i < n; ++i) {
        const double vj = j < d ? X[i * d + j] * wv[j] : wv[d];
        const double vk = k < d ? X[i * d + k] * wv[k] : wv[d];
        acc += vj * vk;
      }
      const double gjk = acc / dg;
      G[j * Q + k] = G[k * Q + j] = gjk;
      A[j * Q + k] = A[k * Q + j] = j == k ? gjk + 1.0 : gjk;
    } else {
      const int j = t - pairs;
      double acc = 0.0;
      for (int i = 0; i < n; ++i)
        acc += (j < d ? X[i * d + j] * wv[j] : wv[d]) * r[i];
      u[j] = acc / dg;
    }
  }
  __syncthreads();
  if (!factor(A, Q, m, sm + c.rd)) return false;
  invert_lower(A, Q, m, sm + c.rd, Li);
  // q = L_A^-1 u, S = L_A^-1 G.
  for (int t = tid; t < m * m + m; t += kThreads) {
    if (t < m * m) {
      const int k = t / m, j = t - k * m;
      double acc = 0.0;
      for (int l = 0; l <= k; ++l) acc += Li[k * Q + l] * G[l * Q + j];
      S[k * Q + j] = acc;
    } else {
      const int k = t - m * m;
      double acc = 0.0;
      for (int l = 0; l <= k; ++l) acc += Li[k * Q + l] * u[l];
      q[k] = acc;
    }
  }
  __syncthreads();
  // sv = A^-1 u = L_A^-T q, which is also V^T alpha; h_j = v_j^T K^-1 v_j
  // = (I - A^-1)_jj = (G - G A^-1 G)_jj, each form where its subtraction is
  // of small terms; tr(A^-1 G) = sum L_A^-1 o S.
  double part[2] = {0.0, 0.0};
  for (int t = tid; t < 2 * m; t += kThreads) {
    const int j = t < m ? t : t - m;
    double acc = 0.0;
    if (t < m) {
      for (int k = j; k < m; ++k) acc += Li[k * Q + j] * q[k];
      sv[j] = acc;
    } else if (G[j * Q + j] >= 1.0) {
      for (int k = j; k < m; ++k) acc += Li[k * Q + j] * Li[k * Q + j];
      hv[j] = 1.0 - acc;
    } else {
      for (int k = 0; k < m; ++k) acc += S[k * Q + j] * S[k * Q + j];
      hv[j] = G[j * Q + j] - acc;
    }
  }
  for (int t = tid; t < m * m; t += kThreads) {
    const int k = t / m, j = t - k * m;
    if (j <= k) part[0] += Li[k * Q + j] * S[k * Q + j];
  }
  __syncthreads();
  // alpha = (r - V sv) / D, for |alpha|^2 (tr W)
  for (int i = tid; i < n; i += kThreads) {
    double acc = 0.0;
    for (int j = 0; j < d; ++j) acc += X[i * d + j] * wv[j] * sv[j];
    acc += wv[d] * sv[d];
    const double a = (r[i] - acc) / dg;
    alpha[i] = a;
    part[1] += a * a;
  }
  block_sum(part, sm + c.red);
  // v_j^T W v_j = h_j - (v_j^T alpha)^2; sum alpha = v_d^T alpha / b.
  double* g = sm + c.grad;
  for (int j = tid; j < m; j += kThreads) g[j] = hv[j] - sv[j] * sv[j];
  if (tid == 0) {
    const double tr_kinv = ((double)n - part[0]) / dg;
    g[d + 1] = noise * (tr_kinv - part[1]);
    g[d + 2] = -sv[d] / wv[d];
  }
  __syncthreads();
  return true;
}

// Where parameter p (internal order) of run `run` lives in the packed
// buffer of sorted key blocks.
template <int FORM>
__device__ inline size_t packed(int L, int d, int run, int p) {
  if (FORM == kCholSe) return (size_t)p * L + run;
  if (p < d) return (size_t)2 * L + (size_t)run * d + p;   // log_w
  if (p == d) return run;                                    // log_bias
  if (p == d + 1) return (size_t)L + run;                    // log_tau
  return (size_t)(2 + d) * L + run;                          // mean_const
}

template <int FORM>
__global__ void __launch_bounds__(kThreads, 1)
gp_fit_kernel(const double* __restrict__ X, const double* __restrict__ y,
              const double* __restrict__ mask, const double* __restrict__ p0,
              double* __restrict__ p1, const double* __restrict__ bc, int L,
              int b, int d, int rows, int steps, int train_tau, double lr) {
  extern __shared__ double sm[];
  const Carve c = carve(FORM, rows, d);
  const int run = blockIdx.x, tid = threadIdx.x;
  const int np = FORM == kCholSe ? 4 : d + 3;
  const int P = odd_pitch(rows);
  double cnt[1] = {0.0};
  for (int i = tid; i < b; i += kThreads)
    cnt[0] += mask[(size_t)run * b + i] > 0.5 ? 1.0 : 0.0;
  block_sum(cnt, sm + c.red);
  const int n = (int)cnt[0];
  const bool fits = n <= rows;   // the host's row count bounds the carve
  for (int idx = tid; fits && idx < n * d; idx += kThreads)
    sm[c.X + idx] = X[(size_t)run * b * d + idx];
  for (int i = tid; fits && i < n; i += kThreads)
    sm[c.y + i] = y[(size_t)run * b + i];
  for (int p = tid; p < np; p += kThreads) {
    sm[c.prm + p] = fits ? p0[packed<FORM>(L, d, run, p)] : nan_value();
    sm[c.m1 + p] = 0.0;
    sm[c.m2 + p] = 0.0;
  }
  __syncthreads();
  if (FORM == kCholSe && fits) {
    const double* Xs = sm + c.X;
    for (int idx = tid; idx < n * n; idx += kThreads) {
      const int i = idx / n, k = idx - i * n;
      double acc = 0.0;
      for (int j = 0; j < d; ++j) {
        const double diff = Xs[i * d + j] - Xs[k * d + j];
        acc += diff * diff;
      }
      sm[c.C + i * P + k] = acc;
    }
    __syncthreads();
  }
  // Each gradient ends with a barrier, or fails uniformly before any shared
  // write after its last one, so Adam follows it directly.
  for (int t = 0; fits && t < steps; ++t) {
    const bool ok = FORM == kWoodbury
                        ? grad_woodbury(sm, c, n, d)
                        : grad_cholesky<FORM>(sm, c, n, d, P);
    if (tid < np) {
      double g = ok ? sm[c.grad + tid] : nan_value();
      if (tid == np - 2 && !train_tau) g = 0.0;
      const double m = 0.9 * sm[c.m1 + tid] + 0.1 * g;
      const double v = 0.999 * sm[c.m2 + tid] + 0.001 * g * g;
      sm[c.m1 + tid] = m;
      sm[c.m2 + tid] = v;
      const double mh = m * (1.0 / bc[t]);
      const double vh = v * (1.0 / bc[steps + t]);
      sm[c.prm + tid] = sm[c.prm + tid] - lr * mh / (sqrt(vh) + 1e-8);
    }
    __syncthreads();
  }
  for (int p = tid; p < np; p += kThreads)
    p1[packed<FORM>(L, d, run, p)] = sm[c.prm + p];
}

size_t max_smem_bytes() {
  const size_t chol = carve(kCholSe, kMaxCholRows, kMaxD).total;
  const size_t lin = carve(kCholLinear, kMaxCholRows, kMaxD).total;
  const size_t wood = carve(kWoodbury, kMaxWoodRows, kMaxD).total;
  size_t most = chol > lin ? chol : lin;
  return 8 * (most > wood ? most : wood);
}

template <int FORM>
int launch(const double* X, const double* y, const double* mask,
           const double* p0, double* p1, const double* bc, int L, int b, int d,
           int rows, int steps, int train_tau, double lr,
           cudaStream_t stream) {
  static bool allowed = false;
  if (!allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        gp_fit_kernel<FORM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)max_smem_bytes());
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = true;
  }
  const size_t bytes = 8 * carve(FORM, rows, d).total;
  gp_fit_kernel<FORM><<<L, kThreads, bytes, stream>>>(
      X, y, mask, p0, p1, bc, L, b, d, rows, steps, train_tau, lr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a shape outside the caps.  The caller
// guarantees contiguous float64 operands of the layout above and `rows` >=
// every run's real rows.
int gp_fit_f64(const void* X, const void* y, const void* mask, const void* p0,
               void* p1, const void* bc, int form, int L, int b, int d,
               int rows, int steps, int train_tau, double lr, void* stream) {
  const int cap = form == kWoodbury ? kMaxWoodRows : kMaxCholRows;
  if (L <= 0 || d < 1 || d > kMaxD || rows < 0 || rows > cap || rows > b ||
      steps < 0 || form < kCholLinear || form > kWoodbury)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* Xd = static_cast<const double*>(X);
  const auto* yd = static_cast<const double*>(y);
  const auto* md = static_cast<const double*>(mask);
  const auto* p0d = static_cast<const double*>(p0);
  auto* p1d = static_cast<double*>(p1);
  const auto* bcd = static_cast<const double*>(bc);
  auto s = static_cast<cudaStream_t>(stream);
  switch (form) {
    case kCholLinear:
      return launch<kCholLinear>(Xd, yd, md, p0d, p1d, bcd, L, b, d, rows,
                                 steps, train_tau, lr, s);
    case kCholSe:
      return launch<kCholSe>(Xd, yd, md, p0d, p1d, bcd, L, b, d, rows, steps,
                             train_tau, lr, s);
    default:
      return launch<kWoodbury>(Xd, yd, md, p0d, p1d, bcd, L, b, d, rows,
                               steps, train_tau, lr, s);
  }
}

// The dynamic shared memory one CTA of `form` takes for `rows` rows and d
// features (`built_smem_bytes` in the Python wrapper).
long long gp_fit_smem_bytes(int form, int rows, int d) {
  return static_cast<long long>(8 * carve(form, rows, d).total);
}

}  // extern "C"
