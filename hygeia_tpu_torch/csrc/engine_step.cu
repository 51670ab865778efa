// K4: the single-group engine's site step after the resampler, at a site at
// capacity, as three launches over every unit of the site.
//
// No TPU kernel of the JAX package computes this: hygeia_tpu composes the
// step from XLA ops inside its engine's scan (single_group/engine.py: the
// weights, the backward kernels, the adaptive-lag smoothing and the score).
// The port's plain version is hygeia_tpu_torch/single_group/engine.py:
// _Engine._step_plain after the resampler, with _smooth and _score. Given
// the resampler K1's outputs for site t (read at the device index t_dev,
// never the host), the stages are:
//
//   WEIGHTS, a block a unit:
//     1. stages t - 1's particles with their table entries (rho, the exit
//        latch, the log-rho gradients) in shared memory, counts the finite
//        weights and takes the maxima of the backward kernels' logits
//        log B[q, n] = (log rho_n + log P[r_n, q]) + w_n over n, where
//        q != r_n and d_n >= u (else -inf);
//     2. picks each ancestor (K1's parent where more than M weights are
//        finite and K1 did not take its unbiased scheme, else K1's top-M
//        index), forms the continuation weights and the continuation's
//        gradient terms, writes the new sojourns and regimes in place (every
//        read of t - 1's particles is behind a barrier), and sums B's
//        exponentials;
//     3. forms the fresh weights log sum_n B[q, n] + obs_t[q], the shift
//        (torch.logsumexp's rule: the max, 0 where it is infinite), the
//        normalised weights, their exponentials and B, and writes the
//        shift, and the smoothing buffer's insertion slot (the first free
//        entry, else the oldest pending one, counted as a spill).
//   SMOOTH, a block a (unit, smoothing entry s): carries entry s to t (a
//     continuation's value at its ancestor, a fresh particle's under B;
//     zero for an entry not pending), writes a spilled entry's means, puts
//     time t's indicator in the insertion slot, takes the R means and
//     second moments under the new weights and finalises the entry (all
//     variances below epsilon, or aged S, or the last site), writing its
//     row of out/out_valid. Only the finalised rows are written: the plain
//     version's writes to the sentinel row T, which result() drops, are
//     not made.
//   GRADIENT, a block a (unit, column d of phi): carries column d to t
//     (phi at the ancestor plus a continuation's gradient term; B times
//     phi plus B times the change-point density's gradient for a fresh
//     particle) and sums the score w_self . phi[:, d].
//
// A unit past its t_limit (row t of `live` false) writes nothing but a 0
// shift. The engine calls GRADIENT from _Engine._estimate, the method
// that also takes the ADAM step at parameter updates, and SMOOTH on a
// second stream beside it: the two read what WEIGHTS wrote and write apart.
//
// What bounds it on an H100: latency. At the theta cell's shape (U, N, S,
// R, D) = (1, 250, 128, 6, 36) a site reads and writes the smoothing buffer
// psi (S * R * N f32, 768 KB) and phi (36 KB): ~1.6 MB, ~0.5 us at 3.35
// TB/s; its arithmetic is ~10^6 flops. The floor is three launches (~2 us
// each) and each stage's chain of dependent reads and reductions (three
// block-wide in WEIGHTS; in SMOOTH a warp's a regime, behind four barriers;
// one block-wide and one a warp in GRADIENT). Against the plain
// composition, ~220 small kernels a site, it saves their launches and the
// round trips of every intermediate. psi is spread over U * S blocks (128
// SMs at U = 1), each carrying its own entry, so no block moves more than
// 6 KB of it; phi over U * D blocks, one particle a thread.
//
// Bits: every sum is taken in one stated order (each thread its strided
// elements in index order, a butterfly over the warp, then the warps'
// totals in warp order), with no float atomics, so a rerun and a replayed
// graph give the same bits. The terms are the plain version's (logf,
// log1pf, expf as PyTorch's CUDA log, log1p, exp); the sums differ from
// torch.logsumexp's and cuBLAS's by their order.
//
// Shapes: any U; 1 <= R <= 8; N = M + R; D = R^2 or R(R + 1); regimes in
// [0, R) and sojourns below 2^31; shared memory (WEIGHTS 45N bytes, SMOOTH
// 12RN, GRADIENT 4N) within the card's opt-in limit.
// ops/cuda_engine_step.py::supports and ::smem_bytes state the same.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared -Xcompiler -fPIC
// (hygeia_tpu_torch/ops/build.py). Plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <math.h>

// The launch's arguments, one struct so that a graph's capture keeps them
// by value. Mirrored field for field by ops/cuda_engine_step.py::_Args.
// Outside the unnamed namespace: the exported entry takes it, and a type
// of internal linkage in its signature would hide the entry's symbol.
struct EngineStepArgs {
  const long long* t_dev;  // (1,): the site t
  long long* d;  // (U, N) sojourns: t - 1's, overwritten with t's by WEIGHTS
  long long* r;  // (U, N) regimes, likewise
  float* w;  // (U, N) log weights, likewise
  const int* k1_parents;  // (U, M)
  const float* k1_new_lw;  // (U, M)
  const int* k1_top;  // (U, M)
  const unsigned char* k1_unbiased;  // (U,) bool
  const float* haz;  // (U, n_haz, R * W): rho, exit (0/1), grad omega[, grad kappa] of log rho
  const float* log_p;  // (U, R, R)
  const float* p;  // (U, R, R)
  const float* emis;  // the emission row of (unit u, site t) at u * e_su + t * e_st
  long long e_su, e_st;
  const unsigned char* live;  // (T, U) bool; null: every unit live
  const unsigned char* final_mask;  // (U,) bool: units whose pending entries all finalise; null: none
  float* psi;  // (U, S, R, N)
  long long* psi_time;  // (U, S)
  unsigned char* psi_valid;  // (U, S) bool
  float* out;  // (U, T + 1, R)
  unsigned char* out_valid;  // (U, T + 1) bool
  long long* spill;  // (U,)
  float* shifts;  // (U, T)
  float* phi;  // (U, N, D)
  float* score;  // (U, D)
  float* b;  // workspace (U, R, N): the backward kernels B
  float* w_self;  // workspace (U, N): exp of the new weights, 0 where they are not finite
  int* anc;  // workspace (U, M): the ancestors
  int* prev_code;  // workspace (U, N): t - 1's regime where its sojourn reaches u, else -1
  float* g_prev;  // workspace (U, 2, N): grad omega, grad kappa of log rho at t - 1's particles
  float* g_anc;  // workspace (U, 2, M): a continuation's omega and kappa gradient terms
  int* slot;  // workspace (U, 2): the insertion slot, and whether it was free
  long long T;
  int stage, U, N, M, R, W, S, D, n_haz, min_duration, regimes, final_all;
  float epsilon;
};

namespace {

constexpr int kThreads = 256;  // every stage's block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxR = 8;  // at most kWarps: SMOOTH gives a regime's row a warp
constexpr unsigned kFull = 0xffffffffu;
enum { kWeights = 0, kSmooth = 1, kGradient = 2 };

// torch.amax's maximum: NaN wins.
__device__ __forceinline__ float nanmax(float a, float b) { return (a > b || isnan(a)) ? a : b; }

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1) x = nanmax(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

// Sums of s[j] and maxima of m[j] over the block, for j % kMaxR < k (a
// vector of k entries, or two of them side by side): each warp's butterfly,
// then the warps' values in warp order, so every thread gets the same
// totals. red holds kWarps * (KS + KM) floats. The first barrier follows
// every read and write the thread made before the call; the call ends with
// a barrier.
template <int KS, int KM>
__device__ __forceinline__ void block_reduce(float (&s)[KS], float (&m)[KM], int k, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < KS; ++j) {
    if (j % kMaxR < k) {
      const float x = warp_sum(s[j]);
      if (lane == 0) red[j * kWarps + warp] = x;
    }
  }
#pragma unroll
  for (int j = 0; j < KM; ++j) {
    if (j % kMaxR < k) {
      const float x = warp_max(m[j]);
      if (lane == 0) red[(KS + j) * kWarps + warp] = x;
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < KS; ++j) {
    if (j % kMaxR < k) {
      float x = red[j * kWarps];
      for (int w = 1; w < kWarps; ++w) x += red[j * kWarps + w];
      s[j] = x;
    }
  }
#pragma unroll
  for (int j = 0; j < KM; ++j) {
    if (j % kMaxR < k) {
      float x = red[(KS + j) * kWarps];
      for (int w = 1; w < kWarps; ++w) x = nanmax(x, red[(KS + j) * kWarps + w]);
      m[j] = x;
    }
  }
  __syncthreads();
}

// log B[q, n], the logit of fresh regime q from t - 1's particle n: -inf
// unless q != r_n and d_n >= u.
__device__ __forceinline__ float log_b(int q, int rp, bool dok, float lrt, float lp_rq, float sw) {
  return (dok && q != rp) ? (lrt + lp_rq) + sw : -INFINITY;
}

// ---- WEIGHTS: a block a unit --------------------------------------------
__global__ void __launch_bounds__(kThreads) weights_kernel(const EngineStepArgs a) {
  const int u = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int N = a.N, M = a.M, R = a.R, W = a.W;
  const size_t RW = (size_t)R * W;
  const long long t = a.t_dev[0];
  if (a.live != nullptr && a.live[t * a.U + u] == 0) {  // past its t_limit: adds nothing
    if (tid == 0) a.shifts[(size_t)u * a.T + t] = 0.f;
    return;
  }
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* s_w = reinterpret_cast<float*>(smem_raw);  // N: t - 1's weights
  float* s_rho = s_w + N;  // N: rho at t - 1's particles
  float* s_lrt = s_rho + N;  // N: log rho, 0 on the exit latch
  float* s_gom = s_lrt + N;  // N: grad omega of log rho
  float* s_gka = s_gom + N;  // N: grad kappa of log rho (0 with kappa fixed)
  float* s_wn = s_gka + N;  // M: the continuation weights before the shift
  float* s_nlw = s_wn + N;  // M: K1's new weights
  int* s_par = reinterpret_cast<int*>(s_nlw + N);  // M: K1's parents
  int* s_top = s_par + N;  // M: K1's top-M indices
  int* s_d = s_top + N;  // N: t - 1's sojourns
  int* s_r = s_d + N;  // N: t - 1's regimes
  unsigned char* s_ex = reinterpret_cast<unsigned char*>(s_r + N);  // N: the exit latch
  __shared__ float s_lp[kMaxR * kMaxR], s_obs[kMaxR], red[kWarps * (2 * kMaxR)];
  __shared__ int s_free[kWarps], s_olds[kWarps];
  __shared__ long long s_oldt[kWarps];

  const size_t un = (size_t)u * N, um = (size_t)u * M;
  const float* lpu = a.log_p + (size_t)u * R * R;
  if (tid < R * R) s_lp[tid] = lpu[tid];
  if (tid < R) s_obs[tid] = a.emis[u * a.e_su + t * a.e_st + tid];

  // ---- 1: t - 1's particles, their table entries and K1's outputs; B's
  // maxima; the smoothing buffer's first free and oldest pending entries --
  const float* hz = a.haz + (size_t)u * a.n_haz * RW;
  float mx[kMaxR], cnt[1] = {0.f};
#pragma unroll
  for (int q = 0; q < kMaxR; ++q) mx[q] = -INFINITY;
  for (int n = tid; n < N; n += kThreads) {
    const long long dp = a.d[un + n], rp = a.r[un + n];
    const float wp = a.w[un + n];
    if (n < M) {
      s_par[n] = a.k1_parents[um + n];
      s_top[n] = a.k1_top[um + n];
      s_nlw[n] = a.k1_new_lw[um + n];
    }
    const int ri = (int)min(max(rp, 0LL), (long long)(R - 1));
    const size_t k = (size_t)ri * W + (size_t)min(max(dp - 1, 0LL), (long long)(W - 1));
    const float rho = hz[k];
    const bool ex = hz[RW + k] > 0.5f;
    const float gom = hz[2 * RW + k];
    const float gka = a.n_haz > 3 ? hz[3 * RW + k] : 0.f;
    const float lrt = ex ? 0.f : logf(rho);
    const bool dok = dp >= a.min_duration;
    s_w[n] = wp;
    s_rho[n] = rho;
    s_lrt[n] = lrt;
    s_gom[n] = gom;
    s_gka[n] = gka;
    s_d[n] = (int)dp;
    s_r[n] = (int)rp;
    s_ex[n] = ex ? 1 : 0;
    a.prev_code[un + n] = dok ? ri : -1;
    a.g_prev[2 * un + n] = gom;
    a.g_prev[2 * un + N + n] = gka;
    const bool fin = isfinite(wp);
    cnt[0] += fin ? 1.f : 0.f;
    const float sw = fin ? wp : -INFINITY;
#pragma unroll
    for (int q = 0; q < kMaxR; ++q)
      if (q < R) mx[q] = nanmax(mx[q], log_b(q, (int)rp, dok, lrt, lpu[ri * R + q], sw));
  }
  if (a.regimes) {
    // The insertion slot: the first entry not pending, else the oldest
    // pending one (the first of the least times).
    int free_s = 0x7fffffff, old_s = 0x7fffffff;
    long long old_t = 0x7fffffffffffffffLL;
    const size_t us = (size_t)u * a.S;
    for (int s = tid; s < a.S; s += kThreads) {
      if (a.psi_valid[us + s] == 0) {
        free_s = min(free_s, s);
      } else {
        const long long ts = a.psi_time[us + s];
        if (ts < old_t) old_t = ts, old_s = s;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      free_s = min(free_s, __shfl_xor_sync(kFull, free_s, off));
      const long long ot = __shfl_xor_sync(kFull, old_t, off);
      const int os = __shfl_xor_sync(kFull, old_s, off);
      if (ot < old_t || (ot == old_t && os < old_s)) old_t = ot, old_s = os;
    }
    if (lane == 0) {
      s_free[warp] = free_s;
      s_oldt[warp] = old_t;
      s_olds[warp] = old_s;
    }
  }
  block_reduce(cnt, mx, R, red);  // publishes the staged arrays; every read of t - 1's d, r, w is done
  const bool use_opt = cnt[0] > (float)M && a.k1_unbiased[u] == 0;

  // ---- 2: ancestors, continuation weights, new particles; B's sums -----
  float mq[kMaxR], sq[kMaxR], wmx[1] = {-INFINITY};
#pragma unroll
  for (int q = 0; q < kMaxR; ++q) {
    mq[q] = fabsf(mx[q]) == INFINITY ? 0.f : mx[q];
    sq[q] = 0.f;
  }
  for (int n = tid; n < N; n += kThreads) {
    const int rp = s_r[n], ri = min(max(rp, 0), R - 1);
    const bool dok = s_d[n] >= a.min_duration;
    const float lrt = s_lrt[n], wp = s_w[n], sw = isfinite(wp) ? wp : -INFINITY;
#pragma unroll
    for (int q = 0; q < kMaxR; ++q)
      if (q < R) sq[q] += expf(log_b(q, rp, dok, lrt, s_lp[ri * R + q], sw) - mq[q]);
    if (n < M) {
      const int i = n, p = use_opt ? s_par[i] : s_top[i];
      const float aw = use_opt ? s_nlw[i] : s_w[p];
      const float rho = s_rho[p];
      const bool ex = s_ex[p] != 0;
      const int ra = s_r[p];
      const float cont = (ex || rho > 1.f) ? -INFINITY : log1pf(-rho);
      const float wc = aw + (cont + s_obs[ra]);
      s_wn[i] = wc;
      wmx[0] = nanmax(wmx[0], wc);
      const float coef = (ex || rho >= 1.f) ? 0.f : -rho / (1.f - rho);
      a.anc[um + i] = p;
      a.g_anc[2 * um + i] = coef * s_gom[p];
      a.g_anc[2 * um + M + i] = coef * s_gka[p];
      a.d[un + i] = (long long)s_d[p] + 1;
      a.r[un + i] = ra;
    } else {  // the fresh change points
      a.d[un + n] = 1;
      a.r[un + n] = n - M;
    }
  }
  block_reduce(sq, wmx, R, red);

  // ---- 3: fresh weights, the shift, B; the writes -----------------------
  float lbz[kMaxR], wf[kMaxR];
  float ms = wmx[0];
#pragma unroll
  for (int q = 0; q < kMaxR; ++q) {
    lbz[q] = logf(sq[q]) + mq[q];
    wf[q] = q < R ? lbz[q] + s_obs[q] : -INFINITY;
    if (q < R) ms = nanmax(ms, wf[q]);
  }
  if (fabsf(ms) == INFINITY) ms = 0.f;
  float ssum[1] = {0.f}, none[1] = {0.f};
  float* bu = a.b + (size_t)u * R * N;
  for (int n = tid; n < N; n += kThreads) {
    float v = 0.f;
    if (n < M) {
      v = s_wn[n];
    } else {
#pragma unroll
      for (int q = 0; q < kMaxR; ++q)
        if (q == n - M) v = wf[q];
    }
    ssum[0] += expf(v - ms);
    const int rp = s_r[n], ri = min(max(rp, 0), R - 1);
    const bool dok = s_d[n] >= a.min_duration;
    const float lrt = s_lrt[n], wp = s_w[n], sw = isfinite(wp) ? wp : -INFINITY;
#pragma unroll
    for (int q = 0; q < kMaxR; ++q)
      if (q < R)
        bu[(size_t)q * N + n] = isfinite(lbz[q]) ? expf(log_b(q, rp, dok, lrt, s_lp[ri * R + q], sw) - lbz[q]) : 0.f;
  }
  block_reduce(ssum, none, 1, red);
  const float shift = logf(ssum[0]) + ms;
  for (int n = tid; n < N; n += kThreads) {
    float v = 0.f;
    if (n < M) {
      v = s_wn[n];
    } else {
#pragma unroll
      for (int q = 0; q < kMaxR; ++q)
        if (q == n - M) v = wf[q];
    }
    const float wn = v - shift;
    a.w[un + n] = wn;
    a.w_self[un + n] = isfinite(wn) ? expf(wn) : 0.f;
  }
  if (tid == 0) {
    a.shifts[(size_t)u * a.T + t] = shift;
    if (a.regimes) {
      int free_s = s_free[0], old_s = s_olds[0];
      long long old_t = s_oldt[0];
      for (int w = 1; w < kWarps; ++w) {
        free_s = min(free_s, s_free[w]);
        if (s_oldt[w] < old_t || (s_oldt[w] == old_t && s_olds[w] < old_s)) old_t = s_oldt[w], old_s = s_olds[w];
      }
      const bool has_free = free_s != 0x7fffffff;
      a.slot[2 * u] = has_free ? free_s : old_s;
      a.slot[2 * u + 1] = has_free ? 1 : 0;
      if (!has_free) a.spill[u] += 1;  // no free entry: the oldest is spilled
    }
  }
}

// ---- SMOOTH: a block a (unit, smoothing entry) ----------------------------
// Each sum over the N particles is a warp's: warp r takes regime r's row.
__global__ void __launch_bounds__(kThreads) smooth_kernel(const EngineStepArgs a) {
  const int S = a.S, N = a.N, M = a.M, R = a.R;
  const int u = blockIdx.x / S, s = blockIdx.x - u * S;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long t = a.t_dev[0];
  if (a.live != nullptr && a.live[t * a.U + u] == 0) return;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* P = reinterpret_cast<float*>(smem_raw);  // R * N: the entry at t - 1
  float* Bs = P + (size_t)R * N;  // R * N: B
  float* Q = Bs + (size_t)R * N;  // R * N: the entry at t
  __shared__ float s_fresh[kMaxR * kMaxR], s_mean[kMaxR], s_sec[kMaxR];

  const size_t e = (size_t)u * S + s, un = (size_t)u * N;
  const int ins = a.slot[2 * u];
  const bool has_free = a.slot[2 * u + 1] != 0;
  const bool valid_old = a.psi_valid[e] != 0, is_ins = s == ins;
  const long long time_old = a.psi_time[e];
  float* row = a.psi + e * R * N;
  const float* ws = a.w_self + un;
  const int* anc = a.anc + (size_t)u * M;
  const size_t orow = (size_t)u * (a.T + 1);

  // ---- 1: the entry carried to t (zero where it is not pending) -------
  if (valid_old) {
    const float* bu = a.b + (size_t)u * R * N;
    for (int k = tid; k < R * N; k += kThreads) {
      P[k] = row[k];
      Bs[k] = bu[k];
    }
    __syncthreads();
    if (warp < R) {  // fresh particle q: sum_n psi[r, n] B[q, n]
      const float* pr = P + (size_t)warp * N;
      float acc[kMaxR];
#pragma unroll
      for (int q = 0; q < kMaxR; ++q) acc[q] = 0.f;
      for (int n = lane; n < N; n += 32) {
        const float x = pr[n];
#pragma unroll
        for (int q = 0; q < kMaxR; ++q)
          if (q < R) acc[q] += x * Bs[(size_t)q * N + n];
      }
#pragma unroll
      for (int q = 0; q < kMaxR; ++q) {
        if (q < R) {
          const float v = warp_sum(acc[q]);
          if (lane == 0) s_fresh[warp * kMaxR + q] = v;
        }
      }
    }
    __syncthreads();
    for (int k = tid; k < R * N; k += kThreads) {
      const int r = k / N, n = k - r * N;
      Q[k] = n < M ? P[(size_t)r * N + anc[n]] : s_fresh[r * kMaxR + (n - M)];
    }
  } else {
    for (int k = tid; k < R * N; k += kThreads) Q[k] = 0.f;
  }
  __syncthreads();

  // ---- 2: the insertion slot: a spilled entry's means, then time t -----
  if (is_ins) {
    if (!has_free && warp < R) {  // the oldest pending entry finalises at its time
      const float* qr = Q + (size_t)warp * N;
      float m = 0.f;
      for (int n = lane; n < N; n += 32) m += qr[n] * ws[n];
      m = warp_sum(m);
      if (lane == 0) a.out[(orow + time_old) * R + warp] = m;
      if (tid == 0) a.out_valid[orow + time_old] = 1;
    }
    __syncthreads();
    for (int k = tid; k < R * N; k += kThreads) {
      const int r = k / N, n = k - r * N;
      Q[k] = a.r[un + n] == r ? 1.f : 0.f;
    }
    __syncthreads();
  }

  // ---- 3: means, second moments; finalisation ---------------------------
  const bool valid_new = valid_old || is_ins;
  const long long time_new = is_ins ? t : time_old;
  if (warp < R) {
    const float* qr = Q + (size_t)warp * N;
    float m = 0.f, v = 0.f;
    if (valid_new) {
      for (int n = lane; n < N; n += 32) m += qr[n] * ws[n];
      m = warp_sum(m);
      for (int n = lane; n < N; n += 32) {
        const float df = qr[n] - m;
        v += (df * df) * ws[n];
      }
      v = warp_sum(v);
    }
    if (lane == 0) {
      s_mean[warp] = m;
      s_sec[warp] = v;
    }
  }
  __syncthreads();
  if (tid == 0) {
    bool all_below = true;
    for (int r = 0; r < R; ++r) all_below = all_below && s_sec[r] < a.epsilon;
    bool fin, forced = false;
    if (a.final_all) {
      fin = valid_new;
    } else {
      const bool aged = time_new <= t - S;
      forced = aged && !all_below;
      if (a.final_mask != nullptr && a.final_mask[u] != 0) {  // its t_limit ends here
        forced = false;
        all_below = true;
      }
      fin = valid_new && (all_below || aged);
    }
    if (valid_new && forced) atomicAdd(reinterpret_cast<unsigned long long*>(a.spill + u), 1ULL);
    if (fin) {
      for (int r = 0; r < R; ++r) a.out[(orow + time_new) * R + r] = s_mean[r];
      a.out_valid[orow + time_new] = 1;
    }
    a.psi_time[e] = time_new;
    a.psi_valid[e] = (valid_new && !fin) ? 1 : 0;
  }
  for (int k = tid; k < R * N; k += kThreads) row[k] = Q[k];
}

// ---- GRADIENT: a block a (unit, column of phi) ----------------------------
__global__ void __launch_bounds__(kThreads) gradient_kernel(const EngineStepArgs a) {
  const int N = a.N, M = a.M, R = a.R, D = a.D;
  const int u = blockIdx.x / D, d = blockIdx.x - u * D;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long t = a.t_dev[0];
  if (a.live != nullptr && a.live[t * a.U + u] == 0) return;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* col = reinterpret_cast<float*>(smem_raw);  // N: column d at t - 1
  __shared__ float red[kWarps * (2 * kMaxR + 1)];

  // The column's regime (its owner) and kind: entry jd of P's row owner, or
  // owner's omega, or owner's kappa.
  const int om_col = R * (R - 1), ka_col = R * R;
  int owner, kind, jd = 0;
  if (d < om_col) {
    owner = d / (R - 1);
    const int k = d - owner * (R - 1);
    jd = k < owner ? k : k + 1;
    kind = 0;
  } else if (d < ka_col) {
    owner = d - om_col;
    kind = 1;
  } else {
    owner = d - ka_col;
    kind = 2;
  }
  const size_t un = (size_t)u * N, um = (size_t)u * M;
  const float p_oj = kind == 0 ? a.p[(size_t)u * R * R + owner * R + jd] : 0.f;
  const float* gsrc = a.g_prev + 2 * un + (kind == 2 ? N : 0);
  const float* bu = a.b + (size_t)u * R * N;
  float* ph = a.phi + un * D + d;  // phi[u, n, d] at ph[n * D]

  // Fresh particle q: fg[q] = sum_n B[q, n] phi[n, d], fg[kMaxR + q] =
  // sum_n B[q, n] g(q, n, d) over the previous particles of the owner's
  // regime whose change to q is allowed (g: 1[q == jd] - P[owner, jd], or
  // the log-rho gradient).
  float fg[2 * kMaxR], none[1] = {0.f};
#pragma unroll
  for (int j = 0; j < 2 * kMaxR; ++j) fg[j] = 0.f;
  for (int n = tid; n < N; n += kThreads) {
    const float x = ph[(size_t)n * D];
    col[n] = x;
    const int code = a.prev_code[un + n];
    const bool own = code == owner;
    const float gv = (own && kind != 0) ? gsrc[n] : 0.f;
#pragma unroll
    for (int q = 0; q < kMaxR; ++q) {
      if (q < R) {
        const float bq = bu[(size_t)q * N + n];
        fg[q] += bq * x;
        if (own && q != code) fg[kMaxR + q] += bq * (kind == 0 ? (q == jd ? 1.f : 0.f) - p_oj : gv);
      }
    }
  }
  block_reduce(fg, none, R, red);  // publishes col

  // Column d at t, and the score.
  const float* ws = a.w_self + un;
  float sc = 0.f;
  for (int n = tid; n < N; n += kThreads) {
    float v = 0.f;
    if (n < M) {
      const long long ra = a.r[un + n];  // the ancestor's regime (WEIGHTS wrote it)
      float gc = 0.f;
      if (d == om_col + ra) {
        gc = a.g_anc[2 * um + n];
      } else if (d == ka_col + ra) {
        gc = a.g_anc[2 * um + M + n];
      }
      v = col[a.anc[um + n]] + gc;
    } else {
#pragma unroll
      for (int q = 0; q < kMaxR; ++q)
        if (q == n - M) v = fg[q] + fg[kMaxR + q];
    }
    ph[(size_t)n * D] = v;
    sc += ws[n] * v;
  }
  sc = warp_sum(sc);
  if (lane == 0) red[warp] = sc;  // every read of red by block_reduce is behind its last barrier
  __syncthreads();
  if (tid == 0) {
    float x = red[0];
    for (int w = 1; w < kWarps; ++w) x += red[w];
    a.score[(size_t)u * D + d] = x;
  }
}

size_t weights_smem(int N) { return (size_t)N * (7 * sizeof(float) + 4 * sizeof(int) + 1); }
size_t smooth_smem(int N, int R) { return 3 * sizeof(float) * (size_t)R * N; }
size_t gradient_smem(int N) { return sizeof(float) * (size_t)N; }

// Above 48 KB a block gets dynamic shared memory only after opting in:
// once per (kernel, device), to the most the device allows.
template <typename Kernel>
cudaError_t opt_in(Kernel* kernel, size_t smem, int* opted) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (opted[dev] == 0) {
    int most = 0;
    e = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return e;
    cudaFuncAttributes attr;
    e = cudaFuncGetAttributes(&attr, kernel);
    if (e != cudaSuccess) return e;
    most -= (int)attr.sharedSizeBytes;  // the limit counts the static arrays too
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e != cudaSuccess) return e;
    opted[dev] = most;
  }
  return smem > (size_t)opted[dev] ? cudaErrorInvalidValue : cudaSuccess;
}

}  // namespace

extern "C" {

// The size of EngineStepArgs, which the wrapper holds its struct to.
size_t hygeia_engine_step_args_size() { return sizeof(EngineStepArgs); }

// Launches stage a.stage on `stream`; returns a CUDA error code (0 when
// the launch was accepted). The caller checks shapes
// (ops/cuda_engine_step.py); this refuses a shape that does not add up and
// shared memory beyond the device's opt-in limit all the same.
int hygeia_engine_step(const EngineStepArgs* args, void* stream) {
  const EngineStepArgs& a = *args;
  if (a.U <= 0) return 0;
  if (a.R < 1 || a.R > kMaxR || a.M < 1 || a.N != a.M + a.R || a.W < 1 || a.S < 1 ||
      (a.D != a.R * a.R && a.D != a.R * (a.R + 1)) || (a.n_haz != 3 && a.n_haz != 4))
    return (int)cudaErrorInvalidValue;
  static int opted[3][64] = {{0}};
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  switch (a.stage) {
    case kWeights: {
      const size_t smem = weights_smem(a.N);
      if ((e = opt_in(weights_kernel, smem, opted[0])) != cudaSuccess) return (int)e;
      weights_kernel<<<a.U, kThreads, smem, st>>>(a);
      break;
    }
    case kSmooth: {
      if ((long long)a.U * a.S > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
      const size_t smem = smooth_smem(a.N, a.R);
      if ((e = opt_in(smooth_kernel, smem, opted[1])) != cudaSuccess) return (int)e;
      smooth_kernel<<<a.U * a.S, kThreads, smem, st>>>(a);
      break;
    }
    case kGradient: {
      if ((long long)a.U * a.D > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
      const size_t smem = gradient_smem(a.N);
      if ((e = opt_in(gradient_kernel, smem, opted[2])) != cudaSuccess) return (int)e;
      gradient_kernel<<<a.U * a.D, kThreads, smem, st>>>(a);
      break;
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* hygeia_engine_step_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
