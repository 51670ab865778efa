// K2: the two-group filter's site step after the resampler, one thread
// block per unit.
//
// No TPU kernel of the JAX package computes this: hygeia_tpu composes the
// step from XLA ops inside its filter's scan (two_group/filter.py::_one_step
// and model.py::expand_score_and_observe_stacked). The port's plain version
// is hygeia_tpu_torch/two_group/filter.py: _expand_and_weigh (after the
// resampler) and _renormalise, then the carry and history writes of
// _site_step. Given the resampler K1's outputs for site t, a block:
//
//   1. reads t from the device index idx = (column, t) (never the host);
//   2. counts the unit's finite previous weights: more than M resamples,
//      and each parent is then K1's parent index, else K1's top-M index;
//      log_c and the unbiased switch as _expand_and_weigh takes them;
//   3. stages the M ancestors' five fields and previous weights in shared
//      memory with every factor that depends on the ancestor alone: the
//      hazard lookups and their log and log1p, the gate, the merged
//      chain's row, the control transition row (through the staged
//      (R, R) table) and the emission values at the ancestor's regimes;
//   4. gives each thread children n = i*M + m (slot i of ancestor m, the
//      layout of the history, the backward pass and the checks) and
//      computes each child's state, transition log-probability and
//      observation log-probability by slot region (cont, ctrl-CP, case-CP,
//      merge, indep) with the plain version's terms, summed in its order;
//      dead ancestors (regime -1) give -inf;
//   5. applies the weight update (no resample, unbiased or optimal) with
//      the plain version's guards against NaN from dead ancestors;
//   6. renormalises: NaN -> -inf, then a block-wide max and a sum of
//      exponentials over a fixed reduction tree (no atomics: a rerun gives
//      the same bits), the shift, and a degenerate site reset to -log N;
//   7. writes, once every read of the unit's previous state is behind a
//      barrier: children and normalised weights into the outputs (which
//      may be the inputs: the carry is overwritten in place), history row
//      t (f32 weights; int8 flag and regimes, int32 durations), the shift
//      and degenerate flag at column idx[0], and the (U, M) parents when
//      asked for.
//
// What bounds it on an H100: latency. A unit's work is ~15 KB of reads and
// ~100 KB of writes (nanoseconds at the card's memory rate) and ~10^5
// flops; the block's chain is three dependent global reads (the index and
// the count, the parents, the hazard entries) and four barriers. Against
// the plain composition, which is ~180 small kernels a site, it saves the
// launches and the round trips of every intermediate through memory.
//
// The sums whose rounding reaches an output (the sum of exponentials)
// follow one stated order for a given block size: each thread its strided
// children in index order, then a butterfly over the warp, then the warps'
// totals in warp order. The f32 terms of step 4 are the plain version's
// bit for bit (the same IEEE additions in the same order, logf and log1pf
// as PyTorch's CUDA log and log1p); the shift differs from
// torch.logsumexp's by the order of its sum.
//
// Shapes: any U, R >= 1, N = M * (2R + R^2), with the block's dynamic
// shared memory (4N + 4R^2 + 8R + 84M bytes) within the card's opt-in
// limit. ops/cuda_filter_step.py::supports and ::smem_bytes state the same
// layout in Python.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared -Xcompiler -fPIC
// (hygeia_tpu_torch/ops/build.py). Plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <math.h>

// The launch's arguments, one struct so that a graph's capture keeps them
// by value. Mirrored field for field by ops/cuda_filter_step.py::_Args.
// Outside the unnamed namespace: the exported entry takes it, and a type
// of internal linkage in its signature would hide the entry's symbol.
struct FilterStepArgs {
  const long long* idx;  // (2,): column of shifts/degen, site t
  const float* prev_lw;  // (U, N) renormalised log weights
  const int* prev_parts;  // (U, 5, N) (m, d_c, r_c, d_k, r_k)
  const int* k1_parents;  // (U, M)
  const int* k1_top;  // (U, M)
  const float* k1_log_c;  // (U,)
  const unsigned char* k1_unbiased;  // (U,) bool
  const float* e_c;  // emission tables, row t of unit u at
  const float* e_k;  // u * su + t * st
  long long ec_su, ec_st, ek_su, ek_st;
  const float* rho_both;  // (2, R, W) control and case hazards
  const float* log_p_control;  // (R, R)
  const float* log_p_merged;  // (2, 2)
  float* out_lw;  // (U, N)
  int* out_parts;  // (U, 5, N)
  float* shifts;  // (U, s_ld): column idx[0]
  unsigned char* degen;  // (U, s_ld) bool
  long long s_ld;
  float* h_lw;  // (U, h_T, N) history, row t; null: none
  signed char* h_m;
  int* h_dc;
  signed char* h_rc;
  int* h_dk;
  signed char* h_rk;
  long long h_T;
  long long* parents_out;  // (U, M); null: not asked for
  int U, N, M, R, W, min_duration;
  float neg_log_m, neg_log_n;  // f32(-log M), f32(-log N), rounded on the host
};

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kAncF = 14;  // floats staged an ancestor
constexpr int kAncI = 7;   // ints staged an ancestor

// Per-ancestor floats, at af[k * M + m].
enum {
  F_W = 0,  // the previous weight of the ancestor
  F_LRC,  // log rho_c
  F_L1RC,  // log1p(-rho_c)
  F_LRK,  // log rho_k
  F_LPMCP,  // the merged chain's term of a change point
  F_LPCCONT,  // the control term of a child that keeps the control regime
  F_LPKCTRL,  // the case term of a control change point
  F_TO0,  // log_p_merged[m, 0]
  F_TO1,  // log_p_merged[m, 1]
  F_LRCDIAG,  // log rho_c + log_p_control[r_c, r_c]
  F_LPMC,  // F_LPMCP + F_LPCCONT
  F_OBS_C,  // row_c[r_c]
  F_OBS_KK,  // row_k[r_k]
  F_OBS_KC,  // row_k[r_c]
};
// Per-ancestor ints, at ai[k * M + m]: the five fields (unclamped), the
// gate, the control regime clamped at 0.
enum { I_M = 0, I_DC, I_RC, I_DK, I_RK, I_GATE, I_RCC };

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

__device__ __forceinline__ int warp_sum_int(int x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

__device__ __forceinline__ float ind(bool c) { return c ? 0.f : -INFINITY; }

__global__ void __launch_bounds__(kThreads) filter_step_kernel(const FilterStepArgs a) {
  const int u = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int N = a.N, M = a.M, R = a.R, W = a.W;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* w = reinterpret_cast<float*>(smem_raw);  // N new log weights
  float* lp = w + N;  // R * R log_p_control
  float* rowc = lp + R * R;  // R
  float* rowk = rowc + R;  // R
  float* af = rowk + R;  // kAncF * M
  int* ai = reinterpret_cast<int*>(af + kAncF * M);  // kAncI * M
  __shared__ int s_live[kWarps];
  __shared__ float s_max[kWarps];
  __shared__ float s_sum[kWarps];

  const long long col = a.idx[0], t = a.idx[1];
  const float* lw_u = a.prev_lw + (size_t)u * N;
  const int* parts_u = a.prev_parts + (size_t)u * 5 * N;

  // ---- 1-2: the site's tables; the count of finite previous weights ----
  int live = 0;
  for (int n = tid; n < N; n += kThreads) live += isfinite(lw_u[n]) ? 1 : 0;
  live = warp_sum_int(live);
  if (lane == 0) s_live[warp] = live;
  for (int k = tid; k < R * R; k += kThreads) lp[k] = a.log_p_control[k];
  const float* ec = a.e_c + u * a.ec_su + t * a.ec_st;
  const float* ek = a.e_k + u * a.ek_su + t * a.ek_st;
  for (int k = tid; k < R; k += kThreads) {
    rowc[k] = ec[k];
    rowk[k] = ek[k];
  }
  __syncthreads();
  int total = 0;
  for (int k = 0; k < kWarps; ++k) total += s_live[k];
  const bool need = total > M;
  const bool unbiased = need && a.k1_unbiased[u] != 0;
  const float log_c = need ? a.k1_log_c[u] : 0.f;

  // ---- 3: the ancestors and their factors -----------------------------
  for (int m = tid; m < M; m += kThreads) {
    const int p = need ? a.k1_parents[(size_t)u * M + m] : a.k1_top[(size_t)u * M + m];
    if (a.parents_out) a.parents_out[(size_t)u * M + m] = p;
    const int mp = parts_u[p], dc = parts_u[N + p], rc = parts_u[2 * N + p];
    const int dk = parts_u[3 * N + p], rk = parts_u[4 * N + p];
    const float wp = lw_u[p];
    const int rcc = max(rc, 0), rkc = max(rk, 0);
    const float rho_c = a.rho_both[(size_t)rcc * W + min(max(dc - 1, 0), W - 1)];
    const float rho_k = a.rho_both[((size_t)R + rkc) * W + min(max(dk - 1, 0), W - 1)];
    const float lrc = logf(rho_c), l1rc = log1pf(-rho_c);
    const float lrk = logf(rho_k), l1rk = log1pf(-rho_k);
    const bool gate = min(dk, dc) >= a.min_duration;
    const int mc = min(max(mp, 0), 1);
    const float to0 = a.log_p_merged[2 * mc], to1 = a.log_p_merged[2 * mc + 1];
    const float lrc_diag = lrc + lp[rcc * R + rcc];
    const float lp_m_cp = gate ? to0 : ind(mp == 0);
    const float lp_c_cont = dc == 0 ? lrc_diag : l1rc;
    af[F_W * M + m] = wp;
    af[F_LRC * M + m] = lrc;
    af[F_L1RC * M + m] = l1rc;
    af[F_LRK * M + m] = lrk;
    af[F_LPMCP * M + m] = lp_m_cp;
    af[F_LPCCONT * M + m] = lp_c_cont;
    af[F_LPKCTRL * M + m] = dk == 0 ? -INFINITY : l1rk;
    af[F_TO0 * M + m] = to0;
    af[F_TO1 * M + m] = to1;
    af[F_LRCDIAG * M + m] = lrc_diag;
    af[F_LPMC * M + m] = lp_m_cp + lp_c_cont;
    af[F_OBS_C * M + m] = rowc[rcc];
    af[F_OBS_KK * M + m] = rowk[rkc];
    af[F_OBS_KC * M + m] = rowk[rcc];
    ai[I_M * M + m] = mp;
    ai[I_DC * M + m] = dc;
    ai[I_RC * M + m] = rc;
    ai[I_DK * M + m] = dk;
    ai[I_RK * M + m] = rk;
    ai[I_GATE * M + m] = gate ? 1 : 0;
    ai[I_RCC * M + m] = rcc;
  }
  __syncthreads();  // every read of the unit's previous state is done

  // ---- 4-5: children, their scores and weights --------------------------
  const float log_rm1 = logf((float)(R - 1)), log_rm2 = logf((float)(R - 2));
  const bool hist = a.h_lw != nullptr;
  const size_t hrow = ((size_t)u * a.h_T + t) * N;
  int* out_u = a.out_parts + (size_t)u * 5 * N;
  float mx = -INFINITY;
  for (int n = tid; n < N; n += kThreads) {
    const int i = n / M, m = n - i * M;
    const int mp = ai[I_M * M + m], dc = ai[I_DC * M + m], rc = ai[I_RC * M + m];
    const int dk = ai[I_DK * M + m], rk = ai[I_RK * M + m];
    const bool gate = ai[I_GATE * M + m] != 0;
    const int rcc = ai[I_RCC * M + m];
    const bool m0 = mp == 0, m1 = mp == 1;
    int cm, cdc, crc, cdk, crk;
    float trans, obs;
    if (i == 0) {  // no change point
      const float lp_m = gate ? (m0 ? af[F_TO0 * M + m] : af[F_TO1 * M + m]) : 0.f;
      const float lp_k = m1 ? ind(rc == rk && dk == dc) : (rc == rk ? -INFINITY : af[F_LPKCTRL * M + m]);
      trans = (lp_m + af[F_LPCCONT * M + m]) + lp_k;
      obs = af[F_OBS_C * M + m] + af[F_OBS_KK * M + m];
      cm = mp, cdc = dc + 1, crc = rc, cdk = dk + 1, crk = rk;
    } else if (i < R) {  // control change point to the j-th regime other than r_k
      const int j = i - 1;
      const int x = j < rk ? j : j + 1;
      trans = (af[F_LPMCP * M + m] + (af[F_LRC * M + m] + lp[rcc * R + x])) + af[F_LPKCTRL * M + m];
      obs = rowc[x] + af[F_OBS_KK * M + m];
      cm = 0, cdc = 1, crc = x, cdk = dk + 1, crk = rk;
    } else if (i < 2 * R - 1) {  // case change point to the j-th regime other than r_c
      const int j = i - R;
      const int x = j < rc ? j : j + 1;
      const bool rc_eq_rk = rc == rk;
      const float unif2 = ind(x != rk) - (rc_eq_rk ? log_rm1 : log_rm2);
      const float lp_k = (m1 && dc != 0) ? -log_rm1
                                         : unif2 + ((rc_eq_rk && m0) ? 0.f : af[F_LRK * M + m]);
      trans = af[F_LPMC * M + m] + lp_k;
      obs = af[F_OBS_C * M + m] + rowk[x];
      cm = 0, cdc = dc + 1, crc = rc, cdk = 1, crk = x;
    } else if (i == 2 * R - 1) {  // merge
      const int md = m0 ? dc + 1 : 0;
      const float lp_m = gate ? af[F_TO1 * M + m] : ind(m1);
      const float lp_c = (m0 && dc == 0) ? af[F_LRCDIAG * M + m] : (m1 ? -INFINITY : af[F_L1RC * M + m]);
      trans = lp_m + lp_c;
      obs = af[F_OBS_C * M + m] + af[F_OBS_KC * M + m];
      cm = 1, cdc = md, crc = rc, cdk = md, crk = rc;
    } else {  // state-independent: control regime ii, case regime jj
      const int k = i - 2 * R, ii = k / R, jj = k - ii * R;
      const bool same = ii == jj;
      const float lp_m = gate ? (same ? af[F_TO1 * M + m] : af[F_TO0 * M + m]) : ind((same ? 1 : 0) == mp);
      const float lp_c = af[F_LRC * M + m] + lp[rcc * R + ii];
      const bool ne = ii != rk;
      const float unif2 = ind(jj != rk) - (ne ? log_rm2 : log_rm1);
      const float lp_k = same ? 0.f : unif2 + ((!ne && m0) ? 0.f : af[F_LRK * M + m]);
      trans = (lp_m + lp_c) + lp_k;
      obs = rowc[ii] + rowk[jj];
      cm = same ? 1 : 0, cdc = 1, crc = ii, cdk = 1, crk = jj;
    }
    if (rc < 0) trans = -INFINITY;  // a dead ancestor
    const float lg = isfinite(trans) ? trans + obs : -INFINITY;
    const float wp = af[F_W * M + m];
    float v;
    if (!need) {
      v = wp + lg;
    } else if (unbiased) {
      v = a.neg_log_m + lg;
    } else if (isfinite(wp)) {
      const float c = log_c + wp;
      v = (wp + lg) - (c > 0.f ? 0.f : c);  // clamp(max=0), NaN kept
    } else {
      v = -INFINITY;
    }
    if (isnan(v)) v = -INFINITY;
    w[n] = v;
    mx = fmaxf(mx, v);
    out_u[n] = cm;
    out_u[N + n] = cdc;
    out_u[2 * N + n] = crc;
    out_u[3 * N + n] = cdk;
    out_u[4 * N + n] = crk;
    if (hist) {
      a.h_m[hrow + n] = (signed char)cm;
      a.h_dc[hrow + n] = cdc;
      a.h_rc[hrow + n] = (signed char)crc;
      a.h_dk[hrow + n] = cdk;
      a.h_rk[hrow + n] = (signed char)crk;
    }
  }

  // ---- 6: renormalise -------------------------------------------------
  mx = warp_max(mx);
  if (lane == 0) s_max[warp] = mx;
  __syncthreads();
  mx = s_max[0];
  for (int k = 1; k < kWarps; ++k) mx = fmaxf(mx, s_max[k]);
  float shift = -INFINITY;
  if (mx != -INFINITY) {  // uniform over the block
    float s = 0.f;
    for (int n = tid; n < N; n += kThreads) s += expf(w[n] - mx);
    s = warp_sum(s);
    if (lane == 0) s_sum[warp] = s;
    __syncthreads();
    s = s_sum[0];
    for (int k = 1; k < kWarps; ++k) s += s_sum[k];
    shift = logf(s) + mx;
  }
  const bool degenerate = !isfinite(shift);
  if (degenerate) shift = 0.f;

  // ---- 7: the weights' writes -------------------------------------------
  float* lw_out = a.out_lw + (size_t)u * N;
  for (int n = tid; n < N; n += kThreads) {
    const float v = degenerate ? a.neg_log_n : w[n] - shift;
    lw_out[n] = v;
    if (hist) a.h_lw[hrow + n] = v;
  }
  if (tid == 0) {
    a.shifts[(size_t)u * a.s_ld + col] = shift;
    a.degen[(size_t)u * a.s_ld + col] = degenerate ? 1 : 0;
  }
}

size_t smem_bytes(int N, int M, int R) {
  return sizeof(float) * ((size_t)N + (size_t)R * R + 2 * (size_t)R + (size_t)kAncF * M) +
         sizeof(int) * (size_t)kAncI * M;
}

}  // namespace

extern "C" {

// The size of FilterStepArgs, which the wrapper holds its struct to.
size_t hygeia_filter_step_args_size() { return sizeof(FilterStepArgs); }

// Launches on `stream`; returns a CUDA error code (0 when the launch was
// accepted). The caller checks shapes (ops/cuda_filter_step.py); this
// refuses a shape that does not add up and shared memory beyond the
// device's opt-in limit all the same.
int hygeia_filter_step(const FilterStepArgs* args, void* stream) {
  const FilterStepArgs& a = *args;
  if (a.U <= 0) return 0;
  if (a.R < 1 || a.M < 1 || a.W < 1 || (long long)a.N != (long long)a.M * (2 * a.R + a.R * a.R))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(a.N, a.M, a.R);
  if (smem > 48 * 1024) {
    // Above 48 KB a block gets dynamic shared memory only after opting in:
    // once per device, to the most the device allows.
    static int opted[64] = {0};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
    if (opted[dev] == 0) {
      int most = 0;
      e = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      if (e != cudaSuccess) return (int)e;
      cudaFuncAttributes attr;
      e = cudaFuncGetAttributes(&attr, filter_step_kernel);
      if (e != cudaSuccess) return (int)e;
      most -= (int)attr.sharedSizeBytes;  // the limit counts the static arrays too
      e = cudaFuncSetAttribute(filter_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
      if (e != cudaSuccess) return (int)e;
      opted[dev] = most;
    }
    if (smem > (size_t)opted[dev]) return (int)cudaErrorInvalidValue;
  }
  filter_step_kernel<<<a.U, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

const char* hygeia_filter_step_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
