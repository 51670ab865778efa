// Fearnhead's optimal finite-state resampler, one thread block per unit.
//
// Replaces the TPU kernel hygeia_tpu/ops/pallas_resampling.py::_kernel
// (called through optimal_finite_state_resampling_pallas). It computes what
// hygeia_tpu/ops/resampling.py::optimal_finite_state_resampling computes
// under the normalized=True contract, with the uniforms drawn outside and
// passed in:
//
//   1. the exact top-(M+1) of the N log-weights, descending, lowest index
//      first among equal values (lax.top_k's order);
//   2. the c-threshold scan over the suffix masses, giving k_star and log_c;
//   3. residual systematic selection of the M - k_star resampled offspring
//      by comparison counts against the prefix sum of the residual weights;
//   4. the multinomial fallback when no threshold is consistent;
//   5. the post-resampling log-weights (kept: previous weight; resampled:
//      -log c; fallback: -log M) and the top-M indices.
//
// Shapes: any M >= 1 with M + 1 <= 1024, and N up to what the block's
// dynamic shared memory holds (9 bytes a weight plus 12 a top slot, and
// 8 bytes a padded key on the sort path) within the H100's 227 KB opt-in
// limit: ~25,000 weights. ops/cuda_resampling.py::supports is the same
// bound in Python, and the launcher refuses what exceeds it.
//
// What bounds it on an H100: not bandwidth (a unit's weights are at most
// ~225 KB, read once) but latency: the chain of dependent block-wide steps
// (the top-(M+1) selection, a scan and a count), each separated by
// __syncthreads. The whole unit stays in shared memory, and one block per
// unit lets one launch serve every unit of a site. Two ways to the
// top-(M+1), chosen per launch by N:
//
//   * N <= 2048 (the single-group engine: M + 1 = 245 of N = 250): a
//     block-wide bitonic sort of (value, index) keys padded to a power of
//     two, log2(P)(log2(P)+1)/2 barrier stages (36 at P = 256). M + 1
//     dependent argmax rounds would be 245 barriers there.
//   * larger N (two-group INFER: M = 50 of N = 2400): M + 1 argmax rounds
//     over cached per-thread bests. Every thread keeps the best of the
//     elements it owns, so a round is one warp shuffle reduction, one
//     exchange through shared memory and a rescan of ~N/256 elements by the
//     thread that owned the winner. M + 1 is small there, and a sort of
//     4096 or more keys would not fit the sort path's budget.
//
// Both orders are the same strict total order (value descending, index
// ascending), so both give lax.top_k's exact top set and order.
//
// Offspring are selected by comparison counts (#{i: q_i < t}), as the JAX
// code does, and not by binary search: a blocked parallel scan rounds at
// chunk joins in a way that does not promise a non-decreasing prefix, and
// the count does not depend on it.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared -Xcompiler -fPIC
// (hygeia_tpu_torch/ops/build.py). Plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <math.h>
#include <limits.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSlots = 1024;  // M + 1 must fit
constexpr int kMaxSortKeys = 2048;  // the sort path's padded key count
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool better(float v, int i, float v2, int i2) {
  return (v > v2) || (v == v2 && i < i2);
}

// Argmax of (v, i) over a warp, result in every lane.
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    float v2 = __shfl_xor_sync(kFull, v, off);
    int i2 = __shfl_xor_sync(kFull, i, off);
    if (better(v2, i2, v, i)) {
      v = v2;
      i = i2;
    }
  }
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

__device__ __forceinline__ int warp_sum_int(int x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// Block-wide sum; every thread gets the result. `scratch` holds kWarps.
__device__ float block_sum(float x, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = warp_sum(x);
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  float y = lane < kWarps ? scratch[lane] : 0.f;
  y = warp_sum(y);
  __syncthreads();  // scratch may be reused right after
  return y;
}

// In-place inclusive prefix sum of q[0..N) in shared memory: each thread
// scans a contiguous chunk, a warp scan combines the chunk totals.
__device__ void block_inclusive_scan(float* q, int N, float* scratch) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunk = (N + kThreads - 1) / kThreads;
  const int start = min(tid * chunk, N), end = min(start + chunk, N);
  float s = 0.f;
  for (int i = start; i < end; ++i) {
    s += q[i];
    q[i] = s;
  }
  float x = s;
  for (int off = 1; off < 32; off <<= 1) {
    float y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    float v = lane < kWarps ? scratch[lane] : 0.f;
    for (int off = 1; off < 32; off <<= 1) {
      float y = __shfl_up_sync(kFull, v, off);
      if (lane >= off) v += y;
    }
    if (lane < kWarps) scratch[lane] = v;
  }
  __syncthreads();
  float excl = __shfl_up_sync(kFull, x, 1);
  if (lane == 0) excl = 0.f;
  const float offset = excl + (warp > 0 ? scratch[warp - 1] : 0.f);
  for (int i = start; i < end; ++i) q[i] += offset;
  __syncthreads();
}

// #{i: q_i < t} (strict) or #{i: q_i <= t}, counted by one warp.
__device__ __forceinline__ int warp_count(const float* q, int N, float t, bool strict) {
  int c = 0;
  for (int i = threadIdx.x & 31; i < N; i += 32) c += strict ? (q[i] < t) : (q[i] <= t);
  return warp_sum_int(c);
}

// Sorts (v, i) keys in shared memory into descending order by better().
// P is a power of two; every thread of the block takes part.
__device__ void block_bitonic_sort(float* v, int* idx, int P) {
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < P; i += kThreads) {
        const int l = i ^ j;
        if (l > i) {
          const float a = v[i], b = v[l];
          const int ia = idx[i], ib = idx[l];
          // In a segment sorted descending, position i gets the better key.
          const bool swap = (i & k) == 0 ? better(b, ib, a, ia) : better(a, ia, b, ib);
          if (swap) {
            v[i] = b;
            v[l] = a;
            idx[i] = ib;
            idx[l] = ia;
          }
        }
      }
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(kThreads) optimal_resampling_kernel(
    const float* __restrict__ lw, const float* __restrict__ u_sys,
    const float* __restrict__ u_mult, int N, int M, int n_sort,
    int* __restrict__ parents, float* __restrict__ new_w,
    int* __restrict__ top_idx_out, float* __restrict__ log_c_out,
    unsigned char* __restrict__ bad_out) {
  const int kk = min(M + 1, N);
  // Dynamic shared memory: the 4-byte arrays first, the flag bytes last.
  extern __shared__ float smem[];
  float* w = smem;                                  // N log-weights
  float* q = w + N;                                 // N prefix sums
  float* s_top_lw = q + N;                          // kk
  float* s_log_c_k = s_top_lw + kk;                 // kk
  int* s_top_idx = reinterpret_cast<int*>(s_log_c_k + kk);  // kk
  float* sort_v = reinterpret_cast<float*>(s_top_idx + kk);  // n_sort
  int* sort_i = reinterpret_cast<int*>(sort_v + n_sort);     // n_sort
  unsigned char* taken = reinterpret_cast<unsigned char*>(sort_i + n_sort);  // N

  __shared__ float s_red_v[2][kWarps];
  __shared__ int s_red_i[2][kWarps];
  __shared__ float s_scratch[kWarps];
  __shared__ int s_k_star;

  const int unit = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* row = lw + (size_t)unit * N;

  for (int i = tid; i < N; i += kThreads) {
    w[i] = row[i];
    taken[i] = 0;
  }
  if (tid == 0) s_k_star = INT_MAX;

  // ---- 1. exact top-kk -----------------------------------------------------
  if (n_sort > 0) {
    // Sort path: pad with (-inf, INT_MAX), which ranks below every real
    // weight (a real -inf has a smaller index), sort, take the first kk.
    for (int i = tid; i < n_sort; i += kThreads) {
      sort_v[i] = i < N ? row[i] : -INFINITY;
      sort_i[i] = i < N ? i : INT_MAX;
    }
    __syncthreads();
    block_bitonic_sort(sort_v, sort_i, n_sort);
    for (int k = tid; k < kk; k += kThreads) {
      s_top_lw[k] = sort_v[k];
      s_top_idx[k] = sort_i[k];
      taken[sort_i[k]] = 1;
    }
  } else {
    // Argmax path: kk rounds over cached per-thread bests.
    __syncthreads();
    float best_v = -INFINITY;
    int best_i = INT_MAX;
    for (int i = tid; i < N; i += kThreads)
      if (better(w[i], i, best_v, best_i)) {
        best_v = w[i];
        best_i = i;
      }
    for (int k = 0; k < kk; ++k) {
      float v = best_v;
      int i = best_i;
      warp_argmax(v, i);
      const int buf = k & 1;  // double buffer: one barrier per round
      if (lane == 0) {
        s_red_v[buf][warp] = v;
        s_red_i[buf][warp] = i;
      }
      __syncthreads();
      v = lane < kWarps ? s_red_v[buf][lane] : -INFINITY;
      i = lane < kWarps ? s_red_i[buf][lane] : INT_MAX;
      warp_argmax(v, i);
      // i == INT_MAX only if every remaining weight is NaN, which the caller
      // excludes; keep the index in bounds all the same.
      if (tid == 0) {
        s_top_lw[k] = v;
        s_top_idx[k] = i < N ? i : 0;
      }
      if (i < N && i % kThreads == tid) {  // the winner's owner rescans its elements
        taken[i] = 1;
        best_v = -INFINITY;
        best_i = INT_MAX;
        for (int j = tid; j < N; j += kThreads)
          if (!taken[j] && better(w[j], j, best_v, best_i)) {
            best_v = w[j];
            best_i = j;
          }
      }
    }
  }
  __syncthreads();

  // ---- 2. c-threshold scan ------------------------------------------------
  // Suffix masses as sums of POSITIVE terms: the tail outside the top set,
  // plus the top block summed from its end (no 1 - prefix cancellation).
  float t_part = 0.f;
  for (int i = tid; i < N; i += kThreads)
    if (!taken[i]) t_part += expf(w[i]);
  const float tail = block_sum(t_part, s_scratch);
  if (tid == 0) {
    float acc = 0.f;
    for (int k = kk - 1; k >= 0; --k) {
      acc += expf(s_top_lw[k]);
      s_log_c_k[k] = acc + tail;  // suffix mass; thread k turns it into log c_k
    }
  }
  __syncthreads();
  for (int k = tid; k < kk; k += kThreads) {
    const float log_c_k = logf(fmaxf((float)(M - k), 0.f)) - logf(s_log_c_k[k]);
    const bool below = log_c_k + s_top_lw[k] <= 0.f;
    const float prev = k == 0 ? INFINITY : s_top_lw[k - 1];
    // Inclusive: at an exact boundary tie keeping and resampling agree.
    const bool above_prev = log_c_k + prev >= 0.f;
    if (below && above_prev && k <= M) atomicMin(&s_k_star, k);
    s_log_c_k[k] = log_c_k;
  }
  __syncthreads();
  const bool bad = s_k_star == INT_MAX;  // no consistent k: fallback
  const int k_star = bad ? N : s_k_star;
  const float log_c = bad ? 0.f : s_log_c_k[min(k_star, kk - 1)];

  // ---- 3./4. prefix sum of the residual (or, in the fallback, all) mass --
  for (int i = tid; i < N; i += kThreads) q[i] = expf(w[i]);
  __syncthreads();
  if (!bad)
    for (int k = tid; k < k_star; k += kThreads) q[s_top_idx[k]] = 0.f;
  __syncthreads();
  block_inclusive_scan(q, N, s_scratch);
  const float total = q[N - 1];

  const float u = u_sys[unit];
  const float l = (float)max(M - k_star, 1);
  const float neg_log_m = -(float)log((double)M);
  for (int j = warp; j < M; j += kWarps) {
    int parent;
    float nw;
    if (bad) {
      const float t = u_mult[(size_t)unit * M + j] * total;
      parent = warp_count(q, N, t, /*strict=*/false);
      nw = neg_log_m;
    } else if (j < k_star) {
      parent = s_top_idx[j];
      nw = s_top_lw[j];
    } else {
      const int g = min(max(j - k_star, 0), M - 1);
      const float t = ((float)g + u) / l * total;
      parent = warp_count(q, N, t, /*strict=*/true);
      nw = -log_c;
    }
    if (lane == 0) {
      const size_t o = (size_t)unit * M + j;
      parents[o] = min(max(parent, 0), N - 1);
      new_w[o] = nw;
      top_idx_out[o] = s_top_idx[min(j, kk - 1)];
    }
  }
  if (tid == 0) {
    log_c_out[unit] = log_c;
    bad_out[unit] = bad ? 1 : 0;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of a launch, in bytes: see the kernel's layout.
static size_t smem_bytes(int N, int M, int n_sort) {
  const int kk = M + 1 < N ? M + 1 : N;
  return (size_t)N * (2 * sizeof(float) + 1) + (size_t)kk * 3 * sizeof(float) +
         (size_t)n_sort * (sizeof(float) + sizeof(int));
}

// Padded key count of the sort path: the next power of two >= N when that
// is at most kMaxSortKeys, else 0 (the argmax path).
static int sort_keys(int N) {
  int p = 2;
  while (p < N) p <<= 1;
  return p <= kMaxSortKeys ? p : 0;
}

// Launches on `stream`; returns a CUDA error code (0 when the launch was
// accepted). The caller checks shapes (ops/cuda_resampling.py::supports);
// this refuses M + 1 > 1024 and shared memory beyond the device's opt-in
// limit all the same.
int hygeia_optimal_resampling(const float* lw, const float* u_sys,
                              const float* u_mult, int U, int N, int M,
                              int* parents, float* new_w, int* top_idx,
                              float* log_c, unsigned char* bad, void* stream) {
  if (U <= 0) return 0;
  if (M < 1 || M + 1 > kMaxSlots || N < 1) return (int)cudaErrorInvalidValue;
  const int n_sort = sort_keys(N);
  const size_t smem = smem_bytes(N, M, n_sort);
  if (smem > 48 * 1024) {
    // Above 48 KB a block gets dynamic shared memory only after opting in.
    const cudaError_t e = cudaFuncSetAttribute(
        optimal_resampling_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  optimal_resampling_kernel<<<U, kThreads, smem, (cudaStream_t)stream>>>(
      lw, u_sys, u_mult, N, M, n_sort, parents, new_w, top_idx, log_c, bad);
  return (int)cudaGetLastError();
}

const char* hygeia_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
