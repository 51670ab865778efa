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
// dynamic shared memory holds within the H100's 227 KB opt-in limit
// (8 bytes a weight: ~28,000). ops/cuda_resampling.py::supports and ::smem_bytes state
// the same layout in Python, and the launcher refuses what exceeds it.
//
// What bounds it on an H100: not bytes (a unit's weights are 1 to 100 KB,
// read once: nanoseconds at the card's memory rate) and not arithmetic
// (about N expf) but latency: the chain of dependent block-wide steps, each
// ended by a __syncthreads, on top of the floor of one launch. TMA, wgmma
// and clusters have nothing to offer ~10 KB of work a block. The design
// therefore cuts the number and the length of the dependent steps:
//
//   * Top-(M+1). Every weight gets a 64-bit key, (order-preserving bits of
//     the value, ~index), so that one unsigned comparison is the strict
//     order "value descending, index ascending" and all keys differ. A
//     block of T threads sorts up to T keys, one per thread in registers,
//     with a bitonic network whose compare-exchanges go through warp
//     shuffles for partner distances below 32 and through shared memory
//     (one barrier each) above: 6 barriers for 256 keys, not 36.
//     When N > T (two-group INFER: M + 1 = 51 of N = 2400) a radix select
//     comes first: 8-bit digits of the key from the top, one shared-memory
//     histogram and one barrier a pass, every warp scanning the 256 bins
//     for itself. It stops as soon as the keys at or above the pivot's
//     prefix number at most 256 (or the power of two that holds M + 1):
//     two passes on continuous weights; ties and -inf runs go on into the
//     index bits, six passes at most, and end because keys are distinct.
//     Those candidates are compacted and sorted; the first M + 1 are the
//     answer. No round depends on M.
//   * Suffix masses. The exponentials are taken by M + 1 threads; the
//     additions stay one serial chain from the end of the block, because
//     the threshold test decides k_star on their last rounding and the
//     plain version sums in that order. The chain runs across the lanes
//     of one warp, eight terms a lane, the running sum handed on by
//     shuffle: the same additions in the same order as one thread's.
//   * Offspring in O(N + M). The systematic thresholds t_g = (g + u) / l *
//     total do not decrease in g and are computed once, into shared
//     memory. A thread walks a contiguous chunk of prefix sums, finds for
//     each q_i the first g with q_i < t_g (a guess for the first, then
//     steps against the stored thresholds) and adds each run of one g to
//     that bin with one atomic; a scan of the M + 1 bins gives every
//     offspring's comparison count #{i: q_i < t_g}, equal bit for bit to
//     counting per offspring. It does not need q to be non-decreasing.
//     The multinomial fallback (unordered uniforms, rare) keeps the counts.
//   * Sums whose rounding reaches an output (the tail mass, the prefix
//     scan) are taken over kLanes = 256 lanes in one stated order whatever
//     the block size, so a launch gives the same bits at every T.
//
// Block size by shape: T = 256 for N <= 256 (the engine: one weight a
// thread), 512 above (INFER: the O(N) stages are loops over N / T), or the
// next power of two >= M + 1 when that is larger (the sort holds one key a
// thread).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared -Xcompiler -fPIC
// (hygeia_tpu_torch/ops/build.py). Plain C interface, loaded with ctypes.
// -DHYGEIA_STAGE_CLOCKS adds clock64() stamps after each stage, for
// tools/measure_resampler_cuda.py; no other build defines it.

#include <cuda_runtime.h>
#include <math.h>
#include <limits.h>

namespace {

constexpr int kLanes = 256;  // lanes of the stated summation order
constexpr int kLaneWarps = kLanes / 32;
constexpr int kMinThreads = 256;  // a block of the engine's shape (N <= 256)
constexpr int kWideThreads = 512;  // a block for N > 256
constexpr int kMaxThreads = 1024;
constexpr int kMaxSlots = 1024;  // M + 1 must fit
constexpr int kBins = 256;       // one radix digit
constexpr int kPasses = 6;       // 4 digits of the value, 2 of the index
constexpr unsigned kFull = 0xffffffffu;
typedef unsigned long long u64;

#ifdef HYGEIA_STAGE_CLOCKS
constexpr int kStamps = 8;
#define STAMP(s) \
  if (threadIdx.x == 0 && clocks) clocks[(size_t)blockIdx.x * kStamps + (s)] = clock64()
#else
#define STAMP(s)
#endif

// Bits of a float as an unsigned whose order is the floats' order; -0.0
// and +0.0 get one key, -inf the lowest of the non-NaN keys.
__device__ __forceinline__ unsigned order_key(float v) {
  unsigned b = __float_as_uint(v);
  if (b == 0x80000000u) b = 0u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// Larger key = better: value descending, then index ascending. Never 0.
__device__ __forceinline__ u64 sort_key(float v, int i) {
  return ((u64)order_key(v) << 32) | (unsigned)(~i);
}

__device__ __forceinline__ int key_index(u64 key) { return (int)(~(unsigned)key); }

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

__device__ __forceinline__ int warp_sum_int(int x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// Sum over the kLanes lanes (threads past them pass 0); every thread gets
// the result. `scratch` holds kLaneWarps floats.
__device__ float lanes_sum(float x, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = warp_sum(x);
  if (lane == 0 && warp < kLaneWarps) scratch[warp] = x;
  __syncthreads();
  float y = lane < kLaneWarps ? scratch[lane] : 0.f;
  return warp_sum(y);
}

// Inclusive prefix over the kLaneWarps warp totals in `scratch`, by every
// warp for itself (a Hillis-Steele scan over lanes 0..7).
__device__ __forceinline__ float scan_lane_warps(const float* scratch) {
  const int lane = threadIdx.x & 31;
  float v = lane < kLaneWarps ? scratch[lane] : 0.f;
  for (int off = 1; off < 32; off <<= 1) {
    float y = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += y;
  }
  return v;
}

// In-place inclusive prefix sum of q[0..N) in shared memory over kLanes
// lanes: lane t sums the contiguous chunk t, a warp scan and a scan of the
// warp totals give its offset. Ends with a barrier.
__device__ void lanes_inclusive_scan(float* q, int N, float* scratch) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunk = (N + kLanes - 1) / kLanes;
  const int start = min(tid * chunk, N), end = min(start + chunk, N);
  float x = 0.f;
  if (tid < kLanes) {
    float s = 0.f;
    for (int i = start; i < end; ++i) {
      s += q[i];
      q[i] = s;
    }
    x = s;
    for (int off = 1; off < 32; off <<= 1) {
      float y = __shfl_up_sync(kFull, x, off);
      if (lane >= off) x += y;
    }
    if (lane == 31) scratch[warp] = x;
  }
  __syncthreads();
  if (tid < kLanes) {
    const float v = scan_lane_warps(scratch);
    const float before = __shfl_sync(kFull, v, max(warp - 1, 0));
    float excl = __shfl_up_sync(kFull, x, 1);
    if (lane == 0) excl = 0.f;
    const float offset = excl + (warp > 0 ? before : 0.f);
    for (int i = start; i < end; ++i) q[i] += offset;
  }
  __syncthreads();
}

// #{i: q_i <= t}, counted by one warp (the multinomial fallback).
__device__ __forceinline__ int warp_count_le(const float* q, int N, float t) {
  int c = 0;
  for (int i = threadIdx.x & 31; i < N; i += 32) c += q[i] <= t;
  return warp_sum_int(c);
}

// Adds `count` to bins[bin] for every lane whose `on` is set; when all
// those lanes name one bin the warp sends one atomic. All 32 lanes call.
// (Grouping the lanes by bin with __match_any_sync was measured slower
// than letting the differing lanes send their own atomics.)
__device__ __forceinline__ void warp_histogram_add(int* bins, int bin, int count, bool on) {
  const unsigned votes = __ballot_sync(kFull, on);
  if (votes == 0u) return;
  const int first = __ffs(votes) - 1;
  const int bin0 = __shfl_sync(kFull, bin, first);
  if (__all_sync(kFull, !on || bin == bin0)) {
    const int sum = warp_sum_int(on ? count : 0);
    if ((threadIdx.x & 31) == first) atomicAdd(&bins[bin0], sum);
  } else if (on) {
    atomicAdd(&bins[bin], count);
  }
}

// Sorts P keys descending, one per thread (threads tid < P; P a power of
// two, 32 <= P <= blockDim.x); every thread of the block must call.
// `xch` holds 2 * P keys.
// One compare-exchange of the bitonic network: in a segment sorted
// descending (bit k of the position clear) the lower position keeps the max.
__device__ __forceinline__ u64 keep_of_pair(u64 key, u64 other, int tid, int j, int k) {
  const bool take_max = ((tid & j) == 0) == ((tid & k) == 0);
  return take_max == (other > key) ? other : key;
}

__device__ u64 block_sort_descending(u64 key, int P, u64* xch) {
  const int tid = threadIdx.x;
  const bool active = tid < P;  // uniform over a warp: P is a multiple of 32
  if (active) {
#pragma unroll
    for (int k = 2; k <= 32; k <<= 1)
#pragma unroll
      for (int j = k >> 1; j > 0; j >>= 1)
        key = keep_of_pair(key, __shfl_xor_sync(kFull, key, j), tid, j, k);
  }
  int buf = 0;
  for (int k = 64; k <= P; k <<= 1) {
    for (int j = k >> 1; j >= 32; j >>= 1) {
      u64* x = xch + buf * P;  // two buffers in turn: one barrier a stage
      if (active) x[tid] = key;
      __syncthreads();
      if (active) key = keep_of_pair(key, x[tid ^ j], tid, j, k);
      buf ^= 1;
    }
    if (active) {
#pragma unroll
      for (int j = 16; j > 0; j >>= 1)
        key = keep_of_pair(key, __shfl_xor_sync(kFull, key, j), tid, j, k);
    }
  }
  return key;
}

__global__ void __launch_bounds__(kMaxThreads) optimal_resampling_kernel(
    const float* __restrict__ lw, const float* __restrict__ u_sys,
    const float* __restrict__ u_mult, int N, int M,
    int* __restrict__ parents, float* __restrict__ new_w,
    int* __restrict__ top_idx_out, float* __restrict__ log_c_out,
    unsigned char* __restrict__ bad_out
#ifdef HYGEIA_STAGE_CLOCKS
    , long long* __restrict__ clocks
#endif
) {
  const int T = blockDim.x;
  const int kk = min(M + 1, N);
  // Dynamic shared memory, see smem_bytes(): a scratch region first (the
  // select's histograms and the sort's exchange buffers, later the N prefix
  // sums), then the weights and the three (M+1)-slot arrays.
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t scratch_bytes =
      max((size_t)N * sizeof(float), (size_t)kPasses * kBins * sizeof(int) + 2 * (size_t)T * sizeof(u64));
  int* hists = reinterpret_cast<int*>(smem_raw);                         // kPasses * kBins
  u64* xch = reinterpret_cast<u64*>(smem_raw + kPasses * kBins * sizeof(int));  // 2 * T
  float* q = reinterpret_cast<float*>(smem_raw);                         // N, after the sort
  float* w = reinterpret_cast<float*>(smem_raw + ((scratch_bytes + 15) & ~(size_t)15));  // N
  float* s_top_lw = w + N;                                               // M + 1
  float* s_log_c_k = s_top_lw + (M + 1);                                 // M + 1
  int* s_top_idx = reinterpret_cast<int*>(s_log_c_k + (M + 1));          // M + 1
  int* bins = reinterpret_cast<int*>(s_log_c_k);  // offspring bins, once log_c is read
  // The systematic thresholds, once the weights are no longer read: in w,
  // or behind q where w is too short (N <= M; the scratch region has room).
  float* thr = N > M ? w : q + N;

  __shared__ float s_scratch[kLaneWarps];
  __shared__ int s_warp_tot[kMaxThreads / 32];
  __shared__ int s_k_star;
  __shared__ int s_count;
  __shared__ u64 s_pivot;  // the smallest key of the top set

  const int unit = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* row = lw + (size_t)unit * N;
  STAMP(0);

  if ((N & 3) == 0 && (reinterpret_cast<size_t>(row) & 15) == 0) {
    const float4* row4 = reinterpret_cast<const float4*>(row);
    float4* w4 = reinterpret_cast<float4*>(w);
    for (int i = tid; i < N / 4; i += T) w4[i] = row4[i];
  } else {
#pragma unroll 4
    for (int i = tid; i < N; i += T) w[i] = row[i];
  }
  if (N > T)
    for (int i = tid; i < kPasses * kBins; i += T) hists[i] = 0;
  if (tid == 0) {
    s_k_star = INT_MAX;
    s_count = 0;
  }
  __syncthreads();
  STAMP(1);

  // ---- 1. exact top-kk -----------------------------------------------------
  u64 key = 0;  // 0 ranks below every real key: the sort's padding
  int P = 32;
  if (N <= T) {
    if (tid < N) key = sort_key(w[tid], tid);
    while (P < N) P <<= 1;
  } else {
    // Radix select of the kk-th largest key: `prefix` holds the pivot's
    // digits found so far, `need` how many keys of the pivot's bin belong
    // to the top set, `cand` how many keys lie at or above the prefix.
    u64 prefix = 0;
    int need = kk, cand = N;
    int cap = kMinThreads;  // stop here: a short sort beats another pass
    while (cap < kk) cap <<= 1;
    for (int p = 0; p < kPasses && cand > cap; ++p) {
      // Digits at bits 56, 48, 40, 32 (the value), then 8 and 0 (the
      // index: bits 16..31 of ~i are ones for every i < 65536).
      const int shift = p < 4 ? 56 - 8 * p : 8 * (5 - p);
      const int above = shift + 8;  // the bits known so far start here
      if (p == 4) prefix |= 0xffff0000ull;
      int* hist = hists + p * kBins;
      // A thread counts runs of one digit among its elements and sends an
      // atomic only where the digit changes; the last run goes out through
      // the warp (like values share their upper digits).
      int run_digit = 0, run = 0;
#pragma unroll 2
      for (int i = tid; i < N; i += T) {
        const u64 k_i = sort_key(w[i], i);
        if (p == 0 || (k_i >> above) == (prefix >> above)) {
          const int digit = (int)((k_i >> shift) & (kBins - 1));
          if (digit != run_digit && run > 0) {
            atomicAdd(&hist[run_digit], run);
            run = 0;
          }
          run_digit = digit;
          ++run;
        }
      }
      warp_histogram_add(hist, run_digit, run, run > 0);
      __syncthreads();
      // Every warp finds the pivot's digit for itself: lane L holds bins
      // 8L..8L+7, a suffix scan over lanes finds the lane where the count
      // from the top reaches `need`.
      const int4 lo = reinterpret_cast<const int4*>(hist)[2 * lane];
      const int4 hi = reinterpret_cast<const int4*>(hist)[2 * lane + 1];
      const int c[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      int s = 0;
#pragma unroll
      for (int b = 0; b < 8; ++b) s += c[b];
      int suf = s;
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_down_sync(kFull, suf, off);
        if (lane + off < 32) suf += y;
      }
      const int src = 31 - __clz(__ballot_sync(kFull, suf >= need) | 1u);
      int digit = 0, greater = 0, bin = 0;
      if (lane == src) {
        int acc = suf - s;
#pragma unroll
        for (int b = 7; b >= 0; --b) {
          if (bin == 0) {
            if (acc + c[b] >= need) {
              digit = 8 * lane + b;
              greater = acc;
              bin = c[b];
            } else {
              acc += c[b];
            }
          }
        }
      }
      digit = __shfl_sync(kFull, digit, src);
      greater = __shfl_sync(kFull, greater, src);
      bin = __shfl_sync(kFull, bin, src);
      need -= greater;
      prefix |= (u64)digit << shift;
      cand = (kk - need) + bin;
    }
    // Compact the candidates (any order: the sort orders them).
    u64* cand_keys = xch + T;  // the sort writes its first stage into xch[0..P)
#pragma unroll 2
    for (int i = tid; i < N; i += T) {
      const u64 k_i = sort_key(w[i], i);
      if (k_i >= prefix) {
        const int slot = atomicAdd(&s_count, 1);
        if (slot < cap) cand_keys[slot] = k_i;
      }
    }
    __syncthreads();
    const int count = min(s_count, cap);
    if (tid < count) key = cand_keys[tid];
    while (P < count) P <<= 1;
  }
  key = block_sort_descending(key, P, xch);
  if (tid < kk) {
    // A key of 0 here means NaN weights, which the caller excludes; keep
    // the index in bounds all the same.
    const int idx = key ? min(key_index(key), N - 1) : 0;
    const float v = w[idx];
    s_top_idx[tid] = idx;
    s_top_lw[tid] = v;
    s_log_c_k[tid] = expf(v);  // turned into the suffix mass below
    if (tid == kk - 1) s_pivot = key;
  }
  __syncthreads();
  STAMP(2);

  // ---- 2. c-threshold scan ------------------------------------------------
  // Suffix masses as sums of POSITIVE terms: the tail outside the top set,
  // plus the top block summed from its end (no 1 - prefix cancellation).
  // q gets every weight's exponential on the way; the kept ones are zeroed
  // once k_star is known.
  for (int i = tid; i < N; i += T) q[i] = expf(w[i]);
  if (T != kLanes) __syncthreads();  // lanes below read what other threads wrote
  float t_part = 0.f;
  if (tid < kLanes) {
    const u64 pivot = s_pivot;  // keys differ: the top set is the keys >= pivot
    for (int i = tid; i < N; i += kLanes)
      if (sort_key(w[i], i) < pivot) t_part += q[i];
  }
  if (warp == 0) {
    // The one serial chain: kk additions from the end of the top block.
    // Lane L holds elements 8L..8L+7 of a round of 256; the running sum
    // goes from lane to lane by shuffle, eight dependent adds a step, so
    // the additions are the ones a single thread would make, in its order.
    float carry = 0.f;
    for (int hi = ((kk - 1) | 255) + 1; hi > 0; hi -= 256) {
      const int base = hi - 256 + 8 * lane;  // this lane's lowest element
      float e[8], a[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = base + j < kk ? s_log_c_k[base + j] : 0.f;
      for (int src = min(31, (kk - 1 - (hi - 256)) >> 3); src >= 0; --src) {
        float acc = carry;
#pragma unroll
        for (int j = 7; j >= 0; --j) {
          acc += e[j];  // past the block's end e is +0: the sum is unchanged
          if (lane == src) a[j] = acc;
        }
        carry = __shfl_sync(kFull, acc, src);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (base + j < kk) s_log_c_k[base + j] = a[j];
    }
  }
  const float tail = lanes_sum(t_part, s_scratch);  // its barrier publishes the chain
  STAMP(3);
  if (tid < kk) {
    const int k = tid;
    const float log_c_k = logf(fmaxf((float)(M - k), 0.f)) - logf(s_log_c_k[k] + tail);
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
  STAMP(4);

  // ---- 3./4. prefix sum of the residual (or, in the fallback, all) mass --
  if (!bad)
    for (int k = tid; k < k_star; k += T) q[s_top_idx[k]] = 0.f;
  __syncthreads();  // also: every thread has read log_c, so the bins may go
  for (int g = tid; g <= M; g += T) bins[g] = 0;
  lanes_inclusive_scan(q, N, s_scratch);
  const float total = q[N - 1];
  STAMP(5);

  const float u = u_sys[unit];
  const int n_res = bad ? 0 : M - k_star;  // resampled offspring
  const float l = (float)max(M - k_star, 1);
  if (tid < n_res) thr[tid] = ((float)tid + u) / l * total;  // n_res <= M < T
  const size_t out = (size_t)unit * M;
  if (bad) {
    const float neg_log_m = -(float)log((double)M);
    for (int j = warp; j < M; j += T / 32) {
      const float t = u_mult[out + j] * total;
      const int parent = warp_count_le(q, N, t);
      if (lane == 0) {
        parents[out + j] = min(max(parent, 0), N - 1);
        new_w[out + j] = neg_log_m;
      }
    }
    STAMP(6);
  } else {
    // Bin g counts the prefix sums whose first threshold above them is
    // t_g; the inclusive scan of the bins is #{i: q_i < t_g}.
    __syncthreads();  // the thresholds
    // A thread takes a contiguous chunk: its prefix sums rise (up to the
    // scan's rounding), so the bin moves forward a step at a time from the
    // first element's guess, and a run of one bin costs one atomic.
    const int chunk = (N + T - 1) / T;
    const int start = min(tid * chunk, N), end = min(start + chunk, N);
    int g = n_res, run_g = n_res, run = 0;
    if (start < end && total > 0.f)
      g = min(max((int)ceilf(q[start] * (l / total) - u), 0), n_res);
    for (int i = start; i < end; ++i) {
      const float qi = q[i];
      while (g > 0 && qi < thr[g - 1]) --g;
      while (g < n_res && !(qi < thr[g])) ++g;
      if (g != run_g && run > 0) {
        if (run_g < n_res) atomicAdd(&bins[run_g], run);
        run = 0;
      }
      run_g = g;
      ++run;
    }
    if (run > 0 && run_g < n_res) atomicAdd(&bins[run_g], run);
    __syncthreads();
    int c = tid < n_res ? bins[tid] : 0;  // n_res <= M < T: one bin a thread
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, c, off);
      if (lane >= off) c += y;
    }
    if (lane == 31) s_warp_tot[warp] = c;
    __syncthreads();
    int tot = lane < T / 32 ? s_warp_tot[lane] : 0;
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, tot, off);
      if (lane >= off) tot += y;
    }
    const int before = __shfl_sync(kFull, tot, max(warp - 1, 0));
    if (warp > 0) c += before;
    STAMP(6);
    if (tid < k_star && tid < M) {  // kept: the previous weight
      parents[out + tid] = s_top_idx[tid];
      new_w[out + tid] = s_top_lw[tid];
    }
    if (tid < n_res) {  // resampled offspring g = tid, slot k_star + g
      parents[out + k_star + tid] = min(max(c, 0), N - 1);
      new_w[out + k_star + tid] = -log_c;
    }
  }
  if (tid < M) top_idx_out[out + tid] = s_top_idx[min(tid, kk - 1)];
  if (tid == 0) {
    log_c_out[unit] = log_c;
    bad_out[unit] = bad ? 1 : 0;
  }
  STAMP(7);
}

// The floor of one launch: an empty block through the same interface.
__global__ void empty_kernel() {}

int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

#ifdef HYGEIA_STAGE_CLOCKS
long long* g_stage_clocks = nullptr;
#endif

}  // namespace

extern "C" {

// Threads of a block: kMinThreads for N <= kMinThreads (one weight a
// thread), kWideThreads above; the next power of two >= M + 1 when that is
// larger (the sort holds one key a thread).
int hygeia_resampling_threads(int N, int M) {
  const int base = N <= kMinThreads ? kMinThreads : kWideThreads;
  const int p = next_pow2(M + 1);
  return p > base ? p : base;
}

// Dynamic shared memory of a launch, in bytes: see the kernel's layout.
size_t hygeia_resampling_smem_bytes(int N, int M) {
  const size_t T = (size_t)hygeia_resampling_threads(N, M);
  size_t scratch = (size_t)kPasses * kBins * sizeof(int) + 2 * T * sizeof(u64);
  if ((size_t)N * sizeof(float) > scratch) scratch = (size_t)N * sizeof(float);
  scratch = (scratch + 15) & ~(size_t)15;
  return scratch + (size_t)N * sizeof(float) + (size_t)(M + 1) * 3 * sizeof(float);
}

// Launches on `stream`; returns a CUDA error code (0 when the launch was
// accepted). The caller checks shapes (ops/cuda_resampling.py::supports);
// this refuses M + 1 > 1024, N >= 65536 and shared memory beyond the
// device's opt-in limit all the same.
int hygeia_optimal_resampling(const float* lw, const float* u_sys,
                              const float* u_mult, int U, int N, int M,
                              int* parents, float* new_w, int* top_idx,
                              float* log_c, unsigned char* bad, void* stream) {
  if (U <= 0) return 0;
  if (M < 1 || M + 1 > kMaxSlots || N < 1 || N >= 65536) return (int)cudaErrorInvalidValue;
  const size_t smem = hygeia_resampling_smem_bytes(N, M);
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
      e = cudaFuncGetAttributes(&attr, optimal_resampling_kernel);
      if (e != cudaSuccess) return (int)e;
      most -= (int)attr.sharedSizeBytes;  // the limit counts the static arrays too
      e = cudaFuncSetAttribute(optimal_resampling_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, most);
      if (e != cudaSuccess) return (int)e;
      opted[dev] = most;
    }
    if (smem > (size_t)opted[dev]) return (int)cudaErrorInvalidValue;
  }
  optimal_resampling_kernel<<<U, hygeia_resampling_threads(N, M), smem, (cudaStream_t)stream>>>(
      lw, u_sys, u_mult, N, M, parents, new_w, top_idx, log_c, bad
#ifdef HYGEIA_STAGE_CLOCKS
      , g_stage_clocks
#endif
  );
  return (int)cudaGetLastError();
}

// One empty block on `stream`: what a launch costs before it does anything.
int hygeia_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

#ifdef HYGEIA_STAGE_CLOCKS
// Where the next launches write their stamps: U * 8 clock64() values (load,
// top-(M+1), tail and suffix, threshold, prefix scan, selection, stores),
// or null for none.
void hygeia_set_stage_clocks(long long* clocks) { g_stage_clocks = clocks; }
#endif

const char* hygeia_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
