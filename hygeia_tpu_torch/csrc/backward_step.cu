// K3: one site of the two-group backward simulation, one thread block per
// (unit, trajectory row).
//
// No TPU kernel of the JAX package computes this: hygeia_tpu composes the
// step from XLA ops inside its backward pass's reverse scan
// (hygeia_tpu/two_group/backward.py: _backward_logits with the structured
// hazards of _structured_rho, the Gumbel noise of jax.random.gumbel and
// _categorical_rows). The port's plain version is
// hygeia_tpu_torch/two_group/backward.py: _plain_site, i.e.
// _backward_logits(..., history_layout=True) with _structured_rho, the
// Gumbel transform of ``gumbel`` and _categorical_rows, then the carry and
// trajectory writes. Given the site's (U, B, N) uniforms, drawn outside by
// torch.rand from the backward pass's generators, a block:
//
//   1. reads t from the device index idx = (t, blocks done) (never the
//      host) and its row's next state from the carry nxt (U, B, 5);
//   2. stages in shared memory what depends on the next state and on an
//      ancestor or a regime alone: for each of the M ancestors (slot 0 of
//      the history's N = I*M child layout) the three structured hazards,
//      for each regime the duration-1 hazards and the control transition
//      into the next control regime. Of each hazard it keeps the one log
//      the row uses: log rho where the next duration is 1, log1p(-rho)
//      elsewhere (the next state is the row's, so the choice is the
//      block's);
//   3. forms, for each particle n = i*M + m of history row t, the logit
//      lw_t[n] + (lp_m + lp_c) + lp_k with the plain version's terms in its
//      order and its -inf rules (a dead slot or a non-finite transition
//      gives -inf), adds the Gumbel noise -log(-log(max(u, FLT_MIN))) and
//      keeps the thread's largest, first index on ties, as torch.argmax
//      does (NaN above every number). The logits never leave registers;
//   4. takes the block's argmax: a butterfly over each warp, then the
//      warps' winners in warp order. The order "larger value, then lower
//      index" is total, so any reduction tree gives the same particle;
//   5. gathers the chosen particle's five fields into row t of traj and
//      into the carry nxt (in place: only this block reads its row);
//   6. counts itself done in idx[1]; the last block of the launch sets t
//      to t - 1 and the count back to 0. Every block reads t before it
//      counts itself, so none can read the decremented index.
//
// What bounds it on an H100: latency. At the benchmark's shape (U, B, N) =
// (2, 25, 2,400) a launch reads ~0.55 MB (the history row, 15 B a
// particle, read by each of a unit's B blocks from L2, and the uniforms
// once): ~0.16 us at 3.35 TB/s; its arithmetic is ~10^6 flops, most of it
// the noise's two logf a particle. The floor is one launch (~1.7 us) plus
// the block's chain: the index and carry, the staged hazards, the history
// and uniform loads, one barrier to stage and two in the argmax. Against
// the plain composition, ~120 small kernels over (U, B, N) tensors a site,
// it saves their launches and the round trips of every (U, B, N)
// intermediate through memory. One block a row puts U*B blocks on the
// card's 132 SMs (50 at the benchmark's shape) and recomputes nothing that
// is dear a row: the hazard logs are staged once a block (3M + 2R logf),
// and a particle costs its loads, a few adds and selects and the noise.
// Dead slots (lw = -inf) skip the noise: their value is -inf either way.
//
// Bits: every f32 term is the plain version's (the same IEEE additions in
// the same order, no multiplications to contract; logf and log1pf as
// PyTorch's CUDA log and log1p; no fast-math intrinsics), so the logit,
// the noise and their sum are its values, and the argmax its particle.
//
// Shapes: any U, B >= 1, R >= 1, N = M * (2R + R^2), with the block's
// dynamic shared memory (4 * (3M + 3R + 4) bytes) within the card's opt-in
// limit. ops/cuda_backward_step.py::supports and ::smem_bytes state the
// same layout in Python.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared -Xcompiler -fPIC
// (hygeia_tpu_torch/ops/build.py). Plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

// The launch's arguments, one struct so that a graph's capture keeps them
// by value. Mirrored field for field by ops/cuda_backward_step.py::_Args.
// Outside the unnamed namespace: the exported entry takes it, and a type
// of internal linkage in its signature would hide the entry's symbol.
struct BackwardStepArgs {
  long long* idx;  // (2,): site t, blocks of this launch done (0 between launches)
  const float* h_lw;  // (U, T, N) filter history: weights
  const signed char* h_m;  // (U, T, N) merged flag
  const int* h_dc;  // (U, T, N) control duration
  const signed char* h_rc;  // (U, T, N) control regime, -1 dead
  const int* h_dk;  // (U, T, N) case duration
  const signed char* h_rk;  // (U, T, N) case regime, -1 dead
  const float* uniforms;  // (U, B, N) the site's uniforms
  const float* rho_both;  // (2, R, W) control and case hazards
  const float* log_p_control;  // (R, R)
  const float* log_p_merged;  // (2, 2)
  int* nxt;  // (U, B, 5) (m, d_c, r_c, d_k, r_k) at t + 1, overwritten with t's
  int* traj;  // (U, T, B, 5): row t written
  long long T;
  int U, B, N, M, R, W, min_duration;
};

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNone = 0x7fffffff;  // the index of "no particle yet": loses every tie

__device__ __forceinline__ float ind(bool c) { return c ? 0.f : -INFINITY; }

// torch.argmax's order: NaN above every number, then the larger value,
// then the lower index. True when (a, ia) comes first.
__device__ __forceinline__ bool first(float a, int ia, float b, int ib) {
  if (isnan(a)) return isnan(b) ? ia < ib : true;
  return a == b ? ia < ib : a > b;
}

__device__ __forceinline__ void warp_argmax(float& v, int& n) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, off);
    const int on = __shfl_xor_sync(kFull, n, off);
    if (first(ov, on, v, n)) v = ov, n = on;
  }
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) { return min(max(x, lo), hi); }

__global__ void __launch_bounds__(kThreads) backward_step_kernel(const BackwardStepArgs a) {
  const int u = blockIdx.x / a.B, b = blockIdx.x - u * a.B;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int N = a.N, M = a.M, R = a.R, W = a.W;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* fc_anc = reinterpret_cast<float*>(smem_raw);  // M: control, deep (ancestor's d_c)
  float* fk_cont = fc_anc + M;  // M: case, deep, every slot but the merge
  float* fk_merge = fk_cont + M;  // M: case, deep, the merge slot (ancestor's d_c)
  float* fc1 = fk_merge + M;  // R: control, duration 1, by the particle's r_c
  float* fk1 = fc1 + R;  // R: case, duration 1, by the particle's r_k
  float* lpc = fk1 + R;  // R: log_p_control[r, next r_c]
  float* lpm = lpc + R;  // 4: log_p_merged
  __shared__ float s_v[kWarps];
  __shared__ int s_n[kWarps];

  // ---- 1: the site and the row's next state ----------------------------
  const long long t = a.idx[0];
  int* nxt = a.nxt + ((size_t)u * a.B + b) * 5;
  const int nm = nxt[0], ndc = nxt[1], nrc = nxt[2], ndk = nxt[3], nrk = nxt[4];
  const bool nxt_dc1 = ndc == 1, nxt_dk1 = ndk == 1;
  const int nrc_col = clampi(nrc < 0 ? nrc + R : nrc, 0, R - 1);  // indexing wraps -1 to R - 1
  const float log_rm1 = logf((float)(R - 1)), log_rm2 = logf((float)(R - 2));
  const bool ne_kc = nrk != nrc;
  const float lp_a = ind(nrk == nrc && ndk == ndc);
  const float lp_b = (ind(ne_kc) - log_rm1) + ind(nxt_dk1);

  // ---- 2: hazards and tables of the row --------------------------------
  const size_t row = ((size_t)u * a.T + t) * N;
  for (int m = tid; m < M; m += kThreads) {
    const int dc0 = min(max(a.h_dc[row + m] - 1, 0), W - 1), dk0 = min(max(a.h_dk[row + m] - 1, 0), W - 1);
    const int rc0 = clampi(a.h_rc[row + m], 0, R - 1), rk0 = clampi(a.h_rk[row + m], 0, R - 1);
    const float a_c = a.rho_both[(size_t)rc0 * W + dc0];
    const float c_cont = a.rho_both[((size_t)R + rk0) * W + dk0];
    const float c_merge = a.rho_both[((size_t)R + rc0) * W + dc0];
    fc_anc[m] = nxt_dc1 ? logf(a_c) : log1pf(-a_c);
    fk_cont[m] = nxt_dk1 ? logf(c_cont) : log1pf(-c_cont);
    fk_merge[m] = nxt_dk1 ? logf(c_merge) : log1pf(-c_merge);
  }
  for (int r = tid; r < R; r += kThreads) {
    const float s_c = a.rho_both[(size_t)r * W], s_k = a.rho_both[((size_t)R + r) * W];
    fc1[r] = nxt_dc1 ? logf(s_c) : log1pf(-s_c);
    fk1[r] = nxt_dk1 ? logf(s_k) : log1pf(-s_k);
    lpc[r] = a.log_p_control[r * R + nrc_col];
  }
  if (tid < 4) lpm[tid] = a.log_p_merged[tid];
  __syncthreads();

  // ---- 3: logits, noise and the thread's argmax -------------------------
  const float* urow = a.uniforms + ((size_t)u * a.B + b) * N;
  const int merge_slot = 2 * R - 1;
  float best_v = -INFINITY;
  int best_n = kNone;
  for (int n = tid; n < N; n += kThreads) {
    const float lw = a.h_lw[row + n];
    float v = -INFINITY;
    if (lw > -INFINITY) {  // else (and for NaN) the logit is -inf
      const int cm = a.h_m[row + n], cdc = a.h_dc[row + n], crc = a.h_rc[row + n];
      const int cdk = a.h_dk[row + n], crk = a.h_rk[row + n];
      const int i = n / M, m = n - i * M;
      const int rcc = clampi(crc, 0, R - 1), rkc = clampi(crk, 0, R - 1);
      const float fc = cdc <= 1 ? fc1[rcc] : fc_anc[m];
      const float fk = cdk <= 1 ? fk1[rkc] : (i == merge_slot ? fk_merge[m] : fk_cont[m]);
      const bool gate = min(cdk, cdc) >= a.min_duration;
      const int mc = clampi(cm, 0, 1);
      const float lp_m = gate ? (nm == 0 ? lpm[2 * mc] : lpm[2 * mc + 1]) : ind(nm == cm);
      const float lp_c = nxt_dc1 ? fc + lpc[rcc] : (fc + ind(cdc == ndc - 1)) + ind(crc == nrc);
      const bool rc_is_crk = nrc == crk;
      const float lp_unif2 = (ind(ne_kc) + ind(nrk != crk)) - (rc_is_crk ? log_rm1 : log_rm2);
      float lp_k;
      if (nm == 1) {
        lp_k = lp_a;
      } else if (cm == 1 && !nxt_dc1) {
        lp_k = lp_b;
      } else if (rc_is_crk && cm == 0) {
        lp_k = ind(nxt_dk1) + lp_unif2;
      } else {
        lp_k = nxt_dk1 ? fk + lp_unif2 : (fk + ind(cdk + 1 == ndk)) + ind(crk == nrk);
      }
      const float trans = (lp_m + lp_c) + lp_k;
      if (isfinite(trans)) {
        const float logit = lw + trans;
        const float noise = -logf(-logf(fmaxf(urow[n], FLT_MIN)));
        v = noise + logit;
      }
    }
    if (first(v, n, best_v, best_n)) best_v = v, best_n = n;
  }

  // ---- 4: the block's argmax ---------------------------------------------
  warp_argmax(best_v, best_n);
  if (lane == 0) {
    s_v[warp] = best_v;
    s_n[warp] = best_n;
  }
  __syncthreads();

  // ---- 5-6: the chosen particle's state; the index --------------------
  if (tid == 0) {
    float v = s_v[0];
    int sel = s_n[0];
    for (int k = 1; k < kWarps; ++k)
      if (first(s_v[k], s_n[k], v, sel)) v = s_v[k], sel = s_n[k];
    const size_t p = row + sel;
    const int st[5] = {a.h_m[p], a.h_dc[p], a.h_rc[p], a.h_dk[p], a.h_rk[p]};
    int* out = a.traj + (((size_t)u * a.T + t) * a.B + b) * 5;
    for (int k = 0; k < 5; ++k) {
      out[k] = st[k];
      nxt[k] = st[k];
    }
    __threadfence();
    const unsigned long long done =
        atomicAdd(reinterpret_cast<unsigned long long*>(a.idx + 1), 1ULL);
    if (done == (unsigned long long)gridDim.x - 1) {  // the last block: every block has read t
      a.idx[0] = t - 1;
      a.idx[1] = 0;
    }
  }
}

size_t smem_bytes(int M, int R) { return sizeof(float) * (3 * (size_t)M + 3 * (size_t)R + 4); }

}  // namespace

extern "C" {

// The size of BackwardStepArgs, which the wrapper holds its struct to.
size_t hygeia_backward_step_args_size() { return sizeof(BackwardStepArgs); }

// Launches on `stream`; returns a CUDA error code (0 when the launch was
// accepted). The caller checks shapes (ops/cuda_backward_step.py); this
// refuses a shape that does not add up and shared memory beyond the
// device's opt-in limit all the same.
int hygeia_backward_step(const BackwardStepArgs* args, void* stream) {
  const BackwardStepArgs& a = *args;
  if (a.U <= 0 || a.B <= 0) return 0;
  if (a.R < 1 || a.M < 1 || a.W < 1 || (long long)a.N != (long long)a.M * (2 * a.R + a.R * a.R) ||
      (long long)a.U * a.B > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(a.M, a.R);
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
      e = cudaFuncGetAttributes(&attr, backward_step_kernel);
      if (e != cudaSuccess) return (int)e;
      most -= (int)attr.sharedSizeBytes;  // the limit counts the static arrays too
      e = cudaFuncSetAttribute(backward_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
      if (e != cudaSuccess) return (int)e;
      opted[dev] = most;
    }
    if (smem > (size_t)opted[dev]) return (int)cudaErrorInvalidValue;
  }
  backward_step_kernel<<<a.U * a.B, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

const char* hygeia_backward_step_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
