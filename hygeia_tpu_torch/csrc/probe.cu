// 2*x + max(x) over one small f32 tensor in a single thread block.
//
// Replaces the TPU kernel .round4/pallas_smoke.py::f (body `kernel`): a
// check that the toolchain compiles and launches a kernel, on one (8, 128)
// f32 block held in VMEM. Here the block's threads first reduce the maximum
// (each thread over a strided run of elements, then warp shuffles, then the
// warps' maxima in shared memory), then write 2*x + max elementwise.
//
// 2*x is exact in f32, so 2*x + m rounds once, as PyTorch's `2 * x + x.max()`
// does (an FMA would round the same exact sum once): the two agree bit for
// bit. A NaN anywhere makes the maximum NaN, as torch.max does.
//
// Bound on an H100: the launch. 8 KiB in and 8 KiB out are ~5 ns at the
// card's memory rate.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}

__global__ void __launch_bounds__(kThreads) probe_kernel(const float* __restrict__ x,
                                                          float* __restrict__ out, int n) {
  __shared__ float warp_max[kThreads / 32];
  float m = -INFINITY;
  for (int i = threadIdx.x; i < n; i += kThreads) m = max_nan(m, x[i]);
  for (int off = 16; off > 0; off >>= 1) m = max_nan(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  m = warp_max[0];
  for (int w = 1; w < kThreads / 32; ++w) m = max_nan(m, warp_max[w]);
  for (int i = threadIdx.x; i < n; i += kThreads) out[i] = __fadd_rn(2.0f * x[i], m);
}

}  // namespace

extern "C" {

// Launches on `stream`; returns a CUDA error code (0 when the launch was
// accepted). n >= 1 elements of x and out, contiguous f32 on the device.
int hygeia_probe(const float* x, float* out, int n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  probe_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(x, out, n);
  return (int)cudaGetLastError();
}

const char* hygeia_probe_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
