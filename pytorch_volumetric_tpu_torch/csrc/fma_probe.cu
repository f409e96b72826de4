// FP32 fused multiply-add ceiling probe (Hopper).
//
// Replaces the TPU kernel benchmarks/pallas_mfu.py :: fma_kernel (launched
// by fma_run there): every element runs 8 independent chains
// acc_j = acc_j * a + b, 32 multiply-adds per loop iteration, for a runtime
// number of iterations, and stores the sum of the chains so that nothing is
// eliminated.  Its rate is the FP32 ceiling the closest-point sweep's
// roofline is measured against (2 operations per multiply-add).
//
// What bounds it: FP32 operations only, by design.  Each thread reads two
// floats and writes one; everything else stays in registers.
//
// Design: one element per thread, 256 threads per block, at most 32
// registers per thread (__launch_bounds__ min blocks 8) so that 2,048
// threads fit on every SM; the caller sizes the grid to fill all SMs.  The
// 8 chains are independent, so each warp scheduler always has an FMA ready
// despite the 4-cycle dependent-issue latency.  The library is built with
// -fmad=false like every kernel of the package, so the multiply-adds are
// written as __fmaf_rn: under -fmad=false `acc * a + b` would compile to a
// multiply and an add and halve the rate.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChains = 8;
constexpr int kRounds = 4;  // kChains * kRounds = 32 multiply-adds per iteration

__global__ void __launch_bounds__(kThreads, 8)
fma_probe_kernel(const float* __restrict__ x, const float* __restrict__ y,
                 float* __restrict__ out, int n, int iters) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float a = x[i];
  const float b = y[i];
  float acc[kChains];
#pragma unroll
  for (int j = 0; j < kChains; ++j) acc[j] = a * static_cast<float>(0.1 * (j + 1));
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
#pragma unroll
      for (int j = 0; j < kChains; ++j) acc[j] = __fmaf_rn(acc[j], a, b);
    }
  }
  float s = acc[0];
#pragma unroll
  for (int j = 1; j < kChains; ++j) s = s + acc[j];
  out[i] = s;
}

}  // namespace

// C interface, loaded with ctypes.  x, y, out [n] float32 contiguous on the
// device.  Launches on `stream` and returns the cudaGetLastError() code of
// the launch (0 on success).
extern "C" int pvt_fma_probe(const float* x, const float* y, float* out, int n,
                             int iters, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  fma_probe_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, out, n, iters);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pvt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
