// European call prices by backward induction on a recombining binomial tree.
//
// Replaces the TPU kernel src/repro/kernels/binomial/kernel.py:42
// price_options (_binomial_kernel, :19), which holds a (tile, steps+1) value
// plane per option tile in VMEM.  Plain version: repro_torch/kernels/
// binomial/ref.py price_options, whose formulas this kernel repeats.
//
// Bound on an H100: float32 operations.  Each option does 4 operations per
// tree node and step, steps*(steps+1)/2 node-steps (32,385 at 254 steps),
// and reads and writes 16 bytes: 8,096 operations per byte.
//
// Design: the paper's OpenCL mapping, one CTA per option.  The 255 leaf
// values sit in shared memory; each induction step is one pass of the
// first steps-i threads over a ping-pong pair of rows, with one
// __syncthreads() between steps.  Threads past the shrinking front idle,
// so half the lanes do no work on average: the simple mapping, kept for
// this first port.  IEEE expf/sqrtf and divisions (no --use_fast_math).
#include <cuda_runtime.h>

namespace {

constexpr float kRiskFree = 0.02f;
constexpr float kVolatility = 0.30f;
constexpr int kThreads = 256;  // one leaf per thread: steps <= 255

__global__ void __launch_bounds__(kThreads)
binomial_kernel(const float* __restrict__ s0, const float* __restrict__ strike,
                const float* __restrict__ t_years, float* __restrict__ out,
                int steps) {
  __shared__ float v[2][kThreads];
  const int opt = blockIdx.x;
  const int j = threadIdx.x;
  const float dt = t_years[opt] / static_cast<float>(steps);
  const float vdt = kVolatility * sqrtf(dt);
  const float u = expf(vdt);
  const float d = 1.0f / u;
  const float a = expf(kRiskFree * dt);
  const float pu = (a - d) / (u - d);
  const float pd = 1.0f - pu;
  const float disc = expf(-kRiskFree * dt);
  if (j <= steps) {
    const float e = 2.0f * static_cast<float>(j) - static_cast<float>(steps);
    const float s_t = s0[opt] * expf(vdt * e);
    v[0][j] = fmaxf(s_t - strike[opt], 0.0f);
  }
  __syncthreads();
  int cur = 0;
  for (int i = 0; i < steps; ++i) {
    if (j < steps - i) {
      v[cur ^ 1][j] = disc * (pd * v[cur][j] + pu * v[cur][j + 1]);
    }
    cur ^= 1;
    __syncthreads();
  }
  if (j == 0) out[opt] = v[cur][0];
}

}  // namespace

extern "C" int binomial_price(const float* s0, const float* strike,
                              const float* t_years, float* out, int n,
                              int steps, void* stream) {
  if (steps < 1 || steps >= kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    binomial_kernel<<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        s0, strike, t_years, out, steps);
  }
  return static_cast<int>(cudaGetLastError());
}
