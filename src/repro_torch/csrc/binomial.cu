// European call prices by backward induction on a recombining binomial tree.
//
// Replaces the TPU kernel src/repro/kernels/binomial/kernel.py:42
// price_options (_binomial_kernel, :19), which holds a (tile, steps+1) value
// plane per option tile in VMEM.  Plain version: repro_torch/kernels/
// binomial/ref.py price_options, whose prologue and leaves this kernel
// repeats.
//
// Bound on an H100: float32 operations.  Each option has steps*(steps+1)/2
// node-steps (32,385 at 254 steps) and reads and writes 16 bytes:
// thousands of operations per byte.  No form of the induction does less
// than one fused multiply-add (2 operations) a node-step, so the least
// time is that of the CUDA cores issuing only FMAs, every lane on a live
// node.
//
// Design: one warp per option, the lattice in registers.  Lane l holds the
// W consecutive nodes [l*W, (l+1)*W) (W = 8 at the leaves: 256 >= 255).
// disc is folded into the coefficients once per option (pu' = disc*pu,
// pd' = disc*pd), and K = kFuse steps are taken in one pass: after K steps
// v[j] = sum_i C(K,i) pd'^(K-i) pu'^i v[j+i], one multiply and K fused
// multiply-adds a node, with K shuffles that bring the nodes to the
// lane's right: no shared memory and no block barrier in a step.  One step
// at a time would take a multiply and an FMA a node-step; K = 8 takes
// 1.125 instructions, and rounds 9 times in 8 steps where the plain
// version's disc*(pd*v[j] + pu*v[j+1]) rounds 32 times.  Each time the
// live front fits in one node fewer per lane (at fronts of 224, 192, ...,
// 32 nodes) the warp re-packs it from W to W-1 nodes a lane through its
// own row of shared memory, behind __syncwarp(), so it stops issuing for
// most of the dead part of the triangle: at 254 steps a warp computes
// 36,800 node-steps for the 32,385 live ones (65,024 at a fixed width of
// 8).  The phases' step counts are compile-time for the main path's 254
// steps (repro_torch/kernels/binomial/ref.py STEPS) and run-time for every
// other count.  Each warp ends on its own, kWarps options a CTA.  IEEE
// expf/sqrtf and divisions in the prologue (no --use_fast_math): 255 expf
// per option.
#include <cuda_runtime.h>

namespace {

constexpr float kRiskFree = 0.02f;
constexpr float kVolatility = 0.30f;
constexpr int kWarps = 4;        // options per CTA, one warp each
constexpr int kMaxSteps = 255;   // 32 lanes x 8 nodes >= steps + 1
constexpr int kMainSteps = 254;  // the main path's, compile-time
constexpr int kFuse = 8;         // steps a pass over the lattice takes
constexpr unsigned kAll = 0xffffffffu;

// The coefficients of K steps at once: c[i] = C(K,i) pd^(K-i) pu^i, the
// coefficients of (pd + pu x)^K by Pascal's rule.
template <int K>
__device__ __forceinline__ void coefficients(float (&c)[K + 1], float pu,
                                             float pd) {
  c[0] = 1.0f;
#pragma unroll
  for (int k = 1; k <= K; ++k) {
    c[k] = pu * c[k - 1];
#pragma unroll
    for (int i = k - 1; i > 0; --i) c[i] = fmaf(pd, c[i], pu * c[i - 1]);
    c[0] = pd * c[0];
  }
}

// K induction steps on a front of W nodes per lane.  Node k reads nodes
// k..k+K, those past the lane's own from the lanes to its right (lane 31
// reads its own, past every live front).  Ascending k reads v[k + i]
// before it is overwritten; nodes past the live front compute values that
// never flow back into it (node j reads only j..j+K).
template <int W, int K>
__device__ __forceinline__ void step(float (&v)[8], const float (&c)[K + 1]) {
  float r[K];  // nodes l*W + W + i
#pragma unroll
  for (int i = 0; i < K; ++i) {
    r[i] = __shfl_down_sync(kAll, v[(W + i) % W], (W + i) / W);
  }
  auto node = [&](int j) { return j < W ? v[j] : r[j - W]; };
#pragma unroll
  for (int k = 0; k < W; ++k) {
    float acc = c[K] * node(k + K);
#pragma unroll
    for (int i = K - 1; i >= 0; --i) acc = fmaf(c[i], node(k + i), acc);
    v[k] = acc;
  }
}

// Re-pack the front from W to W-1 nodes per lane through the warp's row
// of shared memory (node j at row[j]); the caller has shrunk the front to
// at most 32*(W-1) nodes.
template <int W>
__device__ __forceinline__ void shrink(float (&v)[8], float* row, int lane) {
#pragma unroll
  for (int k = 0; k < W; ++k) row[lane * W + k] = v[k];
  __syncwarp();
#pragma unroll
  for (int k = 0; k < W - 1; ++k) v[k] = row[lane * (W - 1) + k];
  __syncwarp();  // every lane has read the row before it is written again
}

// Passes of K steps at width W until the front f fits in W-1 nodes a lane,
// then a re-pack to W-1, and so on down to width 1.  The last pass at a
// width may leave the front up to K-1 nodes short of 32*(W-1), never past
// the last step (32*(W-1) >= K).  At width 1: passes, then single steps,
// until one node is left.  The counts are constants when kSteps is.
template <int W, int K>
__device__ __forceinline__ void phases(float (&v)[8], float* row, int lane,
                                       int f, const float (&c)[K + 1],
                                       const float (&c1)[2]) {
  constexpr int kKeep = 32 * (W - 1);
  if constexpr (W > 1) {
    const int count = f > kKeep ? (f - kKeep + K - 1) / K : 0;
#pragma unroll 8
    for (int i = 0; i < count; ++i) step<W, K>(v, c);
    shrink<W>(v, row, lane);
    phases<W - 1, K>(v, row, lane, f - count * K, c, c1);
  } else {
    const int count = (f - 1) / K;
#pragma unroll 8
    for (int i = 0; i < count; ++i) step<1, K>(v, c);
    for (int i = count * K; i < f - 1; ++i) step<1, 1>(v, c1);
  }
}

// kSteps > 0: the step count is that constant; 0: it is `steps`.  K steps
// a pass over the lattice.
template <int kSteps, int K>
__global__ void __launch_bounds__(kWarps * 32)
binomial_kernel(const float* __restrict__ s0, const float* __restrict__ strike,
                const float* __restrict__ t_years, float* __restrict__ out,
                int n, int steps) {
  __shared__ float rows[kWarps][32 * 8];
  const int lane = threadIdx.x & 31;
  const int opt = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (opt >= n) return;  // the whole warp: opt is uniform in it
  const int nsteps = kSteps > 0 ? kSteps : steps;
  const float dt = t_years[opt] / static_cast<float>(nsteps);
  const float vdt = kVolatility * sqrtf(dt);
  const float u = expf(vdt);
  const float d = 1.0f / u;
  const float a = expf(kRiskFree * dt);
  const float p = (a - d) / (u - d);
  const float disc = expf(-kRiskFree * dt);
  const float pu = disc * p;
  const float pd = disc * (1.0f - p);
  float c[K + 1], c1[2];
  coefficients<K>(c, pu, pd);
  coefficients<1>(c1, pu, pd);
  const float spot = s0[opt];
  const float k0 = strike[opt];
  float v[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int j = lane * 8 + k;
    const float e = 2.0f * static_cast<float>(j) - static_cast<float>(nsteps);
    v[k] = j <= nsteps ? fmaxf(spot * expf(vdt * e) - k0, 0.0f) : 0.0f;
  }
  // the front starts at nsteps + 1 live nodes; each step leaves one fewer
  phases<8, K>(v, rows[threadIdx.x >> 5], lane, nsteps + 1, c, c1);
  if (lane == 0) out[opt] = v[0];
}

// One launch of binomial_kernel<kSteps, K> over n options.
template <int kSteps, int K>
cudaError_t launch(const float* s0, const float* strike, const float* t_years,
                   float* out, int n, int steps, cudaStream_t stream) {
  if (n > 0) {
    binomial_kernel<kSteps, K><<<(n + kWarps - 1) / kWarps, kWarps * 32, 0,
                                 stream>>>(s0, strike, t_years, out, n, steps);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int binomial_price(const float* s0, const float* strike,
                              const float* t_years, float* out, int n,
                              int steps, void* stream) {
  if (steps < 1 || steps > kMaxSteps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the compile-time build of the main path's count issues no loop
  // control (kernel_variants.py times it against the run-time build)
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      steps == kMainSteps
          ? launch<kMainSteps, kFuse>(s0, strike, t_years, out, n, steps, s)
          : launch<0, kFuse>(s0, strike, t_years, out, n, steps, s));
}
