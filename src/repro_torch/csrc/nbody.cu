// One Euler step of all-pairs softened gravity for a slice of targets.
//
// Replaces the TPU kernel src/repro/kernels/nbody/kernel.py:38
// accelerations (_nbody_kernel, :22), whose output block accumulates
// across a sequential grid axis of source tiles, together with the Euler
// update that src/repro/kernels/nbody/ops.py:32-34 runs after it.  Plain
// version: repro_torch/kernels/nbody/ref.py step_rows.
//
// Bound on an H100: float32 operations, 20 per target-source pair
// (difference, squared distance, rsqrt, division, mass and the three
// accumulations), against 16 bytes read per source: thousands of
// operations per byte at the paper's 229,376 bodies.
//
// Design: one thread per target, kBlock targets per CTA.  Sources stream
// through shared memory in kBlock-body float4 tiles, read by every thread
// of the CTA as a broadcast.  Each thread sums its target's acceleration
// in registers, tile by tile: a tile's kBlock terms into a partial sum,
// then the partial into the total, so a float32 sum over N sources rounds
// along about N/kBlock + kBlock additions instead of N.  Then it applies
// the Euler step and writes its [x, y, z, m, vx, vy, vz] row.  The interaction keeps
// the rsqrt(r2) / r2 * m form of the plain version.
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;

__global__ void __launch_bounds__(kBlock)
nbody_kernel(const float4* __restrict__ pos_mass,
             const float* __restrict__ vel, float* __restrict__ out, int n,
             int tgt0, int n_tgt, float eps2, float dt) {
  __shared__ float4 tile[kBlock];
  const int t = blockIdx.x * kBlock + threadIdx.x;
  const bool live = t < n_tgt;
  const float4 me = live ? pos_mass[tgt0 + t] : make_float4(0, 0, 0, 0);
  float ax = 0.0f, ay = 0.0f, az = 0.0f;
  for (int base = 0; base < n; base += kBlock) {
    const int s = base + threadIdx.x;
    tile[threadIdx.x] = s < n ? pos_mass[s] : make_float4(0, 0, 0, 0);
    __syncthreads();
    const int m = min(kBlock, n - base);
    float tx = 0.0f, ty = 0.0f, tz = 0.0f;
    for (int k = 0; k < m; ++k) {
      const float4 src = tile[k];
      const float dx = src.x - me.x;
      const float dy = src.y - me.y;
      const float dz = src.z - me.z;
      const float r2 = dx * dx + dy * dy + dz * dz + eps2;
      const float inv = rsqrtf(r2) / r2 * src.w;
      tx += dx * inv;
      ty += dy * inv;
      tz += dz * inv;
    }
    ax += tx;
    ay += ty;
    az += tz;
    __syncthreads();
  }
  if (live) {
    const float* v0 = vel + static_cast<size_t>(tgt0 + t) * 3;
    const float vx = v0[0] + ax * dt;
    const float vy = v0[1] + ay * dt;
    const float vz = v0[2] + az * dt;
    float* o = out + static_cast<size_t>(t) * 7;
    o[0] = me.x + vx * dt;
    o[1] = me.y + vy * dt;
    o[2] = me.z + vz * dt;
    o[3] = me.w;
    o[4] = vx;
    o[5] = vy;
    o[6] = vz;
  }
}

}  // namespace

extern "C" int nbody_step(const float* pos_mass, const float* vel, float* out,
                          int n, int tgt0, int n_tgt, float eps2, float dt,
                          void* stream) {
  if (tgt0 < 0 || tgt0 + n_tgt > n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_tgt > 0) {
    const int grid = (n_tgt + kBlock - 1) / kBlock;
    nbody_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(pos_mass), vel, out, n, tgt0, n_tgt,
        eps2, dt);
  }
  return static_cast<int>(cudaGetLastError());
}
