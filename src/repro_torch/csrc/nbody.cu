// One Euler step of all-pairs softened gravity for a slice of targets.
//
// Replaces the TPU kernel src/repro/kernels/nbody/kernel.py:38
// accelerations (_nbody_kernel, :22), whose output block accumulates
// across a sequential grid axis of source tiles, together with the Euler
// update that src/repro/kernels/nbody/ops.py:32-34 runs after it.  Plain
// version: repro_torch/kernels/nbody/ref.py step_rows.
//
// Bound on an H100: float32 operations, 20 per target-source pair
// (difference, squared distance, rsqrt, the mass and the cube of the
// inverse distance, and the three accumulations), against 16 bytes read
// per source: thousands of operations per byte at the paper's 229,376
// bodies.  What limits it is instruction issue and the SFU (MUFU) pipe,
// which does 16 rsqrts a clock per SM.
//
// Design:
// - No division: s = m * inv * inv^2 with inv = rsqrt.approx(r2), so a
//   pair is one MUFU and 12 float instructions (3 differences, 3 FMAs for
//   r2 with eps2 folded into the first, 3 multiplies for s, 3 FMAs into
//   the sums).  r2 >= eps2 > 0, so the flush-to-zero form is exact here.
// - kPerLane targets per thread: each broadcast shared-memory read of a
//   source feeds kPerLane independent chains.  A CTA holds kTargets =
//   32 * kPerLane targets; target r*32 + lane of the CTA is the lane's r-th.
// - The sources are cut into kWarps slices, one per warp of the CTA, so a
//   CTA of kWarps warps covers its targets' sources kWarps ways at once and
//   even a few hundred targets give the card several warps.  The slices'
//   sums meet in shared memory and are added in warp order: the result does
//   not depend on timing.
// - Each warp streams its slice through its own kStages-deep ring of
//   kTile-source tiles with cp.async (zero-filled past N: a zero mass adds
//   an exact zero) and waits only for its own copies, behind __syncwarp():
//   no CTA barrier until the slices meet.
// - Two-level sum per slice: a tile's terms into a partial, the partial
//   into the slice's total.
// Then the CTA applies the Euler step and writes its [x, y, z, m, vx, vy,
// vz] rows through shared memory in coalesced stores.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float rsqrt_approx(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// kWarps: source slices (warps) per CTA; kPerLane: targets per thread;
// kTile: sources per tile; kStages: tiles in flight per warp; kMinBlocks:
// the CTAs an SM must hold, which caps the registers a thread.
template <int kWarps, int kPerLane, int kTile, int kStages, int kMinBlocks>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
nbody_kernel(const float4* __restrict__ pos_mass,
             const float* __restrict__ vel, float* __restrict__ out, int n,
             int tgt0, int n_tgt, float eps2, float dt) {
  constexpr int kThreads = kWarps * 32;
  constexpr int kTargets = 32 * kPerLane;  // targets per CTA
  static_assert(kThreads >= kTargets, "a thread sums one target's slices");
  static_assert(kTile % 32 == 0, "a lane copies every 32nd source");
  __shared__ float4 ring[kWarps][kStages][kTile];
  __shared__ float part[kWarps][3][kTargets];
  __shared__ float rows[kTargets * 7];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int base = blockIdx.x * kTargets;  // first target, from tgt0

  float mx[kPerLane], my[kPerLane], mz[kPerLane];
#pragma unroll
  for (int r = 0; r < kPerLane; ++r) {
    const int t = base + r * 32 + lane;
    const float4 me =
        t < n_tgt ? pos_mass[tgt0 + t] : make_float4(0, 0, 0, 0);
    mx[r] = me.x;
    my[r] = me.y;
    mz[r] = me.z;
  }

  // this warp's slice: tiles [first, first + count) of the source range
  const int n_tiles = (n + kTile - 1) / kTile;
  const int per = (n_tiles + kWarps - 1) / kWarps;
  const int first = warp * per;
  const int count = max(0, min(per, n_tiles - first));
  float4(*slots)[kTile] = ring[warp];
  // every call commits one group, so group i holds tile i of the slice
  auto load = [&](int i) {
    if (i < count) {
#pragma unroll
      for (int c = 0; c < kTile / 32; ++c) {
        const int s = (first + i) * kTile + c * 32 + lane;
        cp_async16(&slots[i % kStages][c * 32 + lane],
                   pos_mass + (s < n ? s : 0), s < n);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) load(i);

  float ax[kPerLane] = {}, ay[kPerLane] = {}, az[kPerLane] = {};
  for (int i = 0; i < count; ++i) {
    load(i + kStages - 1);  // into the slot read in iteration i - 1
    cp_async_wait<kStages - 1>();
    __syncwarp();  // every lane's copies of tile i are visible
    const float4* tile = slots[i % kStages];
    float tx[kPerLane] = {}, ty[kPerLane] = {}, tz[kPerLane] = {};
#pragma unroll 8
    for (int k = 0; k < kTile; ++k) {
      const float4 src = tile[k];
#pragma unroll
      for (int r = 0; r < kPerLane; ++r) {
        const float dx = src.x - mx[r];
        const float dy = src.y - my[r];
        const float dz = src.z - mz[r];
        const float r2 = fmaf(dx, dx, fmaf(dy, dy, fmaf(dz, dz, eps2)));
        const float inv = rsqrt_approx(r2);
        const float s = (src.w * inv) * (inv * inv);
        tx[r] = fmaf(dx, s, tx[r]);
        ty[r] = fmaf(dy, s, ty[r]);
        tz[r] = fmaf(dz, s, tz[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kPerLane; ++r) {
      ax[r] += tx[r];
      ay[r] += ty[r];
      az[r] += tz[r];
    }
    __syncwarp();  // every lane is done with the slot before its refill
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < kPerLane; ++r) {
    part[warp][0][r * 32 + lane] = ax[r];
    part[warp][1][r * 32 + lane] = ay[r];
    part[warp][2][r * 32 + lane] = az[r];
  }
  __syncthreads();
  const int live = min(kTargets, n_tgt - base);
  if (threadIdx.x < live) {
    const int j = threadIdx.x;
    float acc[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      acc[c] = part[0][c][j];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) acc[c] += part[w][c][j];
    }
    const int t = tgt0 + base + j;
    const float4 me = pos_mass[t];
    const float* v0 = vel + static_cast<size_t>(t) * 3;
    const float vx = v0[0] + acc[0] * dt;
    const float vy = v0[1] + acc[1] * dt;
    const float vz = v0[2] + acc[2] * dt;
    float* o = rows + j * 7;
    o[0] = me.x + vx * dt;
    o[1] = me.y + vy * dt;
    o[2] = me.z + vz * dt;
    o[3] = me.w;
    o[4] = vx;
    o[5] = vy;
    o[6] = vz;
  }
  __syncthreads();
  float* dst = out + static_cast<size_t>(base) * 7;
  for (int i = threadIdx.x; i < live * 7; i += kThreads) dst[i] = rows[i];
}

// One launch of the kernel of that shape over targets [tgt0, tgt0+n_tgt).
template <int kWarps, int kPerLane, int kTile, int kStages, int kMinBlocks>
cudaError_t launch(const float* pos_mass, const float* vel, float* out,
                   int n, int tgt0, int n_tgt, float eps2, float dt,
                   cudaStream_t stream) {
  if (n_tgt > 0) {
    const int grid = (n_tgt + 32 * kPerLane - 1) / (32 * kPerLane);
    nbody_kernel<kWarps, kPerLane, kTile, kStages, kMinBlocks>
        <<<grid, kWarps * 32, 0, stream>>>(
            reinterpret_cast<const float4*>(pos_mass), vel, out, n, tgt0,
            n_tgt, eps2, dt);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int nbody_step(const float* pos_mass, const float* vel, float* out,
                          int n, int tgt0, int n_tgt, float eps2, float dt,
                          void* stream) {
  if (tgt0 < 0 || tgt0 + n_tgt > n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // 8 slices of 4 targets a thread, two 128-source tiles in flight, three
  // CTAs an SM (kernel_variants.py times other shapes)
  return static_cast<int>(launch<8, 4, 128, 2, 3>(
      pos_mass, vel, out, n, tgt0, n_tgt, eps2, dt,
      static_cast<cudaStream_t>(stream)));
}
