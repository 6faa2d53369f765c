// Selective scan: the Mamba1 recurrence over a whole sequence.
//
//   h_t = a_t * h_{t-1} + b_t ;  y_t[d] = sum_s h_t[d, s] * C_t[s]
//
// Replaces the TPU kernel src/repro/kernels/mamba_scan/kernel.py:55
// selective_scan (_scan_kernel, :24): grid (batch, d_inner tile, seq
// chunk) with the state carried in VMEM scratch across the sequential
// chunk axis.  Plain version: repro_torch/kernels/mamba_scan/ref.py
// selective_scan.
//
// Bound on an H100: bytes.  a and b are (B, S, di, ds) float32 and read
// once; each element costs a multiply-add, a multiply and a share of the
// ds-lane sum, about half an operation per byte.  At the serving prefill
// (B 4, S 256, di 8192, ds 16) that is 1.07 GB read and 34 MB written per
// launch: 0.33 ms at 3.35 TB/s.
//
// Design: parallel over (batch, channel d, state s), sequential over time
// inside the thread, with no chunk boundary: a channel's ds states live
// in the registers of ds neighbouring lanes (a group of L lanes, L the
// power of two >= ds; lanes past ds hold zeros) from t = 0 to S-1.  For a
// fixed (b, t) the (di, ds) plane is contiguous, so a warp reads 32/L
// whole channels, 128 contiguous bytes of a and of b, per step.  Each
// thread loads kUnroll steps of a, b and C before it uses them, so every
// warp keeps 3 * kUnroll loads in flight.  y_t is summed over the group
// with __shfl_xor_sync and written by the group's first lane; C_t goes
// through the read-only cache (every group of a CTA reads the same row).
// h0 (zeros when null) seeds the state and h_T is written at the end.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;

template <int L>
__global__ void __launch_bounds__(kThreads)
selective_scan_kernel(const float* __restrict__ a,
                      const float* __restrict__ b,
                      const float* __restrict__ C,
                      const float* __restrict__ h0, float* __restrict__ y,
                      float* __restrict__ hT, int S, int di, int ds) {
  constexpr int kChannels = kThreads / L;
  const int s = threadIdx.x % L;
  const int d = blockIdx.x * kChannels + threadIdx.x / L;
  const long long bi = blockIdx.y;
  // whole groups are in or out of range, so every lane of a warp takes
  // part in the shuffles; out-of-range lanes load nothing and store nothing
  const bool chan = d < di;
  const bool live = chan && s < ds;
  const long long plane = static_cast<long long>(di) * ds;
  const long long cell = static_cast<long long>(d) * ds + s;
  const float* pa = a + bi * S * plane + cell;
  const float* pb = b + bi * S * plane + cell;
  const float* pc = C + bi * S * ds + s;
  float* py = y + bi * S * di + d;
  float h = (live && h0 != nullptr) ? h0[bi * plane + cell] : 0.0f;

  int t = 0;
  for (; t + kUnroll <= S; t += kUnroll) {
    float av[kUnroll], bv[kUnroll], cv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      av[u] = live ? __ldg(pa + u * plane) : 0.0f;
      bv[u] = live ? __ldg(pb + u * plane) : 0.0f;
      cv[u] = s < ds ? __ldg(pc + u * ds) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      h = fmaf(av[u], h, bv[u]);
      float p = h * cv[u];
#pragma unroll
      for (int o = L / 2; o > 0; o >>= 1) {
        p += __shfl_xor_sync(0xffffffffu, p, o);
      }
      if (chan && s == 0) py[static_cast<long long>(u) * di] = p;
    }
    pa += kUnroll * plane;
    pb += kUnroll * plane;
    pc += kUnroll * ds;
    py += static_cast<long long>(kUnroll) * di;
  }
  for (; t < S; ++t) {
    const float at = live ? __ldg(pa) : 0.0f;
    const float bt = live ? __ldg(pb) : 0.0f;
    const float ct = s < ds ? __ldg(pc) : 0.0f;
    h = fmaf(at, h, bt);
    float p = h * ct;
#pragma unroll
    for (int o = L / 2; o > 0; o >>= 1) {
      p += __shfl_xor_sync(0xffffffffu, p, o);
    }
    if (chan && s == 0) *py = p;
    pa += plane;
    pb += plane;
    pc += ds;
    py += di;
  }
  if (live) hT[bi * plane + cell] = h;
}

template <int L>
cudaError_t launch_scan(const float* a, const float* b, const float* C,
                        const float* h0, float* y, float* hT, int B, int S,
                        int di, int ds, cudaStream_t st) {
  constexpr int kChannels = kThreads / L;
  const dim3 grid((di + kChannels - 1) / kChannels, B);
  selective_scan_kernel<L><<<grid, kThreads, 0, st>>>(a, b, C, h0, y, hT, S,
                                                      di, ds);
  return cudaGetLastError();
}

}  // namespace

// a, b: (B, S, di, ds); C: (B, S, ds); h0: (B, di, ds) or null; y: (B, S,
// di); hT: (B, di, ds); all float32 and contiguous.  1 <= ds <= 32.
extern "C" int selective_scan_fwd(const float* a, const float* b,
                                  const float* C, const float* h0, float* y,
                                  float* hT, int B, int S, int di, int ds,
                                  void* stream) {
  if (B < 0 || B > 65535 || S < 0 || di < 0 || ds < 1 || ds > 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || di == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (ds <= 1) {
    err = launch_scan<1>(a, b, C, h0, y, hT, B, S, di, ds, st);
  } else if (ds <= 2) {
    err = launch_scan<2>(a, b, C, h0, y, hT, B, S, di, ds, st);
  } else if (ds <= 4) {
    err = launch_scan<4>(a, b, C, h0, y, hT, B, S, di, ds, st);
  } else if (ds <= 8) {
    err = launch_scan<8>(a, b, C, h0, y, hT, B, S, di, ds, st);
  } else if (ds <= 16) {
    err = launch_scan<16>(a, b, C, h0, y, hT, B, S, di, ds, st);
  } else {
    err = launch_scan<32>(a, b, C, h0, y, hT, B, S, di, ds, st);
  }
  return static_cast<int>(err);
}
