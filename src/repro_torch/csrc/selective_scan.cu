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
// When asked (``states`` not null), the forward also writes the state that
// enters each chunk of kChunk steps, (B, ceil(S / kChunk), di, ds): 1/16 of
// a's bytes, which the backward restarts from.
//
// Backward (selective_scan_bwd): the scan's gradient, which the JAX package
// takes by differentiating its jnp scan (src/repro/models/layers.py:559
// _ssm_scan_chunked) with jax.value_and_grad.  Plain version:
// repro_torch/kernels/mamba_scan/ref.py selective_scan_bwd_ref.
//
//   g_t = dy_t[d] C_t[s] + a_{t+1} g_{t+1}   (g_{S-1} also takes dhT)
//   da_t = g_t h_{t-1} ;  db_t = g_t ;  dC_t[s] = sum_d dy_t[d] h_t[d, s]
//   dh0 = a_0 g_0
//
// Bound on an H100: bytes.  a and b are read and da and db written once,
// four (B, S, di, ds) float32 planes, beside dy, C and the kept states: at
// the training packet (B 1, S 4096, di 8192, ds 16) about 8.7 GB, 2.6 ms at
// 3.35 TB/s.
//
// Design: the forward's layout (one lane per (channel, state), L lanes a
// channel, the state in a register).  Each thread walks its chunks from
// the last to the first; for a chunk it loads the kChunk steps of a, b, C
// and dy into registers at once (a and b are read exactly once), recomputes
// the chunk's states from the kept boundary state with the forward's own
// fmaf (so they are the forward's values bit for bit), then runs the
// reverse recurrence, writing da and db, and carries a_t g_t into the
// chunk before.  dC sums over all di channels, which span CTAs: without
// atomics, each CTA sums its channels in a fixed order (shuffles across a
// warp's channel groups, then its warps through shared memory) into a
// partial row (B, CTAs, S, ds), and a second kernel sums the CTAs'
// partials in index order.  Two calls give bitwise-equal gradients.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;
constexpr int kChunk = 16;   // steps between kept states; a multiple of kUnroll
static_assert(kChunk % kUnroll == 0, "a chunk is whole unrolled steps");

template <int L>
__global__ void __launch_bounds__(kThreads)
selective_scan_kernel(const float* __restrict__ a,
                      const float* __restrict__ b,
                      const float* __restrict__ C,
                      const float* __restrict__ h0, float* __restrict__ y,
                      float* __restrict__ hT, float* __restrict__ states,
                      int S, int di, int ds) {
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
  const int n_chunks = (S + kChunk - 1) / kChunk;
  float* pst = states == nullptr ? nullptr
                                 : states + bi * n_chunks * plane + cell;

  int t = 0;
  for (; t + kUnroll <= S; t += kUnroll) {
    if (pst != nullptr && live && t % kChunk == 0) {
      pst[static_cast<long long>(t / kChunk) * plane] = h;
    }
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
    if (pst != nullptr && live && t % kChunk == 0) {
      pst[static_cast<long long>(t / kChunk) * plane] = h;
    }
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
                        const float* h0, float* y, float* hT, float* states,
                        int B, int S, int di, int ds, cudaStream_t st) {
  constexpr int kChannels = kThreads / L;
  const dim3 grid((di + kChannels - 1) / kChannels, B);
  selective_scan_kernel<L><<<grid, kThreads, 0, st>>>(a, b, C, h0, y, hT,
                                                      states, S, di, ds);
  return cudaGetLastError();
}

template <int L>
__global__ void __launch_bounds__(kThreads)
selective_scan_bwd_kernel(const float* __restrict__ a,
                          const float* __restrict__ b,
                          const float* __restrict__ C,
                          const float* __restrict__ states,
                          const float* __restrict__ dy,
                          const float* __restrict__ dhT,
                          float* __restrict__ da, float* __restrict__ db,
                          float* __restrict__ dc_part,
                          float* __restrict__ dh0, int S, int di, int ds) {
  constexpr int kChannels = kThreads / L;
  constexpr int kWarps = kThreads / 32;
  // each warp's dC partial of a chunk: its channels summed, by (step, state)
  __shared__ float red[kWarps][kChunk][L];
  const int s = threadIdx.x % L;
  const int d = blockIdx.x * kChannels + threadIdx.x / L;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long bi = blockIdx.y;
  // whole groups are in or out of range: every lane takes part in the
  // shuffles and barriers, out-of-range lanes load and store nothing
  const bool chan = d < di;
  const bool live = chan && s < ds;
  const long long plane = static_cast<long long>(di) * ds;
  const long long cell = static_cast<long long>(d) * ds + s;
  const int n_chunks = (S + kChunk - 1) / kChunk;
  const float* pst = states + bi * n_chunks * plane + cell;
  float* part = dc_part + (bi * gridDim.x + blockIdx.x) * S * ds;
  // a_{t+1} g_{t+1}, carried into step t
  float carry = (live && dhT != nullptr) ? dhT[bi * plane + cell] : 0.0f;

  for (int k = n_chunks - 1; k >= 0; --k) {
    const int t0 = k * kChunk;
    const int n = min(kChunk, S - t0);
    const long long row = bi * S + t0;       // (b, t0) of the (B, S) rows
    const float* pa = a + row * plane + cell;
    const float* pb = b + row * plane + cell;
    float av[kChunk], bv[kChunk], cv[kChunk], gv[kChunk], hv[kChunk + 1];
    hv[0] = live ? pst[static_cast<long long>(k) * plane] : 0.0f;
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const bool in = u < n;
      av[u] = (live && in) ? __ldg(pa + u * plane) : 0.0f;
      bv[u] = (live && in) ? __ldg(pb + u * plane) : 0.0f;
      cv[u] = (s < ds && in) ? __ldg(C + (row + u) * ds + s) : 0.0f;
      gv[u] = (chan && in) ? __ldg(dy + (row + u) * di + d) : 0.0f;
    }
    // the chunk's states, as the forward computed them
#pragma unroll
    for (int u = 0; u < kChunk; ++u) hv[u + 1] = fmaf(av[u], hv[u], bv[u]);
    // dC: this CTA's channels summed for each (step, state) of the chunk
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      float p = gv[u] * hv[u + 1];
#pragma unroll
      for (int o = L; o < 32; o <<= 1) {
        p += __shfl_xor_sync(0xffffffffu, p, o);
      }
      if (lane < L) red[warp][u][lane] = p;
    }
    // the reverse recurrence; steps past S (u >= n) are skipped
    float* pda = da + row * plane + cell;
    float* pdb = db + row * plane + cell;
#pragma unroll
    for (int u = kChunk - 1; u >= 0; --u) {
      if (u < n) {
        const float g = fmaf(gv[u], cv[u], carry);
        if (live) {
          pda[u * plane] = g * hv[u];
          pdb[u * plane] = g;
        }
        carry = av[u] * g;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kChunk * L; i += kThreads) {
      const int u = i / L, sl = i % L;
      if (u < n && sl < ds) {
        float acc = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) acc += red[w][u][sl];
        part[static_cast<long long>(t0 + u) * ds + sl] = acc;
      }
    }
    __syncthreads();
  }
  if (live && dh0 != nullptr) dh0[bi * plane + cell] = carry;
}

// dC[b, t, s] = sum over the CTAs x of part[b, x, t, s], in index order
__global__ void __launch_bounds__(kThreads)
scan_dc_sum_kernel(const float* __restrict__ part, float* __restrict__ dC,
                   long long per_b, long long total, int n_parts) {
  // one thread per (b, t, s); per_b = S * ds, total = B * S * ds
  const long long i = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  if (i >= total) return;
  const float* p = part + (i / per_b) * n_parts * per_b + i % per_b;
  float acc = 0.0f;
#pragma unroll 8
  for (int x = 0; x < n_parts; ++x) acc += __ldg(p + x * per_b);
  dC[i] = acc;
}

template <int L>
cudaError_t launch_scan_bwd(const float* a, const float* b, const float* C,
                            const float* states, const float* dy,
                            const float* dhT, float* da, float* db,
                            float* dC, float* dc_part, float* dh0, int B,
                            int S, int di, int ds, long long n_part,
                            cudaStream_t st) {
  constexpr int kChannels = kThreads / L;
  const int n_x = (di + kChannels - 1) / kChannels;
  if (n_part != static_cast<long long>(B) * n_x * S * ds) {
    return cudaErrorInvalidValue;     // the wrapper's scratch is too small
  }
  if (S == 0) return cudaSuccess;
  selective_scan_bwd_kernel<L><<<dim3(n_x, B), kThreads, 0, st>>>(
      a, b, C, states, dy, dhT, da, db, dc_part, dh0, S, di, ds);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long per_b = static_cast<long long>(S) * ds;
  const long long total = per_b * B;
  const unsigned blocks =
      static_cast<unsigned>((total + kThreads - 1) / kThreads);
  scan_dc_sum_kernel<<<blocks, kThreads, 0, st>>>(dc_part, dC, per_b, total,
                                                  n_x);
  return cudaGetLastError();
}

}  // namespace

// a, b: (B, S, di, ds); C: (B, S, ds); h0: (B, di, ds) or null; y: (B, S,
// di); hT: (B, di, ds); states: (B, ceil(S / 16), di, ds) or null (not
// kept); all float32 and contiguous.  1 <= ds <= 32.
extern "C" int selective_scan_fwd(const float* a, const float* b,
                                  const float* C, const float* h0, float* y,
                                  float* hT, float* states, int B, int S,
                                  int di, int ds, void* stream) {
  if (B < 0 || B > 65535 || S < 0 || di < 0 || ds < 1 || ds > 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || di == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (ds <= 1) {
    err = launch_scan<1>(a, b, C, h0, y, hT, states, B, S, di, ds, st);
  } else if (ds <= 2) {
    err = launch_scan<2>(a, b, C, h0, y, hT, states, B, S, di, ds, st);
  } else if (ds <= 4) {
    err = launch_scan<4>(a, b, C, h0, y, hT, states, B, S, di, ds, st);
  } else if (ds <= 8) {
    err = launch_scan<8>(a, b, C, h0, y, hT, states, B, S, di, ds, st);
  } else if (ds <= 16) {
    err = launch_scan<16>(a, b, C, h0, y, hT, states, B, S, di, ds, st);
  } else {
    err = launch_scan<32>(a, b, C, h0, y, hT, states, B, S, di, ds, st);
  }
  return static_cast<int>(err);
}

// The gradient.  a, b, C and states as the forward took and kept them; dy:
// (B, S, di); dhT: (B, di, ds) or null (zeros); da, db: (B, S, di, ds); dC:
// (B, S, ds); dc_part: scratch of n_part = B * ceil(di / (256 / L)) * S *
// ds floats, L the power of two >= ds; dh0: (B, di, ds) or null (not
// written).  All float32 and contiguous.  1 <= ds <= 32.
extern "C" int selective_scan_bwd(const float* a, const float* b,
                                  const float* C, const float* states,
                                  const float* dy, const float* dhT,
                                  float* da, float* db, float* dC,
                                  float* dc_part, float* dh0, int B, int S,
                                  int di, int ds, long long n_part,
                                  void* stream) {
  if (B < 0 || B > 65535 || S < 0 || di < 1 || ds < 1 || ds > 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (ds <= 1) {
    err = launch_scan_bwd<1>(a, b, C, states, dy, dhT, da, db, dC, dc_part,
                             dh0, B, S, di, ds, n_part, st);
  } else if (ds <= 2) {
    err = launch_scan_bwd<2>(a, b, C, states, dy, dhT, da, db, dC, dc_part,
                             dh0, B, S, di, ds, n_part, st);
  } else if (ds <= 4) {
    err = launch_scan_bwd<4>(a, b, C, states, dy, dhT, da, db, dC, dc_part,
                             dh0, B, S, di, ds, n_part, st);
  } else if (ds <= 8) {
    err = launch_scan_bwd<8>(a, b, C, states, dy, dhT, da, db, dC, dc_part,
                             dh0, B, S, di, ds, n_part, st);
  } else if (ds <= 16) {
    err = launch_scan_bwd<16>(a, b, C, states, dy, dhT, da, db, dC, dc_part,
                              dh0, B, S, di, ds, n_part, st);
  } else {
    err = launch_scan_bwd<32>(a, b, C, states, dy, dhT, da, db, dC, dc_part,
                              dh0, B, S, di, ds, n_part, st);
  }
  return static_cast<int>(err);
}
