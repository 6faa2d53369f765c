// Selective scan: the Mamba1 recurrence over a whole sequence, in two forms
// built from one template that differ only in their loading stage.
//
//   h_t = a_t * h_{t-1} + b_t ;  y_t[d] = sum_s h_t[d, s] * C_t[s]
//
// The (a, b, C) form (selective_scan_fwd, selective_scan_bwd) takes a and b
// as (B, S, di, ds) float32 planes.  It replaces the TPU kernel
// src/repro/kernels/mamba_scan/kernel.py:55 selective_scan (_scan_kernel,
// :24): grid (batch, d_inner tile, seq chunk) with the state carried in
// VMEM scratch across the sequential chunk axis.  Plain version:
// repro_torch/kernels/mamba_scan/ref.py selective_scan.
//
// The fused form (selective_scan_fused_fwd, selective_scan_fused_bwd) takes
// Mamba's discretisation into the kernel: from dt and x (B, S, di) in the
// model's type, A (di, ds) and B, C (B, S, ds) in float32 it forms, in
// registers,
//
//   a_t = exp(dt_t A) ;  b_t = (dt_t x_t) B_t
//
// in the order of products of src/repro/models/layers.py:608-611, so no
// (B, S, di, ds) plane reaches device memory.  Plain version: ref.py
// selective_scan_fused (the model's eager lines, then the scan).  exp is
// ex2.approx of dt times a per-lane A log2(e) held in a register: it is
// off the recurrence's serial path, since a_t does not depend on h.
//
// Bound on an H100.  The (a, b, C) form: bytes, the two planes read once
// (at the serving prefill, B 4, S 256, di 8192, ds 16: 1.07 GB read and 34
// MB written, 0.33 ms at 3.35 TB/s).  The fused form reads dt, x, B and C
// and writes y and h_T: at the serving prefill in bfloat16 about 69 MB,
// 0.021 ms by bytes, and about 7 operations per (t, d, s), 0.014 ms at 67
// TFLOP/s.  Both are so small that what bounds the fused kernel in
// practice is the instruction rate: per (t, d, s) two shared-memory
// loads, an exp2, four float operations and a share of the lane sums.
//
// Design (both forms): parallel over (batch, channel d, state s),
// sequential over time inside the thread, with no chunk boundary in the
// recurrence: a channel's ds states live in the registers of ds
// neighbouring lanes (a group of L lanes, L the power of two >= ds; lanes
// past ds hold zeros) from t = 0 to S-1.  A CTA holds kCh = min(256 / L,
// 32) channels and walks the sequence in chunks of kChunk = 16 steps.
// Loading stage of the (a, b, C) form: each thread reads its a_t, b_t and
// C_t from device memory, kUnroll steps ahead of their use.  Loading stage
// of the fused form: the CTA stages each chunk into a double-buffered ring
// in shared memory with cp.async, while the chunk before is computed: its
// channels' dt and x rows (16 x kCh, contiguous in device memory; 16-byte
// copies where the rows are so aligned, 4-byte ones else, element loads
// where a bfloat16 row is not 4-byte aligned) and the chunk's B and C
// rows, interleaved by 4-byte copies into (B, C) pairs that every group
// of the CTA shares; copies past S and di fill zeros.  Once a chunk has
// landed the CTA forms each (step, channel)'s (dt, dt x) pair once for
// all its lanes, so a step costs a lane two 8-byte shared loads.  Steps
// past S then leave the state as it is (a = 1, b = 0, C = 0) with no test.
// y_t's sum over a group's lanes is taken for the 16 steps of a chunk at
// once by a transposed butterfly (15 shuffles for 16 sums at L = 16, where
// a sum per step costs 4), which leaves lane s of a group holding step s's
// sum; the sums go through shared memory and leave as coalesced rows of
// the CTA's channels.  h0 (zeros when null) seeds the state and h_T is
// written at the end.  When asked (``states`` not null), the forward also
// writes the state that enters each chunk, (B, ceil(S / kChunk), di, ds):
// 1/16 of a plane, which the backward restarts from.
//
// Backward: the scan's gradient, which the JAX package takes by
// differentiating its jnp scan (src/repro/models/layers.py:559
// _ssm_scan_chunked, and its discretisation :608-611) with
// jax.value_and_grad.  Plain versions: ref.py selective_scan_bwd_ref and
// selective_scan_fused_bwd_ref.
//
//   g_t = dy_t[d] C_t[s] + a_{t+1} g_{t+1}   (g_{S-1} also takes dhT)
//   da_t = g_t h_{t-1} ;  db_t = g_t ;  dC_t[s] = sum_d dy_t[d] h_t[d, s]
//   dh0 = a_0 g_0
//
// and in the fused form, with q_t = da_t a_t and u_t = dt_t x_t:
//
//   d_dt_t = sum_s q_t A + x_t sum_s g_t B_t ;  d_x_t = dt_t sum_s g_t B_t
//   dA = sum_{b, t} q_t dt_t ;  dB_t[s] = sum_d g_t[d, s] u_t[d]
//
// Bound on an H100: bytes.  The (a, b, C) form reads a and b and writes da
// and db, four planes: at the training packet (B 1, S 4096, di 8192, ds
// 16) about 8.7 GB, 2.6 ms at 3.35 TB/s.  The fused form reads dt, x, dy,
// B, C and the kept states and writes d_dt, d_x, dA, dB, dC and dh0: about
// 0.6 GB there in bfloat16, 0.2 ms, and about 22 operations per (t, d, s),
// 0.18 ms at 67 TFLOP/s.
//
// Design: the forward's layout, chunks and loading stages (the fused form
// also stages dy's rows).  Each thread walks its chunks from the last to
// the first; for a chunk it loads (the fused form: computes from the
// staged (dt, dt x) and (B, C) pairs) its a_t and b_t, recomputes the
// chunk's states from the kept boundary state with the forward's own fmaf
// (so they are the forward's values bit for bit), then runs the reverse
// recurrence and carries a_t g_t into the chunk before.  The (a, b, C)
// form writes da and db as it goes; the fused form sums d_dt's and d_x's
// terms over the group's lanes for kUnroll steps at once by the transposed
// butterfly and writes them as coalesced rows, and sums q_t dt_t over time
// in a register (dA's per-batch partial).  dC and dB sum over all di
// channels, which span CTAs: without atomics, each CTA sums its channels in
// a fixed order (shuffles across a warp's channel groups, then its warps
// through shared memory) into partial rows (B, CTAs, S, ds), and a second
// kernel sums the CTAs' partials, and dA's per-batch partials, in index
// order.  Two calls give bitwise-equal gradients.
//
// Both fused kernels pass two barriers a chunk: the next chunk's copies
// start at the top and are waited for at the end, where its (dt, dt x)
// pairs are formed into the other buffer while the chunk's outputs leave.
// The fused forward keeps to 64 registers a thread (four CTAs an SM), the
// fused backward holds the chunk's a_t and states in registers (128 a
// thread, two CTAs an SM): __launch_bounds__.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;       // a CTA's threads at most
constexpr int kMaxChannels = 32;    // a CTA's channels at most
constexpr int kUnroll = 8;
constexpr int kChunk = 16;          // steps between kept states
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kChunk % kUnroll == 0, "a chunk is whole unrolled steps");

// a CTA: kCh channels of L lanes each
template <int L>
struct Geo {
  static constexpr int kCh =
      kThreads / L < kMaxChannels ? kThreads / L : kMaxChannels;
  static constexpr int kTh = kCh * L;
  static constexpr int kWarps = kTh / 32;
};

int cta_channels(int ds) {
  int lanes = 1;
  while (lanes < ds) lanes <<= 1;
  return kThreads / lanes < kMaxChannels ? kThreads / lanes : kMaxChannels;
}

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The transposed butterfly: V values (one per step) summed over a group's
// L lanes at once.  Each round halves the values a lane holds, keeping the
// upper half where the lane's bit O is set and adding the partner's copy
// of it; once a lane holds one value the rounds left are a plain butterfly.
// After it, v[j] (j < Held::kN) holds the sum of step held_step(s, j).
template <int L, int V>
struct Held {
  static constexpr int kN = V >= L ? V / L : 1;       // sums a lane holds
  static constexpr int kShare = V >= L ? 1 : L / V;   // lanes with each sum
};

template <int O, int M, int V>
__device__ __forceinline__ void tsum_rounds(float (&v)[V], int s) {
  if constexpr (O >= 1) {
    if constexpr (M > 1) {
      constexpr int kH = M / 2;
      const bool up = (s & O) != 0;
#pragma unroll
      for (int j = 0; j < kH; ++j) {
        const float send = up ? v[j] : v[j + kH];
        const float keep = up ? v[j + kH] : v[j];
        v[j] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      tsum_rounds<O / 2, kH, V>(v, s);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
      tsum_rounds<O / 2, 1, V>(v, s);
    }
  }
}

template <int L, int V>
__device__ __forceinline__ void transpose_sum(float (&v)[V], int s) {
  tsum_rounds<L / 2, V, V>(v, s);
}

template <int L, int V>
__device__ __forceinline__ int held_step(int s, int j) {
  return V >= L ? s * (V / L) + j : s / (L / V);
}

// f(i) for this thread's i < N, i = threadIdx.x + a multiple of kTh: a
// loop of a trip count known at compile time, unrolled
template <int N, int kTh, typename F>
__device__ __forceinline__ void each(F&& f) {
#pragma unroll
  for (int it = 0; it < (N + kTh - 1) / kTh; ++it) {
    const int i = static_cast<int>(threadIdx.x) + it * kTh;
    if (N % kTh == 0 || i < N) f(i);
  }
}

// 2^x in one MUFU operation (results below 2^-126 flush to zero)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Every argument of the four kernels; each form reads its own.
template <typename T>
struct ScanArgs {
  const float* a;           // (a, b, C) form: (B, S, di, ds)
  const float* b;
  const T* dt;              // fused form: (B, S, di)
  const T* x;
  const float* A;           // fused form: (di, ds)
  const float* Bm;          // fused form: (B, S, ds)
  const float* C;           // (B, S, ds)
  const float* h0;          // (B, di, ds) or null
  float* y;                 // (B, S, di)
  float* hT;                // (B, di, ds)
  float* states;            // (B, ceil(S / kChunk), di, ds) or null
  const float* kept;        // the states the forward kept (backward)
  const float* dy;          // (B, S, di)
  const float* dhT;         // (B, di, ds) or null
  float* da;                // (a, b, C) form: (B, S, di, ds)
  float* db;
  T* ddt;                   // fused form: (B, S, di)
  T* dx;
  float* dA_part;           // fused form: (B, di, ds) or null
  float* part;              // per-CTA partials of dC (fused: then dB)
  long long n_one;          // floats of one partial array
  float* dh0;               // (B, di, ds) or null
  int S, di, ds;
  int copy_dtx;             // how dt and x rows are staged: kCopy16, ...
  int copy_dy;              // how dy rows are staged
};

// how a (rows, di) tensor's rows reach shared memory: 16-byte or 4-byte
// cp.async copies (their sources so aligned), or loads and stores
constexpr int kCopyLoad = 0;
constexpr int kCopy4 = 1;
constexpr int kCopy16 = 2;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}

template <typename E>
__device__ __forceinline__ E zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.0f);
}

// rows row0 .. row0+n-1 (zeros after) of channels d0 .. d0+kCh-1 (zeros
// past di) of a (rows, di) tensor into tile, as ``how`` says
template <int kCh, int kTh, typename E>
__device__ __forceinline__ void stage_rows(E (&tile)[kChunk][kCh],
                                           const E* src, long long row0,
                                           int n, int d0, int di, int how) {
  if (how == kCopy16) {
    constexpr int kPer = 16 / static_cast<int>(sizeof(E));
    constexpr int kRow = kCh / kPer;
    static_assert(kCh % kPer == 0, "a tile row is whole 16-byte copies");
    each<kChunk * kRow, kTh>([&](int i) {
      const int u = i / kRow, c = (i % kRow) * kPer;
      const bool ok = u < n && d0 + c < di;   // di is whole copies too
      cp_async16(&tile[u][c], ok ? src + (row0 + u) * di + d0 + c : src,
                 ok);
    });
  } else if (how == kCopy4) {
    constexpr int kPer = 4 / static_cast<int>(sizeof(E));
    constexpr int kRow = kCh / kPer;
    each<kChunk * kRow, kTh>([&](int i) {
      const int u = i / kRow, c = (i % kRow) * kPer;
      const bool ok = u < n && d0 + c < di;
      cp_async4(&tile[u][c], ok ? src + (row0 + u) * di + d0 + c : src, ok);
    });
  } else {
    each<kChunk * kCh, kTh>([&](int i) {
      const int u = i / kCh, c = i % kCh;
      tile[u][c] = (u < n && d0 + c < di) ? src[(row0 + u) * di + d0 + c]
                                          : zero<E>();
    });
  }
}

// the fused form's tiles: a chunk's dt and x rows (and the backward's dy)
// and its (B, C) pairs, two chunks deep, and the chunk's (dt, dt x) pairs
// formed once for all the lanes of a channel; the (a, b, C) form stages
// nothing
template <typename T, int kCh, int L, bool kFused, bool kBwd>
struct Ring {};
template <typename T, int kCh, int L>
struct Ring<T, kCh, L, true, false> {
  T dt[2][kChunk][kCh];
  T x[2][kChunk][kCh];
  float2 bc[2][kChunk][L];         // zeros past ds
  float2 pre[2][kChunk][kCh];
};
template <typename T, int kCh, int L>
struct Ring<T, kCh, L, true, true> {
  T dt[2][kChunk][kCh];
  T x[2][kChunk][kCh];
  float dy[2][kChunk][kCh];
  float2 bc[2][kChunk][L];
  float2 pre[2][kChunk][kCh];
  float ddt[kChunk][kCh + 1];      // the chunk's d_dt and d_x rows
  float dx[kChunk][kCh + 1];
};

// the fused form's loading stage, part 1: chunk k's rows into buffer k % 2
// by asynchronous copies; B and C interleaved as (B, C) pairs
template <int L, typename T, bool kBwd>
__device__ __forceinline__ void stage(
    Ring<T, Geo<L>::kCh, L, true, kBwd>& r, const ScanArgs<T>& p,
    long long bi, int k, int d0) {
  constexpr int kCh = Geo<L>::kCh, kTh = Geo<L>::kTh;
  const int buf = k & 1, t0 = k * kChunk, n = min(kChunk, p.S - t0);
  const long long row0 = bi * p.S + t0;
  stage_rows<kCh, kTh>(r.dt[buf], p.dt, row0, n, d0, p.di, p.copy_dtx);
  stage_rows<kCh, kTh>(r.x[buf], p.x, row0, n, d0, p.di, p.copy_dtx);
  if constexpr (kBwd) {
    stage_rows<kCh, kTh>(r.dy[buf], p.dy, row0, n, d0, p.di, p.copy_dy);
  }
  const int ds = p.ds;
  each<kChunk * L, kTh>([&](int i) {
    const int u = i / L, sl = i % L;
    if (sl < ds) {                 // the pairs past ds stay zero
      const bool ok = u < n;
      const long long at = (row0 + u) * ds + sl;
      cp_async4(&r.bc[buf][u][sl].x, ok ? p.Bm + at : p.Bm, ok);
      cp_async4(&r.bc[buf][u][sl].y, ok ? p.C + at : p.C, ok);
    }
  });
}

// zero both buffers' (B, C) pairs past ds, which no copy writes
template <int L, typename T, bool kBwd>
__device__ __forceinline__ void zero_pairs(
    Ring<T, Geo<L>::kCh, L, true, kBwd>& r, int ds) {
  each<2 * kChunk * L, Geo<L>::kTh>([&](int i) {
    if (i % L >= ds) {
      r.bc[i / (kChunk * L)][(i / L) % kChunk][i % L] =
          make_float2(0.0f, 0.0f);
    }
  });
}

// the fused form's loading stage, part 2, once a chunk has landed in
// buffer buf: each (step, channel)'s (dt, dt x) in float32, in the JAX
// package's order, into pre[buf]
template <int L, typename T, bool kBwd>
__device__ __forceinline__ void form_pairs(
    Ring<T, Geo<L>::kCh, L, true, kBwd>& r, int buf) {
  constexpr int kCh = Geo<L>::kCh;
  each<kChunk * kCh, Geo<L>::kTh>([&](int i) {
    const int u = i / kCh, c = i % kCh;
    const float dtv = to_f(r.dt[buf][u][c]);
    r.pre[buf][u][c] = make_float2(dtv, dtv * to_f(r.x[buf][u][c]));
  });
}

template <int L, typename T, bool kFused>
__global__ void __launch_bounds__(Geo<L>::kTh, kFused ? 4 : 3)
scan_fwd_kernel(const ScanArgs<T> p) {
  constexpr int kCh = Geo<L>::kCh, kTh = Geo<L>::kTh;
  using H = Held<L, kChunk>;
  __shared__ __align__(16) Ring<T, kCh, L, kFused, false> ring;
  __shared__ float ys[kChunk][kCh + 1];
  const int s = threadIdx.x % L, ch = threadIdx.x / L;
  const int d0 = blockIdx.x * kCh, d = d0 + ch;
  const long long bi = blockIdx.y;
  const int S = p.S, di = p.di, ds = p.ds;
  // whole groups are in or out of range, so every lane of a warp takes
  // part in the shuffles and barriers; out-of-range lanes store nothing
  const bool chan = d < di;
  const bool live = chan && s < ds;
  const long long plane = static_cast<long long>(di) * ds;
  const long long cell = static_cast<long long>(d) * ds + s;
  const int n_chunks = (S + kChunk - 1) / kChunk;
  float h = (live && p.h0 != nullptr) ? p.h0[bi * plane + cell] : 0.0f;
  float* pst = p.states == nullptr ? nullptr
                                   : p.states + bi * n_chunks * plane + cell;
  float A2 = 0.0f;                 // a_t = 2^(dt_t A log2 e)
  if constexpr (kFused) {        // chunk 0 landed and its pairs formed
    if (live) A2 = p.A[cell] * kLog2e;
    zero_pairs<L, T, false>(ring, ds);
    if (n_chunks > 0) stage<L, T, false>(ring, p, bi, 0, d0);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (n_chunks > 0) form_pairs<L, T, false>(ring, 0);
  }
  for (int k = 0; k < n_chunks; ++k) {
    const int t0 = k * kChunk, n = min(kChunk, S - t0);
    const long long row0 = bi * S + t0;
    const int buf = k & 1;
    if constexpr (kFused) {        // chunk k + 1 lands while k is computed
      if (k + 1 < n_chunks) stage<L, T, false>(ring, p, bi, k + 1, d0);
      cp_async_commit();
    }
    __syncthreads();
    if (pst != nullptr && live) pst[k * plane] = h;
    // Steps past S leave h as it is (a = 1, b = 0) and add nothing to y
    // (C = 0): the fused form's copies fill them with zeros, and the (a,
    // b, C) form loads a = 1 there.
    float pv[kChunk];
#pragma unroll
    for (int u0 = 0; u0 < kChunk; u0 += kUnroll) {
      float av[kUnroll], bv[kUnroll], cv[kUnroll];
      if constexpr (kFused) {      // the loading stage: shared memory
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const float2 pu = ring.pre[buf][u0 + u][ch]; // (dt, dt x)
          const float2 bc = ring.bc[buf][u0 + u][s];   // (B, C)
          av[u] = fast_exp2(pu.x * A2);
          bv[u] = pu.y * bc.x;
          cv[u] = bc.y;
        }
      } else {                     // the loading stage: device memory
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const bool in = u0 + u < n;
          const long long row = row0 + u0 + u;
          av[u] = !in ? 1.0f : live ? __ldg(p.a + row * plane + cell) : 0.0f;
          bv[u] = (live && in) ? __ldg(p.b + row * plane + cell) : 0.0f;
          cv[u] = (s < ds && in) ? __ldg(p.C + row * ds + s) : 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        h = fmaf(av[u], h, bv[u]);
        pv[u0 + u] = h * cv[u];
      }
    }
    transpose_sum<L, kChunk>(pv, s);
    if (chan && s % H::kShare == 0) {
#pragma unroll
      for (int j = 0; j < H::kN; ++j) {
        ys[held_step<L, kChunk>(s, j)][ch] = pv[j];
      }
    }
    if constexpr (kFused) cp_async_wait<0>();
    __syncthreads();
    if constexpr (kFused) {
      if (k + 1 < n_chunks) form_pairs<L, T, false>(ring, buf ^ 1);
    }
    each<kChunk * kCh, kTh>([&](int i) {
      const int u = i / kCh, c = i % kCh;
      if (u < n && d0 + c < di) p.y[(row0 + u) * di + d0 + c] = ys[u][c];
    });
  }
  if (live) p.hT[bi * plane + cell] = h;
}

template <int L, typename T, bool kFused>
__global__ void __launch_bounds__(Geo<L>::kTh, kFused ? 2 : 1)
scan_bwd_kernel(const ScanArgs<T> p) {
  constexpr int kCh = Geo<L>::kCh, kTh = Geo<L>::kTh;
  constexpr int kWarps = Geo<L>::kWarps;
  constexpr int kSums = kFused ? 2 : 1;      // dC, and the fused form's dB
  using H = Held<L, kUnroll>;
  __shared__ __align__(16) Ring<T, kCh, L, kFused, true> ring;
  // each warp's partials of a chunk: its channels summed, by (step, state)
  __shared__ float red[kSums][kWarps][kChunk][L];
  const int s = threadIdx.x % L, ch = threadIdx.x / L;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int d0 = blockIdx.x * kCh, d = d0 + ch;
  const long long bi = blockIdx.y;
  const int S = p.S, di = p.di, ds = p.ds;
  // whole groups are in or out of range: every lane takes part in the
  // shuffles and barriers, out-of-range lanes store nothing
  const bool chan = d < di;
  const bool live = chan && s < ds;
  const long long plane = static_cast<long long>(di) * ds;
  const long long cell = static_cast<long long>(d) * ds + s;
  const int n_chunks = (S + kChunk - 1) / kChunk;
  const float* pst = p.kept + bi * n_chunks * plane + cell;
  float* part = p.part + (bi * gridDim.x + blockIdx.x) * S * ds;
  // a_{t+1} g_{t+1}, carried into step t
  float carry = (live && p.dhT != nullptr) ? p.dhT[bi * plane + cell] : 0.0f;
  float Av = 0.0f, dA = 0.0f;
  if constexpr (kFused) {        // the last chunk landed, its pairs formed
    if (live) Av = p.A[cell];
    zero_pairs<L, T, true>(ring, ds);
    stage<L, T, true>(ring, p, bi, n_chunks - 1, d0);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    form_pairs<L, T, true>(ring, (n_chunks - 1) & 1);
  }
  const float A2 = Av * kLog2e;
  // the state entering the chunk, loaded a chunk ahead
  float h_in = live ? pst[static_cast<long long>(n_chunks - 1) * plane]
                    : 0.0f;

  for (int k = n_chunks - 1; k >= 0; --k) {
    const int t0 = k * kChunk, n = min(kChunk, S - t0);
    const long long row0 = bi * S + t0;
    const int buf = k & 1;
    if constexpr (kFused) {        // chunk k - 1 lands while k is computed
      if (k > 0) stage<L, T, true>(ring, p, bi, k - 1, d0);
      cp_async_commit();
    }
    __syncthreads();
    float av[kChunk], bv[kChunk], cv[kChunk], gv[kChunk], hv[kChunk + 1];
    hv[0] = h_in;
    if (k > 0 && live) h_in = pst[static_cast<long long>(k - 1) * plane];
    // Steps past S leave the state and the carry as they are (a = 1, b =
    // 0, C = dy = 0) and their outputs are not written.
    if constexpr (kFused) {        // the loading stage: shared memory
      // (C and dy are read there again where they are used)
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const float2 pu = ring.pre[buf][u][ch];
        av[u] = fast_exp2(pu.x * A2);
        bv[u] = pu.y * ring.bc[buf][u][s].x;
      }
    } else {                       // the loading stage: device memory
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const bool in = u < n;
        const long long row = row0 + u;
        av[u] = !in ? 1.0f : live ? __ldg(p.a + row * plane + cell) : 0.0f;
        bv[u] = (live && in) ? __ldg(p.b + row * plane + cell) : 0.0f;
        cv[u] = (s < ds && in) ? __ldg(p.C + row * ds + s) : 0.0f;
        gv[u] = (chan && in) ? __ldg(p.dy + row * di + d) : 0.0f;
      }
    }
    // the chunk's states, as the forward computed them
#pragma unroll
    for (int u = 0; u < kChunk; ++u) hv[u + 1] = fmaf(av[u], hv[u], bv[u]);
    // the reverse recurrence, kUnroll steps at a time
#pragma unroll
    for (int u0 = kChunk - kUnroll; u0 >= 0; u0 -= kUnroll) {
      float r1[kUnroll], r2[kUnroll];
#pragma unroll
      for (int j = kUnroll - 1; j >= 0; --j) {
        const int u = u0 + j;
        float dyu, cu;
        if constexpr (kFused) {
          dyu = ring.dy[buf][u][ch];
          cu = ring.bc[buf][u][s].y;
        } else {
          dyu = gv[u];
          cu = cv[u];
        }
        const float g = fmaf(dyu, cu, carry);
        // dC's term: this warp's channels summed for each (step, state)
        float pc = dyu * hv[u + 1];
#pragma unroll
        for (int o = L; o < 32; o <<= 1) {
          pc += __shfl_xor_sync(0xffffffffu, pc, o);
        }
        if (lane < L) red[0][warp][u][lane] = pc;
        if constexpr (kFused) {
          const float2 pu = ring.pre[buf][u][ch];      // (dt, dt x)
          const float q = (g * hv[u]) * av[u];
          dA = fmaf(q, pu.x, dA);
          r1[j] = q * Av;
          r2[j] = g * ring.bc[buf][u][s].x;
          float pb = g * pu.y;                         // dB's term
#pragma unroll
          for (int o = L; o < 32; o <<= 1) {
            pb += __shfl_xor_sync(0xffffffffu, pb, o);
          }
          if (lane < L) red[1][warp][u][lane] = pb;
        } else if (live && u < n) {
          p.da[(row0 + u) * plane + cell] = g * hv[u];
          p.db[(row0 + u) * plane + cell] = g;
        }
        carry = av[u] * g;
      }
      if constexpr (kFused) {
        transpose_sum<L, kUnroll>(r1, s);
        transpose_sum<L, kUnroll>(r2, s);
        if (chan && s % H::kShare == 0) {
#pragma unroll
          for (int j = 0; j < H::kN; ++j) {
            const int u = u0 + held_step<L, kUnroll>(s, j);
            const float dtv = ring.pre[buf][u][ch].x;
            const float xv = to_f(ring.x[buf][u][ch]);
            ring.ddt[u][ch] = r1[j] + r2[j] * xv;
            ring.dx[u][ch] = r2[j] * dtv;
          }
        }
      }
    }
    if constexpr (kFused) cp_async_wait<0>();
    __syncthreads();
    if constexpr (kFused) {
      if (k > 0) form_pairs<L, T, true>(ring, buf ^ 1);
    }
    each<kSums * kChunk * L, kTh>([&](int i) {
      const int w = i / (kChunk * L), u = (i / L) % kChunk, sl = i % L;
      if (u < n && sl < ds) {
        float acc = 0.0f;
#pragma unroll
        for (int wp = 0; wp < kWarps; ++wp) acc += red[w][wp][u][sl];
        part[w * p.n_one + static_cast<long long>(t0 + u) * ds + sl] = acc;
      }
    });
    if constexpr (kFused) {
      each<kChunk * kCh, kTh>([&](int i) {
        const int u = i / kCh, c = i % kCh;
        if (u < n && d0 + c < di) {
          const long long at = (row0 + u) * di + d0 + c;
          p.ddt[at] = from_f<T>(ring.ddt[u][c]);
          p.dx[at] = from_f<T>(ring.dx[u][c]);
        }
      });
    }
  }
  if (live && p.dh0 != nullptr) p.dh0[bi * plane + cell] = carry;
  if constexpr (kFused) {
    if (live && p.dA_part != nullptr) p.dA_part[bi * plane + cell] = dA;
  }
}

// out[w, b, r] = sum over the CTAs x of part[w, b, x, r] (r < per_b) in
// index order, for the n_sums partial arrays; then dA[j] = sum over the
// batch of dA_part[b, j] in index order (dA null: none)
__global__ void __launch_bounds__(kThreads)
scan_partial_sum_kernel(const float* __restrict__ part,
                        float* __restrict__ out, long long per_b,
                        long long n_out, int n_sums, int n_parts,
                        const float* __restrict__ dA_part,
                        float* __restrict__ dA, long long n_a, int B) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  const long long n_bc = n_out * n_sums;
  if (i < n_bc) {
    const long long w = i / n_out, r = i % n_out;
    const float* q = part + w * n_out * n_parts
                     + (r / per_b) * n_parts * per_b + r % per_b;
    float acc = 0.0f;
#pragma unroll 8
    for (int x = 0; x < n_parts; ++x) acc += __ldg(q + x * per_b);
    out[i] = acc;
  } else if (dA != nullptr && i < n_bc + n_a) {
    const long long j = i - n_bc;
    float acc = 0.0f;
    for (int b = 0; b < B; ++b) acc += __ldg(dA_part + b * n_a + j);
    dA[j] = acc;
  }
}

template <int L, typename T, bool kFused>
cudaError_t launch_l(const ScanArgs<T>& p, int B, bool bwd,
                     cudaStream_t st) {
  const dim3 grid((p.di + Geo<L>::kCh - 1) / Geo<L>::kCh, B);
  if (bwd) {
    scan_bwd_kernel<L, T, kFused><<<grid, Geo<L>::kTh, 0, st>>>(p);
  } else {
    scan_fwd_kernel<L, T, kFused><<<grid, Geo<L>::kTh, 0, st>>>(p);
  }
  return cudaGetLastError();
}

template <typename T, bool kFused>
cudaError_t launch(const ScanArgs<T>& p, int B, bool bwd, cudaStream_t st) {
  if (p.ds <= 1) return launch_l<1, T, kFused>(p, B, bwd, st);
  if (p.ds <= 2) return launch_l<2, T, kFused>(p, B, bwd, st);
  if (p.ds <= 4) return launch_l<4, T, kFused>(p, B, bwd, st);
  if (p.ds <= 8) return launch_l<8, T, kFused>(p, B, bwd, st);
  if (p.ds <= 16) return launch_l<16, T, kFused>(p, B, bwd, st);
  return launch_l<32, T, kFused>(p, B, bwd, st);
}

// the second pass of a backward: the partials of the n_sums (B, S, ds)
// sums into out, and dA's per-batch partials into dA
cudaError_t launch_sums(const float* part, float* out, int n_sums,
                        int n_parts, const float* dA_part, float* dA, int B,
                        int S, int di, int ds, cudaStream_t st) {
  const long long per_b = static_cast<long long>(S) * ds;
  const long long n_out = per_b * B;
  const long long n_a = dA == nullptr ? 0 : static_cast<long long>(di) * ds;
  const long long total = n_out * n_sums + n_a;
  const unsigned blocks =
      static_cast<unsigned>((total + kThreads - 1) / kThreads);
  scan_partial_sum_kernel<<<blocks, kThreads, 0, st>>>(
      part, out, per_b, n_out, n_sums, n_parts, dA_part, dA, n_a, B);
  return cudaGetLastError();
}

bool bad_shape(int B, int S, int di, int ds) {
  return B < 0 || B > 65535 || S < 0 || di < 0 || ds < 1 || ds > 32;
}

// dtype codes of the fused form's dt and x (and d_dt and d_x)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

// how the rows of a (rows, di) tensor of E at p may be staged (and q's,
// where q is not null)
int copy_mode(const void* p, const void* q, int di, int esize) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uintptr_t b = q == nullptr ? 0 : reinterpret_cast<uintptr_t>(q);
  if ((static_cast<long long>(di) * esize) % 16 == 0 && a % 16 == 0
      && b % 16 == 0) {
    return kCopy16;
  }
  if ((static_cast<long long>(di) * esize) % 4 == 0 && a % 4 == 0
      && b % 4 == 0) {
    return kCopy4;
  }
  return kCopyLoad;
}

template <typename T>
cudaError_t fused_fwd(const void* dt, const void* x, const float* A,
                      const float* Bm, const float* C, const float* h0,
                      float* y, float* hT, float* states, int B, int S,
                      int di, int ds, cudaStream_t st) {
  ScanArgs<T> p{};
  p.dt = static_cast<const T*>(dt);
  p.x = static_cast<const T*>(x);
  p.A = A;
  p.Bm = Bm;
  p.C = C;
  p.h0 = h0;
  p.y = y;
  p.hT = hT;
  p.states = states;
  p.S = S;
  p.di = di;
  p.ds = ds;
  p.copy_dtx = copy_mode(dt, x, di, sizeof(T));
  return launch<T, true>(p, B, false, st);
}

template <typename T>
cudaError_t fused_bwd(const void* dt, const void* x, const float* A,
                      const float* Bm, const float* C, const float* states,
                      const float* dy, const float* dhT, void* ddt, void* dx,
                      float* dA, float* dA_part, float* dCB, float* part,
                      float* dh0, int B, int S, int di, int ds,
                      long long n_part, cudaStream_t st) {
  ScanArgs<T> p{};
  p.dt = static_cast<const T*>(dt);
  p.x = static_cast<const T*>(x);
  p.A = A;
  p.Bm = Bm;
  p.C = C;
  p.kept = states;
  p.dy = dy;
  p.dhT = dhT;
  p.ddt = static_cast<T*>(ddt);
  p.dx = static_cast<T*>(dx);
  p.dA_part = dA == nullptr ? nullptr : dA_part;
  p.part = part;
  p.n_one = n_part;
  p.dh0 = dh0;
  p.S = S;
  p.di = di;
  p.ds = ds;
  p.copy_dtx = copy_mode(dt, x, di, sizeof(T));
  p.copy_dy = copy_mode(dy, nullptr, di, 4);
  cudaError_t err = launch<T, true>(p, B, true, st);
  if (err != cudaSuccess) return err;
  const int n_x = (di + cta_channels(ds) - 1) / cta_channels(ds);
  return launch_sums(part, dCB, 2, n_x, dA_part, dA, B, S, di, ds, st);
}

long long parts_of(int B, int S, int di, int ds) {
  const int n_x = (di + cta_channels(ds) - 1) / cta_channels(ds);
  return static_cast<long long>(B) * n_x * S * ds;
}

}  // namespace

// a, b: (B, S, di, ds); C: (B, S, ds); h0: (B, di, ds) or null; y: (B, S,
// di); hT: (B, di, ds); states: (B, ceil(S / 16), di, ds) or null (not
// kept); all float32 and contiguous.  1 <= ds <= 32.
extern "C" int selective_scan_fwd(const float* a, const float* b,
                                  const float* C, const float* h0, float* y,
                                  float* hT, float* states, int B, int S,
                                  int di, int ds, void* stream) {
  if (bad_shape(B, S, di, ds)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || di == 0) return static_cast<int>(cudaSuccess);
  ScanArgs<float> p{};
  p.a = a;
  p.b = b;
  p.C = C;
  p.h0 = h0;
  p.y = y;
  p.hT = hT;
  p.states = states;
  p.S = S;
  p.di = di;
  p.ds = ds;
  return static_cast<int>(
      launch<float, false>(p, B, false, static_cast<cudaStream_t>(stream)));
}

// The gradient.  a, b, C and states as the forward took and kept them; dy:
// (B, S, di); dhT: (B, di, ds) or null (zeros); da, db: (B, S, di, ds); dC:
// (B, S, ds); dc_part: scratch of n_part = B * ceil(di / kCh) * S * ds
// floats, kCh = min(256 / L, 32) and L the power of two >= ds; dh0: (B,
// di, ds) or null (not written).  All float32 and contiguous.  1 <= ds <=
// 32.
extern "C" int selective_scan_bwd(const float* a, const float* b,
                                  const float* C, const float* states,
                                  const float* dy, const float* dhT,
                                  float* da, float* db, float* dC,
                                  float* dc_part, float* dh0, int B, int S,
                                  int di, int ds, long long n_part,
                                  void* stream) {
  if (bad_shape(B, S, di, ds) || di < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return static_cast<int>(cudaSuccess);
  if (n_part != parts_of(B, S, di, ds)) {
    return static_cast<int>(cudaErrorInvalidValue);   // scratch too small
  }
  if (S == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  ScanArgs<float> p{};
  p.a = a;
  p.b = b;
  p.C = C;
  p.kept = states;
  p.dy = dy;
  p.dhT = dhT;
  p.da = da;
  p.db = db;
  p.part = dc_part;
  p.n_one = n_part;
  p.dh0 = dh0;
  p.S = S;
  p.di = di;
  p.ds = ds;
  cudaError_t err = launch<float, false>(p, B, true, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_x = (di + cta_channels(ds) - 1) / cta_channels(ds);
  return static_cast<int>(launch_sums(dc_part, dC, 1, n_x, nullptr, nullptr,
                                      B, S, di, ds, st));
}

// The fused forward.  dt, x: (B, S, di) of the type ``dtype`` (0 float32,
// 1 bfloat16); A: (di, ds); Bm, C: (B, S, ds); h0: (B, di, ds) or null;
// y: (B, S, di); hT: (B, di, ds); states: (B, ceil(S / 16), di, ds) or
// null (not kept); all but dt and x float32, all contiguous.  1 <= ds <=
// 32.
extern "C" int selective_scan_fused_fwd(const void* dt, const void* x,
                                        const float* A, const float* Bm,
                                        const float* C, const float* h0,
                                        float* y, float* hT, float* states,
                                        int B, int S, int di, int ds,
                                        int dtype, void* stream) {
  if (bad_shape(B, S, di, ds) || (dtype != kFloat32 && dtype != kBFloat16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || di == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == kFloat32
          ? fused_fwd<float>(dt, x, A, Bm, C, h0, y, hT, states, B, S, di,
                             ds, st)
          : fused_fwd<__nv_bfloat16>(dt, x, A, Bm, C, h0, y, hT, states, B,
                                     S, di, ds, st));
}

// The fused gradient.  dt, x, A, Bm, C and states as the forward took and
// kept them; dy: (B, S, di) float32; dhT: (B, di, ds) or null (zeros);
// ddt, dx: (B, S, di) of ``dtype``; dA: (di, ds) or null (not wanted),
// dA_part: (B, di, ds) scratch; dCB: (2, B, S, ds), dC then dB; part:
// scratch of 2 * n_part floats, n_part = B * ceil(di / kCh) * S * ds; dh0:
// (B, di, ds) or null.  All contiguous.  1 <= ds <= 32.
extern "C" int selective_scan_fused_bwd(
    const void* dt, const void* x, const float* A, const float* Bm,
    const float* C, const float* states, const float* dy, const float* dhT,
    void* ddt, void* dx, float* dA, float* dA_part, float* dCB, float* part,
    float* dh0, int B, int S, int di, int ds, int dtype, long long n_part,
    void* stream) {
  if (bad_shape(B, S, di, ds) || di < 1
      || (dtype != kFloat32 && dtype != kBFloat16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return static_cast<int>(cudaSuccess);
  if (n_part != parts_of(B, S, di, ds)) {
    return static_cast<int>(cudaErrorInvalidValue);   // scratch too small
  }
  if (S == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == kFloat32
          ? fused_bwd<float>(dt, x, A, Bm, C, states, dy, dhT, ddt, dx, dA,
                             dA_part, dCB, part, dh0, B, S, di, ds, n_part,
                             st)
          : fused_bwd<__nv_bfloat16>(dt, x, A, Bm, C, states, dy, dhT, ddt,
                                     dx, dA, dA_part, dCB, part, dh0, B, S,
                                     di, ds, n_part, st));
}
