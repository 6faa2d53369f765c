// Causal grouped-query attention, backward: dq, dk, dv from q, k, v, the
// forward's output o and its gradient do.
//
// The JAX package has no Pallas kernel for this gradient: its training
// path differentiates its jnp attention (src/repro/models/layers.py
// _flash_inner / blocked_causal_attention) with jax.value_and_grad, while
// the port's every prefill attention is the CUDA forward kernel
// (flash_attention.cu, which replaces src/repro/kernels/flash_attention/
// kernel.py:69 flash_attention).  This is that kernel's gradient.  Plain
// version: repro_torch/kernels/flash_attention/ref.py attention_bwd_ref.
//
// Bound on an H100: operations.  The least work is five products of the
// causal half, 5 * 2*D*S^2/2 per head, against q, k, v, o, do read once
// and dq, dk, dv written once: at S = 4096, D = 64 about 1,300 operations
// a byte in bfloat16, far past the card's ~295, so the multipliers set the
// least time (0.174 ms at B=1, H=32 on the bf16 tensor cores).
//
// Design: three kernels, no atomics, so that two calls give bitwise-equal
// gradients (every output element is summed by one thread in a fixed
// order).  All products are float32 FMAs on tiles staged in shared memory
// as float32 (bfloat16 inputs are widened as they are loaded), all
// accumulation is float32; this is the simple first kernel, not a fast
// one (mma.sync / wgmma and a forward that writes its log-sum-exp are the
// redesign, ROADMAP Queue B2).
//
//   (a) bwd_prepass_kernel, a CTA per (batch, head, 64-row query tile):
//       recomputes each row's softmax log-sum-exp (in base 2) over the key
//       tiles on and below the diagonal, and forms D_i = sum_d do*o, into
//       float32 scratch of (B, H, S).  Recomputing it here leaves the
//       forward kernel untouched.
//   (b) bwd_dkdv_kernel, a CTA per (batch, kv head, 64-key tile): loops
//       over the query tiles on or below the diagonal and the G query
//       heads of the group; per tile it forms S = Q K^T and dP = dO V^T
//       (a 4x4 block of each per thread), P = exp2(S*scale*log2e - lse)
//       and dS = P (dP - D_i) into shared memory, then dV += P^T dO and
//       dK += dS^T Q into float32 registers (4 keys x DP/16 columns per
//       thread).  Heaviest tiles (key tile 0) are launched first.
//   (c) bwd_dq_kernel, a CTA per (batch, head, 64-row query tile): loops
//       over the key tiles up to the diagonal with the same S, dP, P, dS,
//       then dQ += dS K (4 rows x DP/16 columns per thread).
//
// 256 threads; in the S-shaped products thread (tr, tc) = (tid/16,
// tid%16) owns rows tr + 16*ii and columns tc + 16*jj, so a warp's float4
// reads of K (row stride DP + 4 floats) hit distinct banks and its reads
// of Q are broadcasts.  Positions past S (a ragged last tile, any S) and
// head columns past D (D = 80 runs padded to 96) are zero-filled and
// masked.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kT = 64;          // rows of a query tile = keys of a key tile
constexpr int kPS = kT + 4;     // row stride (floats) of the P / dS tiles

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Tile of kT positions x DP columns of a (B, S, NH, D) tensor at
// (b, p0, head) into shared memory (row stride DP + 4), float32,
// zero-filled past S and past D.
template <typename T, int DP>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int b, int p0, int head, int S,
                                          int NH, int D) {
  constexpr int LS = DP + 4;
  for (int idx = threadIdx.x; idx < kT * DP; idx += kThreads) {
    const int r = idx / DP, d = idx - r * DP;
    const int p = p0 + r;
    float x = 0.f;
    if (p < S && d < D)
      x = to_f(src[((static_cast<size_t>(b) * S + p) * NH + head) * D + d]);
    dst[r * LS + d] = x;
  }
}

// acc[ii][jj] = sum_d A[tr + 16 ii][d] * Bm[tc + 16 jj][d] over DP columns
template <int DP>
__device__ __forceinline__ void rows_dot(float (&acc)[4][4], const float* A,
                                         const float* Bm, int tr, int tc) {
  constexpr int LS = DP + 4;
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[ii][jj] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DP; d += 4) {
    float4 a[4], bv[4];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
      a[ii] = *reinterpret_cast<const float4*>(A + (tr + 16 * ii) * LS + d);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      bv[jj] = *reinterpret_cast<const float4*>(Bm + (tc + 16 * jj) * LS + d);
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float s = acc[ii][jj];
        s = fmaf(a[ii].x, bv[jj].x, s);
        s = fmaf(a[ii].y, bv[jj].y, s);
        s = fmaf(a[ii].z, bv[jj].z, s);
        s = fmaf(a[ii].w, bv[jj].w, s);
        acc[ii][jj] = s;
      }
  }
}

// acc[r][c] += sum_i W[i][4 rr + r] * X[i][2 dc + 32 (c/2) + c%2], i over
// the kT rows of W (row stride kPS) and X (row stride DP + 4): the
// transposed products dV += P^T dO, dK += dS^T Q and, with W = dS^T,
// dQ += dS K.
template <int DP>
__device__ __forceinline__ void cols_accum(float (&acc)[4][DP / 16],
                                           const float* W, const float* X,
                                           int rr, int dc) {
  constexpr int LS = DP + 4;
  constexpr int NC = DP / 32;
#pragma unroll 2
  for (int i = 0; i < kT; ++i) {
    const float4 w = *reinterpret_cast<const float4*>(W + i * kPS + 4 * rr);
    const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float2 x =
          *reinterpret_cast<const float2*>(X + i * LS + 2 * dc + 32 * c);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[r][2 * c] = fmaf(wv[r], x.x, acc[r][2 * c]);
        acc[r][2 * c + 1] = fmaf(wv[r], x.y, acc[r][2 * c + 1]);
      }
    }
  }
}

// rows 4 rr + r, columns 2 dc + 32 (c/2) + c%2 of acc * mul into a
// (B, S, NH, D) tensor at (b, p0, head), rows past S and columns past D
// dropped
template <typename T, int DP>
__device__ __forceinline__ void store_rows(T* __restrict__ dst,
                                           const float (&acc)[4][DP / 16],
                                           float mul, int b, int p0, int head,
                                           int S, int NH, int D, int rr,
                                           int dc) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int p = p0 + 4 * rr + r;
    if (p >= S) continue;
    T* row = dst + ((static_cast<size_t>(b) * S + p) * NH + head) * D;
#pragma unroll
    for (int c = 0; c < DP / 16; ++c) {
      const int d = 2 * dc + 32 * (c / 2) + (c % 2);
      if (d < D) row[d] = from_f<T>(acc[r][c] * mul);
    }
  }
}

template <int DP>
__host__ __device__ constexpr size_t tile_floats() {
  return static_cast<size_t>(kT) * (DP + 4);
}

// ---------------------------------------------------------------------------
// (a) log-sum-exp (base 2) and D_i of every query row
// ---------------------------------------------------------------------------

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
bwd_prepass_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ o, const T* __restrict__ dout,
                   float* __restrict__ lse2, float* __restrict__ dsum, int S,
                   int H, int KH, int D, float scale_log2) {
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + tile_floats<DP>();
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int kh = h / (H / KH);
  const int qt = blockIdx.y;
  const int q0 = qt * kT;
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const size_t row0 = static_cast<size_t>(bh) * S;

  // D_i: a warp a row, lanes over d
  {
    const int warp = tid >> 5, lane = tid & 31;
    for (int r = warp; r < kT; r += kThreads / 32) {
      const int p = q0 + r;
      if (p >= S) break;
      const size_t base = ((static_cast<size_t>(b) * S + p) * H + h) * D;
      float acc = 0.f;
      for (int d = lane; d < D; d += 32)
        acc = fmaf(to_f(dout[base + d]), to_f(o[base + d]), acc);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) dsum[row0 + p] = acc;
    }
  }

  load_tile<T, DP>(sQ, q, b, q0, h, S, H, D);
  float m[4], l[4];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    m[ii] = -INFINITY;
    l[ii] = 0.f;
  }
  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kT;
    __syncthreads();
    load_tile<T, DP>(sK, k, b, k0, kh, S, KH, D);
    __syncthreads();
    float s[4][4];
    rows_dot<DP>(s, sQ, sK, tr, tc);
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int qp = q0 + tr + 16 * ii;
      float tmax = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int kp = k0 + tc + 16 * jj;
        s[ii][jj] = (kp <= qp && kp < S) ? s[ii][jj] * scale_log2 : -INFINITY;
        tmax = fmaxf(tmax, s[ii][jj]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      // every row has a valid key in every tile it visits (key k0 <= its
      // position), so the new maximum is finite
      const float mn = fmaxf(m[ii], tmax);
      float psum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) psum += exp2f(s[ii][jj] - mn);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[ii] = l[ii] * exp2f(m[ii] - mn) + psum;
      m[ii] = mn;
    }
  }
  if (tc == 0) {
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int p = q0 + tr + 16 * ii;
      if (p < S) lse2[row0 + p] = m[ii] + log2f(l[ii]);
    }
  }
}

// S and dP of one (query tile, key tile) pair into P and dS:
// P = exp2(S*scale_log2 - lse2), dS = P (dP - D_i), zero where masked.
// Writes them at W[i][j] (kt_major false) or W[j][i] (true).
template <int DP>
__device__ __forceinline__ void probs_and_dscores(
    float* sP, float* sDS, const float* sQ, const float* sDO, const float* sK,
    const float* sV, const float* sLse, const float* sDsum, int q0, int k0,
    int S, float scale_log2, int tr, int tc, bool transposed) {
  float s[4][4], dp[4][4];
  rows_dot<DP>(s, sQ, sK, tr, tc);
  rows_dot<DP>(dp, sDO, sV, tr, tc);
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int i = tr + 16 * ii;
    const int qp = q0 + i;
    const float lse = sLse[i], di = sDsum[i];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = tc + 16 * jj;
      const int kp = k0 + j;
      float p = 0.f;
      if (kp <= qp && kp < S && qp < S) p = exp2f(s[ii][jj] * scale_log2 - lse);
      const float ds = p * (dp[ii][jj] - di);
      if (transposed) {
        if (sP) sP[j * kPS + i] = p;
        sDS[j * kPS + i] = ds;
      } else {
        sP[i * kPS + j] = p;
        sDS[i * kPS + j] = ds;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// (b) dK, dV of one key tile of one kv head
// ---------------------------------------------------------------------------

template <int DP>
constexpr size_t dkdv_smem_bytes() {
  return (4 * tile_floats<DP>() + 2 * static_cast<size_t>(kT) * kPS +
          2 * kT) * sizeof(float);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse2,
                const float* __restrict__ dsum, T* __restrict__ dk,
                T* __restrict__ dv, int S, int H, int KH, int D,
                float scale_log2, float scale) {
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + tile_floats<DP>();
  float* sQ = sV + tile_floats<DP>();
  float* sDO = sQ + tile_floats<DP>();
  float* sP = sDO + tile_floats<DP>();
  float* sDS = sP + kT * kPS;
  float* sLse = sDS + kT * kPS;
  float* sDsum = sLse + kT;
  const int bkh = blockIdx.x;
  const int b = bkh / KH, kh = bkh - b * KH;
  const int G = H / KH;
  const int kt = blockIdx.y;  // key tile 0, the longest loop, first
  const int k0 = kt * kT;
  const int n_qt = (S + kT - 1) / kT;
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;

  load_tile<T, DP>(sK, k, b, k0, kh, S, KH, D);
  load_tile<T, DP>(sV, v, b, k0, kh, S, KH, D);
  float adk[4][DP / 16], adv[4][DP / 16];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < DP / 16; ++c) adk[r][c] = adv[r][c] = 0.f;

  for (int qt = kt; qt < n_qt; ++qt) {
    const int q0 = qt * kT;
    for (int g = 0; g < G; ++g) {
      const int h = kh * G + g;
      __syncthreads();  // the previous pair's tiles are consumed
      load_tile<T, DP>(sQ, q, b, q0, h, S, H, D);
      load_tile<T, DP>(sDO, dout, b, q0, h, S, H, D);
      if (tid < kT) {
        const int p = q0 + tid;
        const size_t at = (static_cast<size_t>(b) * H + h) * S + p;
        sLse[tid] = p < S ? lse2[at] : 0.f;
        sDsum[tid] = p < S ? dsum[at] : 0.f;
      }
      __syncthreads();
      probs_and_dscores<DP>(sP, sDS, sQ, sDO, sK, sV, sLse, sDsum, q0, k0, S,
                            scale_log2, tr, tc, false);
      __syncthreads();
      cols_accum<DP>(adv, sP, sDO, tr, tc);
      cols_accum<DP>(adk, sDS, sQ, tr, tc);
    }
  }
  store_rows<T, DP>(dk, adk, scale, b, k0, kh, S, KH, D, tr, tc);
  store_rows<T, DP>(dv, adv, 1.f, b, k0, kh, S, KH, D, tr, tc);
}

// ---------------------------------------------------------------------------
// (c) dQ of one query tile of one head
// ---------------------------------------------------------------------------

template <int DP>
constexpr size_t dq_smem_bytes() {
  return (4 * tile_floats<DP>() + static_cast<size_t>(kT) * kPS + 2 * kT) *
         sizeof(float);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse2, const float* __restrict__ dsum,
              T* __restrict__ dq, int S, int H, int KH, int D,
              float scale_log2, float scale) {
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sDO = sQ + tile_floats<DP>();
  float* sK = sDO + tile_floats<DP>();
  float* sV = sK + tile_floats<DP>();
  float* sDST = sV + tile_floats<DP>();  // dS transposed: [key][row]
  float* sLse = sDST + kT * kPS;
  float* sDsum = sLse + kT;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int kh = h / (H / KH);
  const int n_qt = (S + kT - 1) / kT;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.y);  // longest first
  const int q0 = qt * kT;
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;

  load_tile<T, DP>(sQ, q, b, q0, h, S, H, D);
  load_tile<T, DP>(sDO, dout, b, q0, h, S, H, D);
  if (tid < kT) {
    const int p = q0 + tid;
    const size_t at = (static_cast<size_t>(b) * H + h) * S + p;
    sLse[tid] = p < S ? lse2[at] : 0.f;
    sDsum[tid] = p < S ? dsum[at] : 0.f;
  }
  float adq[4][DP / 16];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < DP / 16; ++c) adq[r][c] = 0.f;

  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kT;
    __syncthreads();  // the previous key tile is consumed
    load_tile<T, DP>(sK, k, b, k0, kh, S, KH, D);
    load_tile<T, DP>(sV, v, b, k0, kh, S, KH, D);
    __syncthreads();
    probs_and_dscores<DP>(nullptr, sDST, sQ, sDO, sK, sV, sLse, sDsum, q0, k0,
                          S, scale_log2, tr, tc, true);
    __syncthreads();
    cols_accum<DP>(adq, sDST, sK, tr, tc);
  }
  store_rows<T, DP>(dq, adq, scale, b, q0, h, S, H, D, tr, tc);
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, void* dq, void* dk, void* dv,
                   float* lse2, float* dsum, int B, int S, int H, int KH,
                   int D, cudaStream_t stream) {
  const double scale_d = 1.0 / std::sqrt(static_cast<double>(D));
  const float scale = static_cast<float>(scale_d);
  const float scale_log2 = static_cast<float>(scale_d * 1.4426950408889634);
  const int n_t = (S + kT - 1) / kT;
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* op = static_cast<const T*>(o);
  const T* dop = static_cast<const T*>(dout);

  const int pre_smem = static_cast<int>(2 * tile_floats<DP>() * sizeof(float));
  const int dkdv_smem = static_cast<int>(dkdv_smem_bytes<DP>());
  const int dq_smem = static_cast<int>(dq_smem_bytes<DP>());
  cudaError_t err = cudaFuncSetAttribute(
      bwd_prepass_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      pre_smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(bwd_dkdv_kernel<T, DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dkdv_smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(bwd_dq_kernel<T, DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dq_smem);
  if (err != cudaSuccess) return err;

  bwd_prepass_kernel<T, DP><<<dim3(B * H, n_t), kThreads, pre_smem, stream>>>(
      qp, kp, op, dop, lse2, dsum, S, H, KH, D, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dkdv_kernel<T, DP><<<dim3(B * KH, n_t), kThreads, dkdv_smem, stream>>>(
      qp, kp, vp, dop, lse2, dsum, static_cast<T*>(dk), static_cast<T*>(dv),
      S, H, KH, D, scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dq_kernel<T, DP><<<dim3(B * H, n_t), kThreads, dq_smem, stream>>>(
      qp, kp, vp, dop, lse2, dsum, static_cast<T*>(dq), S, H, KH, D,
      scale_log2, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dp(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, void* dq, void* dk,
                      void* dv, float* lse2, float* dsum, int B, int S, int H,
                      int KH, int D, cudaStream_t st) {
  if (D <= 64)
    return launch<T, 64>(q, k, v, o, dout, dq, dk, dv, lse2, dsum, B, S, H,
                         KH, D, st);
  if (D <= 96)
    return launch<T, 96>(q, k, v, o, dout, dq, dk, dv, lse2, dsum, B, S, H,
                         KH, D, st);
  return launch<T, 128>(q, k, v, o, dout, dq, dk, dv, lse2, dsum, B, S, H, KH,
                        D, st);
}

}  // namespace

// q, o, dout, dq: (B, S, H, D); k, v, dk, dv: (B, S, KH, D); float32 or
// bfloat16 (is_bf16), contiguous.  scratch: 2*B*H*S float32 (the rows'
// log-sum-exp and D_i), written and read by the call.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, void* dq, void* dk,
                                   void* dv, void* scratch, int B, int S,
                                   int H, int KH, int D, int is_bf16,
                                   void* stream) {
  if (B < 1 || S < 1 || KH < 1 || H % KH != 0 || H / KH > 64 || D < 1 ||
      D > 128 || static_cast<long long>(B) * H > (1ll << 31) - 1 ||
      (S + kT - 1) / kT > 65535 ||
      (is_bf16 && D != 64 && D != 80 && D != 128)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse2 = static_cast<float*>(scratch);
  float* dsum = lse2 + static_cast<size_t>(B) * H * S;
  cudaError_t err;
  if (is_bf16) {
    err = launch_dp<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, lse2, dsum,
                                   B, S, H, KH, D, st);
  } else {
    err = launch_dp<float>(q, k, v, o, dout, dq, dk, dv, lse2, dsum, B, S, H,
                           KH, D, st);
  }
  return static_cast<int>(err);
}
