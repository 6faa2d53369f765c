// Causal grouped-query attention, backward: dq, dk, dv from q, k, v, the
// forward's output o, its gradient do and the log-sum-exp of every row
// that the forward kept.
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
// The forward writes each row's log-sum-exp of its scaled scores in base 2
// (lse2, float32 (B, H, S)), so no kernel here recomputes the softmax's
// statistics: P = exp2(S * scale * log2 e - lse2) directly.  No atomics:
// every output element is summed by one CTA in a fixed order, so two calls
// give bitwise-equal gradients.  Three launches:
//
//   (a) bwd_dsum_bf16_kernel / bwd_dsum_kernel (float32): D_i = sum_d
//       do * o of every row, float32, into (B, H, S) scratch; bound by
//       reading o and do once.
//   (b) dK and dV, a CTA per (batch, kv head, key tile), heaviest tiles
//       (key tile 0, the most query rows) launched first;
//   (c) dQ, a CTA per query tile (of all G heads of a kv head on wgmma,
//       of one head on FMAs), longest key range first.
//
// bfloat16, (b) and (c) on wgmma, each CTA three warpgroups: two
// consumers and a producer whose one thread issues TMA loads into a ring
// guarded by full and empty mbarriers (setmaxnreg gives the consumers 240
// registers and leaves the producer 24).
//
// D of 64, 80 or 128, the dense models' training path.  The two consumers
// hold 64 rows each and take turns issuing their products (named barriers
// 1 and 2), so one's exponentials run while the other's products are on
// the tensor cores.  Both kernels keep a three-slot ring.
//   (b) bwd_dkdv_wgmma_kernel: 128 keys, 64 a consumer.  K and V of the
//       tile land once and stay in shared memory; the producer streams
//       (Q, dO) tiles of 64 positions of one head (every head of the
//       group, every query tile on or below the diagonal), and its warp's
//       32 lanes stage the tile's lse2 and D_i beside them.  A step: S^T
//       = K Q^T and dP^T = V dO^T (wgmma m64n64k16, both operands K-major
//       from shared memory); P^T = ex2(S^T * scale log2 e - lse2), the
//       causal mask on tiles that cross the diagonal only; dS^T = P^T
//       (dP^T - D_i); then dV += P^T dO and dK += dS^T Q, P^T and dS^T
//       from registers as bfloat16 A fragments, dO and Q read as they lie
//       through the transposed B operand (no tile is transposed in shared
//       memory).  At D = 64 step n's S^T and dP^T are issued together
//       with step n-1's dV and dK products, and P^T_n, dS^T_n are formed
//       while those run; at D = 80 and 128 dK and dV take 128 registers,
//       too few are left for a second step's scores (ptxas serialises
//       the wgmma, C7512), so a step's products run in turn.  dK and dV
//       stay in float32 registers and are written once, the scale folded
//       into dK.
//   (c) bwd_dq_wgmma_kernel: 128 packed rows (128/G positions x the G
//       heads of a kv head, the forward's packing), 64 a consumer; Q, dO
//       and the rows' lse2 and D_i stay resident, (K, V) tiles of 64 keys
//       up to the diagonal stream through the ring.  Step j: S_j = Q K^T
//       and dP_j = dO V^T (SS) issued with tile j-1's dQ += dS K (RS, K
//       as the transposed B operand), then dS_j in registers while that
//       runs.
//
// D = 192, MLA's 128 nope + 64 rope columns (three 128-byte-swizzled
// 64-column atoms a row, as the forward lays them out).  A 64 x 192
// float32 accumulator takes 96 registers a thread, so no consumer can
// hold both dK and dV, and the 128-key CTA's resident tiles (96 KB) and
// ring (144 KB) would pass the 227 KB a block may have.
//   (b) bwd_dkdv_split_kernel: a CTA per (batch, kv head, 64-key tile),
//       K and V of the 64 keys resident (48 KB), the (Q, dO) ring of
//       three 48 KB slots as in (b) above.  The consumers split by
//       output: warpgroup 0 forms S^T, P^T and dV += P^T dO; warpgroup 1
//       forms dP^T, dS^T = P^T (dP^T - D_i) with the P^T that warpgroup 0
//       hands it through a double buffer in shared memory (2 x 16 KB,
//       float32, guarded by full and empty mbarriers of 128 arrivals),
//       and dK += dS^T Q.  Each issues step n's score product with step
//       n-1's accumulation.  Registers: 96 + 32 + 16 (warpgroup 0), 96 +
//       32 + 32 + 16 (warpgroup 1), no spill; shared memory 232,024
//       bytes of 232,448.
//   (c) bwd_dq_wgmma_kernel<192>: as (c) above with a two-slot ring of
//       (K, V) (BwdShape::DQ_RING; the resident Q and dO take 96 KB;
//       197,672 bytes), and a tile's products in turn: S, dP, then dS,
//       then dQ += dS K, the two consumers taking turns.  Issued with the
//       next tile's S and dP, dQ's 96 registers beside S, dP and the dS
//       fragments spilled (ptxas: 8 bytes); in turn, none spills.
// The kernels read every column of v and dO: MLA's zero-padded v
// columns are computed as any others.
//
// Across (b) and (c) that is 7 products of the causal half against the
// bound's 5: dQ's own S and dP are the price of having no atomics.
//
// float32 (0 < D <= 192), for the card-against-host parity checks at
// 1e-4 (tensor cores in float32 would be TF32): (b) bwd_dkdv_kernel and
// (c) bwd_dq_kernel on FMAs, 256 threads on 64 x 64 tiles staged in
// shared memory; in the S-shaped products thread (tr, tc) = (tid/16,
// tid%16) owns rows tr + 16*ii and columns tc + 16*jj, so a warp's float4
// reads of K (row stride DP + 4 floats) hit distinct banks and its reads
// of Q are broadcasts.  dK/dV by (batch, kv head, 64-key tile) over the G
// heads; dQ by (batch, head, 64-row tile).  At DP = 192 the four tiles
// take 196 KB, so dK/dV's P and dS share one buffer in turn (218 KB in
// all).
//
// Positions past S (a ragged last tile, any S) and head columns past D
// (D = 80 runs padded: to two 64-column atoms on wgmma, to 96 on FMAs)
// are zero-filled and masked.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace repro_hopper;

// ---------------------------------------------------------------------------
// (a) D_i = sum_d do * o of every query row
// ---------------------------------------------------------------------------

constexpr int kDsumThreads = 256;

// row (b, p, h) of (B, S, H, D) is (b, h, p) of (B, H, S)
__device__ __forceinline__ void store_dsum(float* dsum, long long row,
                                           float acc, int S, int H) {
  const long long h = row % H, bp = row / H;
  const long long p = bp % S, b = bp / S;
  dsum[(b * H + h) * S + p] = acc;
}

// float32, any D: a warp a row
__global__ void __launch_bounds__(kDsumThreads)
bwd_dsum_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                float* __restrict__ dsum, int S, int H, int D,
                long long n_rows) {
  const long long row = static_cast<long long>(blockIdx.x) *
                            (kDsumThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const float* orow = o + row * D;
  const float* drow = dout + row * D;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(drow[d], orow[d], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) store_dsum(dsum, row, acc, S, H);
}

// bfloat16, D a multiple of 8: 8 lanes a row, 16-byte loads, 32 rows a
// block, so every load instruction of a warp reads four whole rows
__global__ void __launch_bounds__(kDsumThreads)
bwd_dsum_bf16_kernel(const __nv_bfloat16* __restrict__ o,
                     const __nv_bfloat16* __restrict__ dout,
                     float* __restrict__ dsum, int S, int H, int D,
                     long long n_rows) {
  const long long row = static_cast<long long>(blockIdx.x) *
                            (kDsumThreads / 8) + (threadIdx.x >> 3);
  const int sub = threadIdx.x & 7;
  float acc = 0.f;
  if (row < n_rows) {
    const uint4* orow = reinterpret_cast<const uint4*>(o + row * D);
    const uint4* drow = reinterpret_cast<const uint4*>(dout + row * D);
    for (int c = sub; c < D / 8; c += 8) {
      const uint4 ov = orow[c], dv = drow[c];
      const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
      const __nv_bfloat162* dp = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 of = __bfloat1622float2(op[e]);
        const float2 df = __bfloat1622float2(dp[e]);
        acc = fmaf(df.x, of.x, acc);
        acc = fmaf(df.y, of.y, acc);
      }
    }
  }
#pragma unroll
  for (int off = 4; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (sub == 0 && row < n_rows) store_dsum(dsum, row, acc, S, H);
}

// ---------------------------------------------------------------------------
// float32: FMAs on tiles staged in shared memory
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kT = 64;          // rows of a query tile = keys of a key tile
constexpr int kPS = kT + 4;     // row stride (floats) of the P / dS tiles

// Tile of kT positions x DP columns of a (B, S, NH, D) tensor at
// (b, p0, head) into shared memory (row stride DP + 4), zero-filled past S
// and past D: 16-byte loads where D is a multiple of 4 (every row then
// starts 16-byte aligned), else one element at a time.
template <int DP>
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
                                          int b, int p0, int head, int S,
                                          int NH, int D) {
  constexpr int LS = DP + 4;
  static_assert(DP % 4 == 0, "a row is whole 16-byte loads");
  if (D % 4 == 0) {
    for (int idx = threadIdx.x; idx < kT * DP / 4; idx += kThreads) {
      const int r = idx / (DP / 4), d = (idx - r * (DP / 4)) * 4;
      const int p = p0 + r;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (p < S && d < D)
        x = *reinterpret_cast<const float4*>(
            src + ((static_cast<size_t>(b) * S + p) * NH + head) * D + d);
      *reinterpret_cast<float4*>(dst + r * LS + d) = x;
    }
    return;
  }
  for (int idx = threadIdx.x; idx < kT * DP; idx += kThreads) {
    const int r = idx / DP, d = idx - r * DP;
    const int p = p0 + r;
    float x = 0.f;
    if (p < S && d < D)
      x = src[((static_cast<size_t>(b) * S + p) * NH + head) * D + d];
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
template <int DP>
__device__ __forceinline__ void store_rows(float* __restrict__ dst,
                                           const float (&acc)[4][DP / 16],
                                           float mul, int b, int p0, int head,
                                           int S, int NH, int D, int rr,
                                           int dc) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int p = p0 + 4 * rr + r;
    if (p >= S) continue;
    float* row = dst + ((static_cast<size_t>(b) * S + p) * NH + head) * D;
#pragma unroll
    for (int c = 0; c < DP / 16; ++c) {
      const int d = 2 * dc + 32 * (c / 2) + (c % 2);
      if (d < D) row[d] = acc[r][c] * mul;
    }
  }
}

template <int DP>
__host__ __device__ constexpr size_t tile_floats() {
  return static_cast<size_t>(kT) * (DP + 4);
}

// S and dP of one (query tile, key tile) pair into P and dS, in
// registers: P = exp2(S*scale_log2 - lse2), dS = P (dP - D_i), zero where
// masked; element (ii, jj) is query row tr + 16 ii, key tc + 16 jj.
template <int DP>
__device__ __forceinline__ void probs_and_dscores(
    float (&p)[4][4], float (&ds)[4][4], const float* sQ, const float* sDO,
    const float* sK, const float* sV, const float* sLse, const float* sDsum,
    int q0, int k0, int S, float scale_log2, int tr, int tc) {
  rows_dot<DP>(p, sQ, sK, tr, tc);
  rows_dot<DP>(ds, sDO, sV, tr, tc);
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int i = tr + 16 * ii;
    const int qp = q0 + i;
    const float lse = sLse[i], di = sDsum[i];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int kp = k0 + tc + 16 * jj;
      float pv = 0.f;
      if (kp <= qp && kp < S && qp < S)
        pv = exp2f(p[ii][jj] * scale_log2 - lse);
      ds[ii][jj] = pv * (ds[ii][jj] - di);
      p[ii][jj] = pv;
    }
  }
}

// x (as probs_and_dscores lays it out) at W[i][j], or W[j][i] when
// transposed, row stride kPS
__device__ __forceinline__ void put_tile(float* W, const float (&x)[4][4],
                                         int tr, int tc, bool transposed) {
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int i = tr + 16 * ii, j = tc + 16 * jj;
      W[transposed ? j * kPS + i : i * kPS + j] = x[ii][jj];
    }
}

// the tile's rows' lse2 and D_i into shared memory
__device__ __forceinline__ void load_row_stats(float* sLse, float* sDsum,
                                               const float* __restrict__ lse2,
                                               const float* __restrict__ dsum,
                                               int b, int h, int q0, int S,
                                               int H) {
  if (threadIdx.x < kT) {
    const int p = q0 + threadIdx.x;
    const size_t at = (static_cast<size_t>(b) * H + h) * S + p;
    sLse[threadIdx.x] = p < S ? lse2[at] : 0.f;
    sDsum[threadIdx.x] = p < S ? dsum[at] : 0.f;
  }
}

// Past D = 128 the four 64-row tiles take 196 KB at DP = 192, so P and
// dS share one buffer in turn: dV's product reads P, then dS is written
// over it for dK's.
template <int DP>
__host__ __device__ constexpr bool one_pds_buffer() {
  return DP > 128;
}

template <int DP>
constexpr size_t dkdv_smem_bytes() {
  return (4 * tile_floats<DP>() +
          (one_pds_buffer<DP>() ? 1 : 2) * static_cast<size_t>(kT) * kPS +
          2 * kT) * sizeof(float);
}

// dK, dV of one 64-key tile of one kv head, over the G heads
template <int DP>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse2,
                const float* __restrict__ dsum, float* __restrict__ dk,
                float* __restrict__ dv, int S, int H, int KH, int D,
                float scale_log2, float scale) {
  constexpr bool kOne = one_pds_buffer<DP>();
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + tile_floats<DP>();
  float* sQ = sV + tile_floats<DP>();
  float* sDO = sQ + tile_floats<DP>();
  float* sP = sDO + tile_floats<DP>();
  float* sDS = kOne ? sP : sP + kT * kPS;
  float* sLse = sDS + kT * kPS;
  float* sDsum = sLse + kT;
  const int bkh = blockIdx.x;
  const int b = bkh / KH, kh = bkh - b * KH;
  const int G = H / KH;
  const int kt = blockIdx.y;  // key tile 0, the longest loop, first
  const int k0 = kt * kT;
  const int n_qt = (S + kT - 1) / kT;
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;

  load_tile<DP>(sK, k, b, k0, kh, S, KH, D);
  load_tile<DP>(sV, v, b, k0, kh, S, KH, D);
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
      load_tile<DP>(sQ, q, b, q0, h, S, H, D);
      load_tile<DP>(sDO, dout, b, q0, h, S, H, D);
      load_row_stats(sLse, sDsum, lse2, dsum, b, h, q0, S, H);
      __syncthreads();
      float p[4][4], ds[4][4];
      probs_and_dscores<DP>(p, ds, sQ, sDO, sK, sV, sLse, sDsum, q0, k0, S,
                            scale_log2, tr, tc);
      put_tile(sP, p, tr, tc, false);
      if (!kOne) put_tile(sDS, ds, tr, tc, false);
      __syncthreads();
      cols_accum<DP>(adv, sP, sDO, tr, tc);
      if (kOne) {
        __syncthreads();  // P is read: dS takes its place
        put_tile(sDS, ds, tr, tc, false);
        __syncthreads();
      }
      cols_accum<DP>(adk, sDS, sQ, tr, tc);
    }
  }
  store_rows<DP>(dk, adk, scale, b, k0, kh, S, KH, D, tr, tc);
  store_rows<DP>(dv, adv, 1.f, b, k0, kh, S, KH, D, tr, tc);
}

template <int DP>
constexpr size_t dq_smem_bytes() {
  return (4 * tile_floats<DP>() + static_cast<size_t>(kT) * kPS + 2 * kT) *
         sizeof(float);
}

// dQ of one 64-row query tile of one head
template <int DP>
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse2, const float* __restrict__ dsum,
              float* __restrict__ dq, int S, int H, int KH, int D,
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

  load_tile<DP>(sQ, q, b, q0, h, S, H, D);
  load_tile<DP>(sDO, dout, b, q0, h, S, H, D);
  load_row_stats(sLse, sDsum, lse2, dsum, b, h, q0, S, H);
  float adq[4][DP / 16];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < DP / 16; ++c) adq[r][c] = 0.f;

  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kT;
    __syncthreads();  // the previous key tile is consumed
    load_tile<DP>(sK, k, b, k0, kh, S, KH, D);
    load_tile<DP>(sV, v, b, k0, kh, S, KH, D);
    __syncthreads();
    float p[4][4], ds[4][4];
    probs_and_dscores<DP>(p, ds, sQ, sDO, sK, sV, sLse, sDsum, q0, k0, S,
                          scale_log2, tr, tc);
    put_tile(sDST, ds, tr, tc, true);
    __syncthreads();
    cols_accum<DP>(adq, sDST, sK, tr, tc);
  }
  store_rows<DP>(dq, adq, scale, b, q0, h, S, H, D, tr, tc);
}

// (b) and (c) on float32 FMAs
template <int DP>
cudaError_t launch_fma(const float* q, const float* k, const float* v,
                       const float* dout, const float* lse2,
                       const float* dsum, float* dq, float* dk, float* dv,
                       int B, int S, int H, int KH, int D, float scale_log2,
                       float scale, cudaStream_t stream) {
  const int n_t = (S + kT - 1) / kT;
  const int dkdv_smem = static_cast<int>(dkdv_smem_bytes<DP>());
  const int dq_smem = static_cast<int>(dq_smem_bytes<DP>());
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dkdv_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      dkdv_smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(bwd_dq_kernel<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dq_smem);
  if (err != cudaSuccess) return err;
  bwd_dkdv_kernel<DP><<<dim3(B * KH, n_t), kThreads, dkdv_smem, stream>>>(
      q, k, v, dout, lse2, dsum, dk, dv, S, H, KH, D, scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dq_kernel<DP><<<dim3(B * H, n_t), kThreads, dq_smem, stream>>>(
      q, k, v, dout, lse2, dsum, dq, S, H, KH, D, scale_log2, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma fed by TMA
// ---------------------------------------------------------------------------

constexpr int kBwdThreads = 384;  // consumer warpgroups 0, 1; producer 2
constexpr int kKeys = 128;        // keys of a dK/dV CTA, 64 a consumer
constexpr int kPacked = 128;      // packed query rows of a dQ CTA
constexpr int kStep = 64;         // query positions (dK/dV), keys (dQ) a step
constexpr int kRing = 3;          // slots of the dK/dV kernels' ring
constexpr int kSmemMax = 232448;  // dynamic shared memory a block may have

template <int D>
struct BwdShape {
  static constexpr int NA = (D + 63) / 64;     // 64-column atoms of a row
  static constexpr int KD = D / 16;            // k-steps over the head dim
  static constexpr int ATOM_BIG = 128 * 128;   // one atom of 128 rows
  static constexpr int ATOM_STEP = kStep * 128;  // one atom of a step's rows
  static constexpr int BIG = NA * ATOM_BIG;    // a resident 128-row tile
  static constexpr int STEP = NA * ATOM_STEP;  // a streamed tile
  // past D = 128 a dK/dV CTA holds 64 keys and its two consumers split by
  // output (bwd_dkdv_split_kernel), handing P^T over in a double buffer
  static constexpr bool SPLIT = D > 128;
  // dK/dV: resident (K, V), the ring's (Q, dO) pairs and their lse2 and
  // D_i, (split) the P^T buffers, barriers: one for the resident pair, a
  // full and an empty a slot, (split) a full and an empty a P^T buffer
  static constexpr int DKDV_SMEM =
      1024 + 2 * (SPLIT ? STEP : BIG) + kRing * 2 * STEP +
      kRing * 2 * kStep * 4 + (SPLIT ? 2 * kStep * kStep * 4 : 0) +
      (1 + 2 * kRing + (SPLIT ? 4 : 0)) * 8;
  // dQ: resident (Q, dO), the ring's (K, V) pairs (at D = 192 the
  // resident pair's 96 KB leave room for two slots of 48 KB), barriers
  static constexpr int DQ_RING = D > 128 ? 2 : 3;
  static constexpr int DQ_SMEM =
      1024 + 2 * BIG + DQ_RING * 2 * STEP + (1 + 2 * DQ_RING) * 8;
  static_assert(DKDV_SMEM <= kSmemMax && DQ_SMEM <= kSmemMax,
                "shared memory of a block");
};

// The producer warp of a dK/dV CTA: (Q, dO) tiles of kStep positions of
// each head of the group, query tile after query tile from qt0, into the
// ring (lane 0 issues the TMA loads) with each tile's lse2 and D_i, which
// the warp's 32 lanes stage beside them; rows past S get lse2 = +inf, so
// their P is 0.
template <int D>
__device__ __forceinline__ void stream_q_do(
    const CUtensorMap* tm_q, const CUtensorMap* tm_do,
    const float* __restrict__ lse2, const float* __restrict__ dsum,
    uint8_t* Qs, uint8_t* DOs, float* lse_s, float* dsum_s, uint64_t* full,
    uint64_t* empty, int b, int kvh, int qt0, int n_steps, int S, int H,
    int G, int lane) {
  using W = BwdShape<D>;
  for (int n = 0; n < n_steps; ++n) {
    const int st = n % kRing, ph = (n / kRing) & 1;
    const int q0 = (qt0 + n / G) * kStep;
    const int h = kvh * G + n % G;
    mbar_wait(&empty[st], ph ^ 1);
    if (lane == 0) {
      mbar_expect_tx(&full[st], 2 * W::STEP);
#pragma unroll
      for (int a = 0; a < W::NA; ++a) {
        tma_load_4d(Qs + st * W::STEP + a * W::ATOM_STEP, tm_q, &full[st],
                    a * 64, h, q0, b);
        tma_load_4d(DOs + st * W::STEP + a * W::ATOM_STEP, tm_do, &full[st],
                    a * 64, h, q0, b);
      }
    }
    const size_t row0 = (static_cast<size_t>(b) * H + h) * S;
    for (int j = lane; j < kStep; j += 32) {
      const int p = q0 + j;
      lse_s[st * kStep + j] = p < S ? lse2[row0 + p] : INFINITY;
      dsum_s[st * kStep + j] = p < S ? dsum[row0 + p] : 0.f;
    }
    mbar_arrive(&full[st]);
  }
}

// s (64 x 64) = A (64 rows x D) . B (64 rows x D)^T: wgmma m64n64k16 over
// the head dim, both operands K-major in shared memory; a_atom and b_atom
// are the byte strides of their 64-column atoms
template <int D>
__device__ __forceinline__ void issue_scores(float (&s)[32],
                                             const uint8_t* a, int a_atom,
                                             const uint8_t* b, int b_atom) {
#pragma unroll
  for (int kk = 0; kk < BwdShape<D>::KD; ++kk)
    wgmma_ss_n64(s, sw128_desc(a + (kk >> 2) * a_atom + (kk & 3) * 32),
                 sw128_desc(b + (kk >> 2) * b_atom + (kk & 3) * 32), kk > 0);
}

// acc (64 x D) += F (64 x 64, A fragments in registers) . X (64 rows x D
// in shared memory, read as the transposed B operand), one product per
// 64-column atom and 16 rows of X
template <int NA>
__device__ __forceinline__ void issue_accum(float (&acc)[NA][32],
                                            const uint32_t (&f)[4][4],
                                            const uint8_t* x, int x_atom) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int a = 0; a < NA; ++a)
      wgmma_rs_n64(acc[a], f[kk], sw128_desc(x + a * x_atom + kk * 16 * 128));
}

// acc * mul as bfloat16 into row `row` (the lane's h-th of the wgmma
// layout) of a tensor whose rows are D long, columns past D dropped
template <int NA>
__device__ __forceinline__ void store_acc_row(__nv_bfloat16* row,
                                              const float (&acc)[NA][32],
                                              int h, int lane, int D,
                                              float mul) {
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = a * 64 + i * 8 + (lane & 3) * 2;
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(row + col) = __floats2bfloat162_rn(
            acc[a][4 * i + 2 * h] * mul, acc[a][4 * i + 2 * h + 1] * mul);
    }
}

template <int NA>
__device__ __forceinline__ void zero_acc(float (&acc)[NA][32]) {
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[a][i] = 0.f;
}

template <int NA>
__device__ __forceinline__ void fence_acc(float (&acc)[NA][32]) {
#pragma unroll
  for (int a = 0; a < NA; ++a) fence_regs(acc[a]);
}

// P^T = ex2(S^T * scale log2 e - lse2) of a dK/dV step, in place of S^T
// (s): the lane's keys key[0], key[1] (rows), query positions q0 + 8i +
// 2(lane%4) + e (columns), whose lse2 are ls[.]; zero where a key is past
// a position
__device__ __forceinline__ void dkdv_p(float (&s)[32], const float* ls,
                                       int q0, const int (&key)[2],
                                       int kbase, int lane,
                                       float scale_log2) {
  const bool masked = kbase + 63 > q0;  // some key past some row
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = 8 * i + 2 * (lane & 3);
    const float2 l2 = *reinterpret_cast<const float2*>(ls + c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int x = 4 * i + e;
      float p = ex2(fmaf(s[x], scale_log2, -((e & 1) ? l2.y : l2.x)));
      if (masked && key[e >> 1] > q0 + c + (e & 1)) p = 0.f;
      s[x] = p;
    }
  }
}

// dS^T = P^T (dP^T - D_i) of a dK/dV step, in place of dP^T (dp), the
// columns' D_i at dsm[.]
__device__ __forceinline__ void dkdv_ds(float (&dp)[32],
                                        const float (&p)[32],
                                        const float* dsm, int lane) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float2 d2 =
        *reinterpret_cast<const float2*>(dsm + 8 * i + 2 * (lane & 3));
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int x = 4 * i + e;
      dp[x] = p[x] * (dp[x] - ((e & 1) ? d2.y : d2.x));
    }
  }
}

// both, in place of S^T (s) and dP^T (dp)
__device__ __forceinline__ void dkdv_probs(float (&s)[32], float (&dp)[32],
                                           const float* ls, const float* dsm,
                                           int q0, const int (&key)[2],
                                           int kbase, int lane,
                                           float scale_log2) {
  dkdv_p(s, ls, q0, key, kbase, lane, scale_log2);
  dkdv_ds(dp, s, dsm, lane);
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_do,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const float* __restrict__ lse2,
                      const float* __restrict__ dsum,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int S, int H, int KH,
                      int G, float scale_log2, float scale) {
  using W = BwdShape<D>;
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte alignment: the period of the 128-byte swizzle
  uint8_t* Ks = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  uint8_t* Vs = Ks + W::BIG;
  uint8_t* Qs = Vs + W::BIG;           // kRing slots
  uint8_t* DOs = Qs + kRing * W::STEP;  // kRing slots
  float* lse_s = reinterpret_cast<float*>(DOs + kRing * W::STEP);
  static_assert(!W::SPLIT, "past D = 128: bwd_dkdv_split_kernel");
  float* dsum_s = lse_s + kRing * kStep;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(dsum_s + kRing * kStep);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kRing;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int b = blockIdx.x / KH, kvh = blockIdx.x - b * KH;
  const int k0 = blockIdx.y * kKeys;  // key tile 0, the most rows, first
  const int qt0 = k0 / kStep;         // the first query tile it sees
  const int n_steps = ((S + kStep - 1) / kStep - qt0) * G;
  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < kRing; ++st) {
      // the TMA thread's expect_tx, then the 32 lanes that stage lse2/D_i
      mbar_init(&full[st], 33);
      mbar_init(&empty[st], 8);  // lane 0 of each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // -------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid < 256 + 32) {
      const int lane = tid & 31;
      if (lane == 0) {
        tma_prefetch(&tm_q);
        tma_prefetch(&tm_do);
        mbar_expect_tx(kv_full, 2 * W::BIG);
#pragma unroll
        for (int a = 0; a < W::NA; ++a) {
          tma_load_4d(Ks + a * W::ATOM_BIG, &tm_k, kv_full, a * 64, kvh, k0,
                      b);
          tma_load_4d(Vs + a * W::ATOM_BIG, &tm_v, kv_full, a * 64, kvh, k0,
                      b);
        }
      }
      stream_q_do<D>(&tm_q, &tm_do, lse2, dsum, Qs, DOs, lse_s, dsum_s, full,
                     empty, b, kvh, qt0, n_steps, S, H, G, lane);
    }
  } else {
    // ------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int t = tid & 127, warp = t >> 5, lane = t & 31;
    // this lane's keys: rows h = 0, 1 of the wgmma layout
    const int kbase = k0 + wg * 64;
    int key[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      key[h] = kbase + warp * 16 + (lane >> 2) + 8 * h;
    float adk[W::NA][32], adv[W::NA][32];
    zero_acc(adk);
    zero_acc(adv);
    const uint8_t* krows = Ks + wg * 64 * 128;
    const uint8_t* vrows = Vs + wg * 64 * 128;
    const int bar_me = 1 + wg, bar_other = 2 - wg;
    // S^T (s) and dP^T (dp) of step n, then its P^T and dS^T: key rows,
    // query columns 8i + 2(lane%4) + e; pf, dsf: step n-1's P^T and dS^T
    // as the A fragments of dV and dK
    float s[32], dp[32];
    uint32_t pf[4][4], dsf[4][4];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    mbar_wait(kv_full, 0);
    if (wg == 1) named_arrive(1);  // warpgroup 0 issues first

    if constexpr (W::NA == 1) {
      // step 0: S^T and dP^T alone
      {
        mbar_wait(&full[0], 0);
        named_sync(bar_me);
        fence_regs(s);
        fence_regs(dp);
        wgmma_fence();
        issue_scores<D>(s, krows, W::ATOM_BIG, Qs, W::ATOM_STEP);
        issue_scores<D>(dp, vrows, W::ATOM_BIG, DOs, W::ATOM_STEP);
        wgmma_commit();
        named_arrive(bar_other);  // the other warpgroup's products next
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        dkdv_probs(s, dp, lse_s, dsum_s, qt0 * kStep, key, kbase, lane,
                   scale_log2);
        to_afrag<64>(pf, s);
        to_afrag<64>(dsf, dp);
      }
      // step n: S^T_n, dP^T_n and step n-1's dV, dK on the tensor cores,
      // then P^T_n and dS^T_n while dV, dK may still run
      for (int n = 1; n < n_steps; ++n) {
        const int st = n % kRing, ph = (n / kRing) & 1;
        const int pst = (n - 1) % kRing;  // step n-1's slot
        mbar_wait(&full[st], ph);
        named_sync(bar_me);
        fence_regs(s);
        fence_regs(dp);
        fence_acc(adk);
        fence_acc(adv);
        fence_regs(pf);
        fence_regs(dsf);
        wgmma_fence();
        issue_scores<D>(s, krows, W::ATOM_BIG, Qs + st * W::STEP, W::ATOM_STEP);
        issue_scores<D>(dp, vrows, W::ATOM_BIG, DOs + st * W::STEP,
                        W::ATOM_STEP);
        wgmma_commit();
        issue_accum<W::NA>(adv, pf, DOs + pst * W::STEP, W::ATOM_STEP);
        issue_accum<W::NA>(adk, dsf, Qs + pst * W::STEP, W::ATOM_STEP);
        wgmma_commit();
        named_arrive(bar_other);
        wgmma_wait<1>();  // S^T_n and dP^T_n done
        fence_regs(s);
        fence_regs(dp);
        dkdv_probs(s, dp, lse_s + st * kStep, dsum_s + st * kStep,
                   (qt0 + n / G) * kStep, key, kbase, lane, scale_log2);
        wgmma_wait<0>();  // step n-1's dV, dK done: free its slot
        fence_acc(adk);
        fence_acc(adv);
        fence_regs(pf);
        fence_regs(dsf);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[pst]);
        to_afrag<64>(pf, s);
        to_afrag<64>(dsf, dp);
      }
      // the last step's dV, dK
      {
        const int pst = (n_steps - 1) % kRing;
        named_sync(bar_me);
        fence_acc(adk);
        fence_acc(adv);
        fence_regs(pf);
        fence_regs(dsf);
        wgmma_fence();
        issue_accum<W::NA>(adv, pf, DOs + pst * W::STEP, W::ATOM_STEP);
        issue_accum<W::NA>(adk, dsf, Qs + pst * W::STEP, W::ATOM_STEP);
        wgmma_commit();
        // warpgroup 1 arrived once ahead of its first turn: its last turn
        // hands nothing on, so every arrival meets a wait
        if (wg == 0) named_arrive(bar_other);
        wgmma_wait<0>();
        fence_acc(adk);
        fence_acc(adv);
        fence_regs(pf);
        fence_regs(dsf);
      }
    } else {
      // two 64-column atoms: dK and dV take 128 registers, too many to
      // hold a second step's S^T and dP^T, so a step's products run one
      // after the other; the two warpgroups still take turns
      for (int n = 0; n < n_steps; ++n) {
        const int st = n % kRing, ph = (n / kRing) & 1;
        const uint8_t* qs = Qs + st * W::STEP;
        const uint8_t* dos = DOs + st * W::STEP;
        mbar_wait(&full[st], ph);
        named_sync(bar_me);
        fence_regs(s);
        fence_regs(dp);
        wgmma_fence();
        issue_scores<D>(s, krows, W::ATOM_BIG, qs, W::ATOM_STEP);
        issue_scores<D>(dp, vrows, W::ATOM_BIG, dos, W::ATOM_STEP);
        wgmma_commit();
        named_arrive(bar_other);
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        dkdv_probs(s, dp, lse_s + st * kStep, dsum_s + st * kStep,
                   (qt0 + n / G) * kStep, key, kbase, lane, scale_log2);
        to_afrag<64>(pf, s);
        to_afrag<64>(dsf, dp);
        named_sync(bar_me);
        fence_acc(adk);
        fence_acc(adv);
        fence_regs(pf);
        fence_regs(dsf);
        wgmma_fence();
        issue_accum<W::NA>(adv, pf, dos, W::ATOM_STEP);
        issue_accum<W::NA>(adk, dsf, qs, W::ATOM_STEP);
        wgmma_commit();
        // warpgroup 1 arrived once ahead of its first turn: its last
        // turn hands nothing on
        if (wg == 0 || n < n_steps - 1) named_arrive(bar_other);
        wgmma_wait<0>();
        fence_acc(adk);
        fence_acc(adv);
        fence_regs(pf);
        fence_regs(dsf);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[st]);
      }
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (key[h] >= S) continue;
      const size_t at = ((static_cast<size_t>(b) * S + key[h]) * KH + kvh) * D;
      store_acc_row(dk + at, adk, h, lane, D, scale);
      store_acc_row(dv + at, adv, h, lane, D, 1.f);
    }
  }
}

// One consumer warpgroup of bwd_dkdv_split_kernel over its n_steps
// steps.  kDV (warpgroup 0): scores S^T = res (K) . score tiles (Q)^T,
// then P^T, handed over, and acc (dV) += P^T . accum tiles (dO); else
// (warpgroup 1): dP^T = res (V) . score tiles (dO)^T, then dS^T with
// the P^T taken over, and acc (dK) += dS^T . accum tiles (Q).  stat_s is
// the ring's lse2 (kDV) or D_i.  Step n's score product is issued with
// step n-1's accumulation; step 0 and the last accumulation are peeled,
// so that no wgmma sits in conditional code.
template <int D, bool kDV>
__device__ __forceinline__ void split_consumer(
    float (&acc)[BwdShape<D>::NA][32], const uint8_t* res,
    const uint8_t* score_tiles, const uint8_t* accum_tiles,
    const float* stat_s, float* pbuf, uint64_t* full, uint64_t* empty,
    uint64_t* p_full, uint64_t* p_empty, int n_steps, int qt0, int G,
    const int (&key)[2], int k0, int t, int lane, float scale_log2) {
  using W = BwdShape<D>;
  constexpr int kPBuf = kStep * kStep;  // floats of a P^T buffer
  float s[32], p[32];
  uint32_t f[4][4];
  zero_acc(acc);
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  // warpgroup 1, while its product runs: take step n's P^T
  auto take = [&](int n) {
    if constexpr (!kDV) {
      const int buf = n & 1;
      mbar_wait(&p_full[buf], (n >> 1) & 1);
      const float* src = pbuf + buf * kPBuf + t;
#pragma unroll
      for (int x = 0; x < 32; ++x) p[x] = src[x * 128];
      mbar_arrive(&p_empty[buf]);
    }
  };
  // after step n's scores: P^T, handed over (thread t's value x at
  // [x][t]: a warp's 32 stores are 32 consecutive words), or dS^T
  auto finish = [&](int n, int st) {
    if constexpr (kDV) {
      dkdv_p(s, stat_s + st * kStep, (qt0 + n / G) * kStep, key, k0, lane,
             scale_log2);
      const int buf = n & 1;
      mbar_wait(&p_empty[buf], ((n >> 1) & 1) ^ 1);
      float* dst = pbuf + buf * kPBuf + t;
#pragma unroll
      for (int x = 0; x < 32; ++x) dst[x * 128] = s[x];
      mbar_arrive(&p_full[buf]);
    } else {
      dkdv_ds(s, p, stat_s + st * kStep, lane);
    }
  };

  // step 0: the score product alone
  mbar_wait(&full[0], 0);
  fence_regs(s);
  wgmma_fence();
  issue_scores<D>(s, res, W::ATOM_STEP, score_tiles, W::ATOM_STEP);
  wgmma_commit();
  take(0);
  wgmma_wait<0>();
  fence_regs(s);
  finish(0, 0);
  to_afrag<64>(f, s);
  for (int n = 1; n < n_steps; ++n) {
    const int st = n % kRing, ph = (n / kRing) & 1;
    const int pst = (n - 1) % kRing;  // step n-1's slot
    mbar_wait(&full[st], ph);
    fence_regs(s);
    fence_acc(acc);
    fence_regs(f);
    wgmma_fence();
    issue_scores<D>(s, res, W::ATOM_STEP, score_tiles + st * W::STEP,
                    W::ATOM_STEP);
    wgmma_commit();
    issue_accum<W::NA>(acc, f, accum_tiles + pst * W::STEP, W::ATOM_STEP);
    wgmma_commit();
    take(n);
    wgmma_wait<1>();  // step n's scores done
    fence_regs(s);
    finish(n, st);
    wgmma_wait<0>();  // step n-1's accumulation done: free its slot
    fence_acc(acc);
    fence_regs(f);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[pst]);
    to_afrag<64>(f, s);
  }
  // the last step's accumulation
  const int pst = (n_steps - 1) % kRing;
  fence_acc(acc);
  fence_regs(f);
  wgmma_fence();
  issue_accum<W::NA>(acc, f, accum_tiles + pst * W::STEP, W::ATOM_STEP);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc);
  fence_regs(f);
}

// dK/dV past D = 128 (MLA's 192): a CTA per (batch, kv head, 64-key tile),
// key tile 0 (the most query rows) first.  K and V of the 64 keys stay
// resident; the producer streams (Q, dO) tiles as bwd_dkdv_wgmma_kernel's
// does.  The consumers split by output, each holding one 64 x D
// accumulator (96 registers at D = 192):
//   warpgroup 0: S^T = K Q^T, P^T = ex2(S^T scale log2 e - lse2), hands P^T
//     to warpgroup 1 through a double buffer in shared memory (float32,
//     thread t's value x at [x][t], conflict-free), dV += P^T dO;
//   warpgroup 1: dP^T = V dO^T, dS^T = P^T (dP^T - D_i), dK += dS^T Q.
// Each issues step n's score product with step n-1's accumulation, as
// bwd_dkdv_wgmma_kernel does at D = 64.  A ring slot is freed when both
// warpgroups have read it (8 arrivals); a P^T buffer is full when
// warpgroup 0's 128 threads have written it and empty when warpgroup 1's
// 128 have read it.
template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
bwd_dkdv_split_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_do,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const float* __restrict__ lse2,
                      const float* __restrict__ dsum,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int S, int H, int KH,
                      int G, float scale_log2, float scale) {
  using W = BwdShape<D>;
  static_assert(W::SPLIT, "up to D = 128: bwd_dkdv_wgmma_kernel");
  constexpr int kPBuf = kStep * kStep;  // floats of a P^T buffer
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Ks = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  uint8_t* Vs = Ks + W::STEP;
  uint8_t* Qs = Vs + W::STEP;           // kRing slots
  uint8_t* DOs = Qs + kRing * W::STEP;  // kRing slots
  float* pbuf = reinterpret_cast<float*>(DOs + kRing * W::STEP);  // two
  float* lse_s = pbuf + 2 * kPBuf;
  float* dsum_s = lse_s + kRing * kStep;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(dsum_s + kRing * kStep);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kRing;
  uint64_t* p_full = empty + kRing;
  uint64_t* p_empty = p_full + 2;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int b = blockIdx.x / KH, kvh = blockIdx.x - b * KH;
  const int qt0 = blockIdx.y;  // key tile 0, the most rows, first
  const int k0 = qt0 * kStep;
  const int n_steps = ((S + kStep - 1) / kStep - qt0) * G;
  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < kRing; ++st) {
      mbar_init(&full[st], 33);  // the TMA thread and the 32 stagers
      mbar_init(&empty[st], 8);  // lane 0 of each consumer warp
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&p_full[i], 128);
      mbar_init(&p_empty[i], 128);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // -------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid < 256 + 32) {
      const int lane = tid & 31;
      if (lane == 0) {
        tma_prefetch(&tm_q);
        tma_prefetch(&tm_do);
        mbar_expect_tx(kv_full, 2 * W::STEP);
#pragma unroll
        for (int a = 0; a < W::NA; ++a) {
          tma_load_4d(Ks + a * W::ATOM_STEP, &tm_k, kv_full, a * 64, kvh, k0,
                      b);
          tma_load_4d(Vs + a * W::ATOM_STEP, &tm_v, kv_full, a * 64, kvh, k0,
                      b);
        }
      }
      stream_q_do<D>(&tm_q, &tm_do, lse2, dsum, Qs, DOs, lse_s, dsum_s, full,
                     empty, b, kvh, qt0, n_steps, S, H, G, lane);
    }
    return;
  }
  // --------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int t = tid & 127, warp = t >> 5, lane = t & 31;
  // this lane's keys: rows h = 0, 1 of the wgmma layout
  int key[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) key[h] = k0 + warp * 16 + (lane >> 2) + 8 * h;
  float acc[W::NA][32];  // dV (warpgroup 0) or dK (warpgroup 1)
  mbar_wait(kv_full, 0);
  if (wg == 0)
    split_consumer<D, true>(acc, Ks, Qs, DOs, lse_s, pbuf, full, empty,
                            p_full, p_empty, n_steps, qt0, G, key, k0, t,
                            lane, scale_log2);
  else
    split_consumer<D, false>(acc, Vs, DOs, Qs, dsum_s, pbuf, full, empty,
                             p_full, p_empty, n_steps, qt0, G, key, k0, t,
                             lane, scale_log2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (key[h] >= S) continue;
    const size_t at = ((static_cast<size_t>(b) * S + key[h]) * KH + kvh) * D;
    store_acc_row(wg == 0 ? dv + at : dk + at, acc, h, lane, D,
                  wg == 0 ? 1.f : scale);
  }
}

// dS = P (dP - D_i), P = ex2(S * scale log2 e - lse2), of a dQ step, in
// place of dP (dp): the lane's rows at positions row_pos[0], row_pos[1]
// (-1: an idle row), keys k0 + 8i + 2(lane%4) + e (columns); zero where a
// key is past a position
__device__ __forceinline__ void dq_dscores(const float (&s)[32],
                                           float (&dp)[32], int k0, int q0,
                                           const int (&row_pos)[2],
                                           const float (&lse_r)[2],
                                           const float (&di_r)[2], int lane,
                                           float scale_log2) {
  const bool masked = k0 + kStep - 1 > q0;  // some key past some row
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int x = 4 * i + e, h = e >> 1;
      const int key = k0 + 8 * i + 2 * (lane & 3) + (e & 1);
      float p = ex2(fmaf(s[x], scale_log2, -lse_r[h]));
      if (masked && key > row_pos[h]) p = 0.f;
      dp[x] = p * (dp[x] - di_r[h]);
    }
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_do,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const float* __restrict__ lse2,
                    const float* __restrict__ dsum,
                    __nv_bfloat16* __restrict__ dq, int S, int H, int KH,
                    int G, int BQ, float scale_log2, float scale) {
  using W = BwdShape<D>;
  constexpr int kR = W::DQ_RING;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  uint8_t* DOs = Qs + W::BIG;
  uint8_t* Ks = DOs + W::BIG;       // kR slots
  uint8_t* Vs = Ks + kR * W::STEP;  // kR slots
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + kR * W::STEP);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kR;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int b = blockIdx.x / KH, kvh = blockIdx.x - b * KH;
  const int n_qt = (S + BQ - 1) / BQ;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.y);  // longest first
  const int q0 = qt * BQ;
  const int R = BQ * G;  // packed rows: position q0 + r/G, head kvh*G + r%G
  const int n_kt = (min(q0 + BQ, S) - 1) / kStep + 1;  // up to the diagonal
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kR; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // -------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 256) {
      tma_prefetch(&tm_k);
      tma_prefetch(&tm_v);
      // one box of G heads x BQ positions lands as the packed rows
      mbar_expect_tx(q_full, 2 * W::NA * R * 128);
#pragma unroll
      for (int a = 0; a < W::NA; ++a) {
        tma_load_4d(Qs + a * W::ATOM_BIG, &tm_q, q_full, a * 64, kvh * G, q0,
                    b);
        tma_load_4d(DOs + a * W::ATOM_BIG, &tm_do, q_full, a * 64, kvh * G,
                    q0, b);
      }
      for (int j = 0; j < n_kt; ++j) {
        const int st = j % kR, ph = (j / kR) & 1;
        mbar_wait(&empty[st], ph ^ 1);
        mbar_expect_tx(&full[st], 2 * W::STEP);
#pragma unroll
        for (int a = 0; a < W::NA; ++a) {
          tma_load_4d(Ks + st * W::STEP + a * W::ATOM_STEP, &tm_k, &full[st],
                      a * 64, kvh, j * kStep, b);
          tma_load_4d(Vs + st * W::STEP + a * W::ATOM_STEP, &tm_v, &full[st],
                      a * 64, kvh, j * kStep, b);
        }
      }
    }
  } else {
    // ------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int t = tid & 127, warp = t >> 5, lane = t & 31;
    // this lane's rows r and r + 8 of its warp's 16; rows past R or S are
    // computed on whatever the buffers hold there and never written
    int row_pos[2], head[2];
    float lse_r[2], di_r[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wg * 64 + warp * 16 + (lane >> 2) + 8 * h;
      const int pos = q0 + r / G;
      const bool valid = r < R && pos < S;
      row_pos[h] = valid ? pos : -1;
      head[h] = kvh * G + r % G;
      const size_t at = (static_cast<size_t>(b) * H + head[h]) * S + pos;
      lse_r[h] = valid ? lse2[at] : INFINITY;
      di_r[h] = valid ? dsum[at] : 0.f;
    }
    float adq[W::NA][32];
    zero_acc(adq);
    const uint8_t* qrows = Qs + wg * 64 * 128;
    const uint8_t* dorows = DOs + wg * 64 * 128;
    const int bar_me = 1 + wg, bar_other = 2 - wg;
    // S (s) and dP (dp) of key tile j, then its dS: query rows, key
    // columns 8i + 2(lane%4) + e; dsf: tile j-1's dS as dQ's A fragments
    float s[32], dp[32];
    uint32_t dsf[4][4];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    mbar_wait(q_full, 0);
    if (wg == 1) named_arrive(1);  // warpgroup 0 issues first

    if constexpr (W::NA < 3) {
      // key tile 0: S and dP alone
      {
        mbar_wait(&full[0], 0);
        named_sync(bar_me);
        fence_regs(s);
        fence_regs(dp);
        wgmma_fence();
        issue_scores<D>(s, qrows, W::ATOM_BIG, Ks, W::ATOM_STEP);
        issue_scores<D>(dp, dorows, W::ATOM_BIG, Vs, W::ATOM_STEP);
        wgmma_commit();
        named_arrive(bar_other);
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        dq_dscores(s, dp, 0, q0, row_pos, lse_r, di_r, lane, scale_log2);
        to_afrag<64>(dsf, dp);
      }
      // key tile j: S_j, dP_j and tile j-1's dQ product on the tensor
      // cores, then dS_j while the dQ product may still run
      for (int j = 1; j < n_kt; ++j) {
        const int st = j % kR, ph = (j / kR) & 1;
        const int pst = (j - 1) % kR;  // tile j-1's slot
        mbar_wait(&full[st], ph);
        named_sync(bar_me);
        fence_regs(s);
        fence_regs(dp);
        fence_acc(adq);
        fence_regs(dsf);
        wgmma_fence();
        issue_scores<D>(s, qrows, W::ATOM_BIG, Ks + st * W::STEP, W::ATOM_STEP);
        issue_scores<D>(dp, dorows, W::ATOM_BIG, Vs + st * W::STEP,
                        W::ATOM_STEP);
        wgmma_commit();
        issue_accum<W::NA>(adq, dsf, Ks + pst * W::STEP, W::ATOM_STEP);
        wgmma_commit();
        named_arrive(bar_other);
        wgmma_wait<1>();  // S_j and dP_j done
        fence_regs(s);
        fence_regs(dp);
        dq_dscores(s, dp, j * kStep, q0, row_pos, lse_r, di_r, lane,
                   scale_log2);
        wgmma_wait<0>();  // tile j-1's dQ product done: free its slot
        fence_acc(adq);
        fence_regs(dsf);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[pst]);
        to_afrag<64>(dsf, dp);
      }
      // the last tile's dQ product
      {
        const int pst = (n_kt - 1) % kR;
        named_sync(bar_me);
        fence_acc(adq);
        fence_regs(dsf);
        wgmma_fence();
        issue_accum<W::NA>(adq, dsf, Ks + pst * W::STEP, W::ATOM_STEP);
        wgmma_commit();
        if (wg == 0) named_arrive(bar_other);  // see bwd_dkdv_wgmma_kernel
        wgmma_wait<0>();
        fence_acc(adq);
        fence_regs(dsf);
      }
    } else {
      // three 64-column atoms: dQ takes 96 registers, too many to hold
      // tile j's S and dP beside tile j-1's dS fragments (ptxas spills),
      // so a tile's products run one after the other; the two warpgroups
      // still take turns
      for (int j = 0; j < n_kt; ++j) {
        const int st = j % kR, ph = (j / kR) & 1;
        const uint8_t* ks = Ks + st * W::STEP;
        mbar_wait(&full[st], ph);
        named_sync(bar_me);
        fence_regs(s);
        fence_regs(dp);
        wgmma_fence();
        issue_scores<D>(s, qrows, W::ATOM_BIG, ks, W::ATOM_STEP);
        issue_scores<D>(dp, dorows, W::ATOM_BIG, Vs + st * W::STEP,
                        W::ATOM_STEP);
        wgmma_commit();
        named_arrive(bar_other);
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        dq_dscores(s, dp, j * kStep, q0, row_pos, lse_r, di_r, lane,
                   scale_log2);
        to_afrag<64>(dsf, dp);
        named_sync(bar_me);
        fence_acc(adq);
        fence_regs(dsf);
        wgmma_fence();
        issue_accum<W::NA>(adq, dsf, ks, W::ATOM_STEP);
        wgmma_commit();
        // warpgroup 1 arrived once ahead of its first turn: its last turn
        // hands nothing on
        if (wg == 0 || j < n_kt - 1) named_arrive(bar_other);
        wgmma_wait<0>();
        fence_acc(adq);
        fence_regs(dsf);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[st]);
      }
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (row_pos[h] < 0) continue;
      store_acc_row(
          dq + ((static_cast<size_t>(b) * S + row_pos[h]) * H + head[h]) * D,
          adq, h, lane, D, scale);
    }
  }
}

// the dK/dV kernel at head dim D (both take the same arguments)
template <int D>
auto dkdv_kernel() {
  if constexpr (BwdShape<D>::SPLIT)
    return bwd_dkdv_split_kernel<D>;
  else
    return bwd_dkdv_wgmma_kernel<D>;
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse2,
                         const float* dsum, void* dq, void* dk, void* dv,
                         int B, int S, int H, int KH, float scale_log2,
                         float scale, cudaStream_t stream) {
  using W = BwdShape<D>;
  const int G = H / KH;
  const int BQ = kPacked / G;
  // dK/dV: (Q, dO) boxes of kStep positions of one head, (K, V) of the
  // CTA's keys (128, or 64 when split); dQ: (Q, dO) boxes of G heads x BQ
  // positions (the packed rows), (K, V) of kStep keys
  constexpr int kRes = W::SPLIT ? kStep : kKeys;
  CUtensorMap q1, do1, kres, vres, qp, dop, k64, v64;
  if (!rows_map(&q1, q, 2, B, S, S, H, D, kStep) ||
      !rows_map(&do1, dout, 2, B, S, S, H, D, kStep) ||
      !rows_map(&kres, k, 2, B, S, S, KH, D, kRes) ||
      !rows_map(&vres, v, 2, B, S, S, KH, D, kRes) ||
      !rows_map(&qp, q, 2, B, S, S, H, D, BQ, G) ||
      !rows_map(&dop, dout, 2, B, S, S, H, D, BQ, G) ||
      !rows_map(&k64, k, 2, B, S, S, KH, D, kStep) ||
      !rows_map(&v64, v, 2, B, S, S, KH, D, kStep))
    return cudaErrorNotSupported;
  const auto dkdv = dkdv_kernel<D>();
  cudaError_t err = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, W::DKDV_SMEM);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(bwd_dq_wgmma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             W::DQ_SMEM);
  if (err != cudaSuccess) return err;
  dkdv<<<dim3(B * KH, (S + kRes - 1) / kRes), kBwdThreads, W::DKDV_SMEM,
         stream>>>(q1, do1, kres, vres, lse2, dsum,
                   static_cast<__nv_bfloat16*>(dk),
                   static_cast<__nv_bfloat16*>(dv), S, H, KH, G, scale_log2,
                   scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dq_wgmma_kernel<D>
      <<<dim3(B * KH, (S + BQ - 1) / BQ), kBwdThreads, W::DQ_SMEM, stream>>>(
          qp, dop, k64, v64, lse2, dsum, static_cast<__nv_bfloat16*>(dq), S,
          H, KH, G, BQ, scale_log2, scale);
  return cudaGetLastError();
}

}  // namespace

// q, o, dout, dq: (B, S, H, D); k, v, dk, dv: (B, S, KH, D); float32 or
// bfloat16 (is_bf16: D of 64, 80, 128 or 192), contiguous and 16-byte
// aligned.  bfloat16 runs on wgmma, float32 on FMAs: nothing falls back.
// lse2: float32 (B, H, S), each row's log-sum-exp of its scaled scores in
// base 2, as the forward writes it.  scratch: B*H*S float32 (the rows'
// D_i), written and read by the call.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse2,
                                   void* dq, void* dk, void* dv,
                                   void* scratch, int B, int S, int H,
                                   int KH, int D, int is_bf16,
                                   void* stream) {
  if (B < 1 || S < 1 || KH < 1 || H < KH || H % KH != 0 || H / KH > 64 ||
      D < 1 || D > 192 || static_cast<long long>(B) * H > (1ll << 31) - 1 ||
      (S + kT - 1) / kT > 65535 ||
      (is_bf16 && (D != 64 && D != 80 && D != 128 && D != 192)) ||
      (is_bf16 &&
       (S + kPacked / (H / KH) - 1) / (kPacked / (H / KH)) > 65535)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l2 = static_cast<const float*>(lse2);
  float* dsum = static_cast<float*>(scratch);
  const double scale_d = 1.0 / std::sqrt(static_cast<double>(D));
  const float scale = static_cast<float>(scale_d);
  const float scale_log2 = static_cast<float>(scale_d * 1.4426950408889634);
  const long long n_rows = static_cast<long long>(B) * S * H;
  const int rows_a_block = kDsumThreads / (is_bf16 ? 8 : 32);
  const long long n_blocks = (n_rows + rows_a_block - 1) / rows_a_block;
  if (n_blocks > (1ll << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 dsum_grid(static_cast<unsigned>(n_blocks));
  if (is_bf16) {
    bwd_dsum_bf16_kernel<<<dsum_grid, kDsumThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(o),
        static_cast<const __nv_bfloat16*>(dout), dsum, S, H, D, n_rows);
  } else {
    bwd_dsum_kernel<<<dsum_grid, kDsumThreads, 0, st>>>(
        static_cast<const float*>(o), static_cast<const float*>(dout), dsum,
        S, H, D, n_rows);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (is_bf16) {
    if (D == 64)
      err = launch_wgmma<64>(q, k, v, dout, l2, dsum, dq, dk, dv, B, S, H, KH,
                             scale_log2, scale, st);
    else if (D == 80)
      err = launch_wgmma<80>(q, k, v, dout, l2, dsum, dq, dk, dv, B, S, H, KH,
                             scale_log2, scale, st);
    else if (D == 128)
      err = launch_wgmma<128>(q, k, v, dout, l2, dsum, dq, dk, dv, B, S, H,
                              KH, scale_log2, scale, st);
    else
      err = launch_wgmma<192>(q, k, v, dout, l2, dsum, dq, dk, dv, B, S, H,
                              KH, scale_log2, scale, st);
    return static_cast<int>(err);
  }
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* df = static_cast<const float*>(dout);
  float* dqf = static_cast<float*>(dq);
  float* dkf = static_cast<float*>(dk);
  float* dvf = static_cast<float*>(dv);
  if (D <= 64)
    err = launch_fma<64>(qf, kf, vf, df, l2, dsum, dqf, dkf, dvf, B, S, H,
                         KH, D, scale_log2, scale, st);
  else if (D <= 96)
    err = launch_fma<96>(qf, kf, vf, df, l2, dsum, dqf, dkf, dvf, B, S, H,
                         KH, D, scale_log2, scale, st);
  else if (D <= 128)
    err = launch_fma<128>(qf, kf, vf, df, l2, dsum, dqf, dkf, dvf, B, S, H,
                          KH, D, scale_log2, scale, st);
  else
    err = launch_fma<192>(qf, kf, vf, df, l2, dsum, dqf, dkf, dvf, B, S, H,
                          KH, D, scale_log2, scale, st);
  return static_cast<int>(err);
}
