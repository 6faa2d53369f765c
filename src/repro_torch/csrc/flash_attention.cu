// Causal grouped-query flash attention, forward.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:69
// flash_attention (_flash_kernel, :29): grid (batch, kv head, q block,
// kv block) with the online-softmax state carried in VMEM scratch across
// the sequential kv-block axis.  Plain version: repro_torch/kernels/
// flash_attention/ref.py attention_ref.  q and k have D columns, v and o
// Dv <= D of their own (MLA: D = 192, Dv = 128; the JAX package pads v to
// D with zeros and slices the output back, which gives the same values).
//
// Bound on an H100: operations.  2*(D+Dv)*S(S+1)/2 per head against
// 2*(D+Dv)*S*2 bytes of q, k, v and o: at S=256, D=Dv=64 about 128
// operations a byte in bfloat16 and 64 in float32, so the card's
// multipliers, not its memory, set the least time once S is past a few
// hundred.  In bfloat16 at D = 64
// the exponentials weigh as much as the products: a score costs 2*2*64 =
// 256 tensor-core operations (at 989e12/s) and one exponential on the
// special-function units (16 a clock per SM, about 4.2e12/s on 132 SMs),
// so both take about 0.13 ms at B=2, S=4096, 32 heads, and a kernel that
// runs the softmax and the products one after the other cannot get below
// their sum.
//
// Design: CTAs run in parallel and in no order, so the TPU's sequential
// kv-block axis becomes a loop inside the CTA, and tiles wholly above the
// diagonal are never loaded.  A CTA holds the rows of all G query heads
// that share its kv head, the JAX kernel's (bq*G, D) packing, so every
// K/V tile read from device memory serves G heads.
//
// bfloat16 (D = Dv of 64, 80 or 128, every dense model of the repo; D =
// 192 with Dv = 128, MLA's prefill: 128 nope + 64 rope columns; and D =
// Dv = 192), the serving path: flash_fwd_wgmma_kernel below.  Work items
// of 128 packed rows, taken by one persistent CTA an SM, longest key range
// first; two consumer warpgroups on wgmma and one TMA producer thread
// feeding one or two Q buffers, a two-slot K ring and a two-slot V ring
// through mbarriers, so the next item's loads overlap this item's
// products; each consumer runs tile j's softmax while its own P.V of tile
// j-1 and the other consumer's products are on the tensor cores (the two
// take turns on named barriers), with the scale folded into one FMA and
// ex2.approx per score.
//
// For training both kernels can keep each row's log-sum-exp of its
// scaled scores in base 2 (lse2, float32 (B, H, S): m * scale * log2 e +
// log2 l from the running max m and denominator l of the epilogue), which
// the backward (flash_attention_bwd.cu) reads instead of recomputing the
// softmax's statistics.  The store is skipped when lse2 is null (serving,
// prefill), and it changes nothing else: the output is the same either way.
//
// The wgmma helpers (fence/commit/wait, the 128-byte-swizzle descriptor,
// the SS and RS products) are shared with the backward in hopper.cuh.
//
// float32 (0 < Dv <= D <= 192), for the card-against-host parity checks:
// flash_fwd_kernel, 64 rows (kRows = 64: BQ = 64/G) x 64-key tiles staged
// in shared memory as float32; 128 threads form 16 row groups of 4 rows x
// 8 column groups, each thread computes a 4x8 block of scores from
// conflict-free float4 reads, the row max and sum are reduced with warp
// shuffles over the 8 threads of a row group, and the probabilities go
// through shared memory (one warp writes and reads its own rows) into a
// 4 x (DVP/8) slice of the output accumulator.  Positions past S (a
// ragged last tile, any S) and head columns past D or Dv (D = 80 runs
// padded to 96) are zero-filled and masked.  Products are plain float32
// FMAs, so float32 inputs keep float32 accuracy.  At D = Dv = 192 (DP =
// DVP = 192) the tiles take 166,912 bytes of shared memory and a thread
// holds 4 x 24 output columns; at MLA's Dv = 128 (DVP = 128) 150,528
// bytes and 4 x 16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace repro_hopper;

constexpr int kThreads = 128;  // 16 row groups x 8 column groups
constexpr int kRows = 64;      // query rows (position, head) of a CTA
constexpr int kBK = 64;        // keys of a tile
constexpr float kNegInf = -1e30f;

// DP: q's and k's columns padded (D <= DP), DVP: v's and o's (Dv <= DVP)
template <int DP, int DVP>
constexpr size_t smem_floats() {
  return static_cast<size_t>(kRows) * (DP + 4) +  // Q
         static_cast<size_t>(kBK) * (DP + 4) +    // K
         static_cast<size_t>(kBK) * DVP +         // V
         static_cast<size_t>(kRows) * (kBK + 4);  // P
}

template <int DP, int DVP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse2, int S, int Sk, int q_start,
                 int H, int KH, int D, int Dv, int G, int BQ, float scale,
                 bool bf16s) {
  constexpr int QS = DP + 4;  // row strides (floats): 16-byte aligned rows
  constexpr int KS = DP + 4;  // whose float4 reads hit distinct banks
  constexpr int VS = DVP;
  constexpr int PS = kBK + 4;
  constexpr int CPT = DVP / 32;  // float4 output chunks per thread and row
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kRows * QS;
  float* Vs = Ks + kBK * KS;
  float* Ps = Vs + kBK * VS;

  const int tid = threadIdx.x;
  const int rg = tid >> 3;
  const int cg = tid & 7;
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest key range first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * BQ;
  const int R = BQ * G;

  // row r of the CTA is query row q0 + r / G (key position q_start +
  // q0 + r / G) of head kvh*G + r % G; the G heads of one position are
  // contiguous in q and o.  With bf16s q, k and v are rounded to bfloat16
  // as they land, as the JAX package casts them for bfloat16 scores
  for (int idx = tid; idx < kRows * DP; idx += kThreads) {
    const int r = idx / DP, d = idx - (idx / DP) * DP;
    const int pos = q0 + r / G;
    float val = 0.f;
    if (r < R && pos < S && d < D) {
      val = q[((static_cast<size_t>(b) * S + pos) * H + kvh * G) * D +
              static_cast<size_t>(r % G) * D + d];
      if (bf16s) val = bf16_round(val);
    }
    Qs[r * QS + d] = val;
  }

  int row_pos[4];  // the row's key position, -1: past R or S, not written
  float m[4], l[4], acc[4][CPT * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg * 4 + i;
    const int pos = q0 + r / G;
    row_pos[i] = (r < R && pos < S) ? q_start + pos : -1;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT * 4; ++c) acc[i][c] = 0.f;
  }

  // the CTA's last key position; tiles above the diagonal skipped
  const int last = q_start + min(q0 + BQ, S) - 1;
  const int n_tiles = last / kBK + 1;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's K/V are no longer read
    for (int idx = tid; idx < kBK * DP; idx += kThreads) {
      const int key = idx / DP, d = idx - (idx / DP) * DP;
      float kval = 0.f;
      if (k0 + key < Sk && d < D)
        kval = k[((static_cast<size_t>(b) * Sk + k0 + key) * KH + kvh) * D +
                 d];
      Ks[key * KS + d] = bf16s ? bf16_round(kval) : kval;
    }
    for (int idx = tid; idx < kBK * DVP; idx += kThreads) {
      const int key = idx / DVP, d = idx - (idx / DVP) * DVP;
      float vval = 0.f;
      if (k0 + key < Sk && d < Dv)
        vval = v[((static_cast<size_t>(b) * Sk + k0 + key) * KH + kvh) * Dv +
                 d];
      Vs[key * VS + d] = bf16s ? bf16_round(vval) : vval;
    }
    __syncthreads();

    // scores of rows rg*4+i against keys k0 + cg + 8*j
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; d += 4) {
      float4 qa[4], kb[8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(&Qs[(rg * 4 + i) * QS + d]);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        kb[j] = *reinterpret_cast<const float4*>(&Ks[(cg + 8 * j) * KS + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = fmaf(qa[i].x, kb[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, kb[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, kb[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, kb[j].w, s[i][j]);
        }
    }

    // online softmax, one row at a time; the 8 threads of a row group are
    // 8 neighbouring lanes of one warp.  bf16s: the scores and the
    // weights rounded to bfloat16 as the JAX package rounds them, the
    // running max, the denominator and O still in float32
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = bf16s ? bf16_score(s[i][j], scale) : s[i][j] * scale;
        if (k0 + cg + 8 * j <= row_pos[i]) mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float p =
            (k0 + cg + 8 * j <= row_pos[i]) ? expf(s[i][j] - m_new) : 0.f;
        if (bf16s) p = bf16_round(p);
        Ps[(rg * 4 + i) * PS + cg + 8 * j] = p;
        rs += p;
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      if (bf16s) rs = bf16_round(rs);  // the tile's sum, as JAX's chunk's
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT * 4; ++c) acc[i][c] *= corr;
    }
    __syncwarp();  // a row group's probabilities are read by its own warp

    // acc[i][c*4 + e] += P[row][key] * V[key][c*32 + cg*4 + e]
#pragma unroll 2
    for (int key = 0; key < kBK; key += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(&Ps[(rg * 4 + i) * PS + key]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const float4 vb = *reinterpret_cast<const float4*>(
              &Vs[(key + kk) * VS + c * 32 + cg * 4]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = kk == 0 ? pa[i].x
                            : kk == 1 ? pa[i].y
                            : kk == 2 ? pa[i].z
                                      : pa[i].w;
            acc[i][c * 4 + 0] = fmaf(p, vb.x, acc[i][c * 4 + 0]);
            acc[i][c * 4 + 1] = fmaf(p, vb.y, acc[i][c * 4 + 1]);
            acc[i][c * 4 + 2] = fmaf(p, vb.z, acc[i][c * 4 + 2]);
            acc[i][c * 4 + 3] = fmaf(p, vb.w, acc[i][c * 4 + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (row_pos[i] < 0) continue;
    const int r = rg * 4 + i;
    const int row = row_pos[i] - q_start;
    const float den = fmaxf(l[i], 1e-30f);
    float* orow =
        o + ((static_cast<size_t>(b) * S + row) * H + kvh * G) * Dv +
        static_cast<size_t>(r % G) * Dv;
    // the row's log-sum-exp of its scaled scores, in base 2, for the
    // backward
    if (lse2 != nullptr && cg == 0)
      lse2[(static_cast<size_t>(b) * H + kvh * G + r % G) * S + row] =
          m[i] * kLog2e + log2f(den);
#pragma unroll
    for (int c = 0; c < CPT; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = c * 32 + cg * 4 + e;
        if (d < Dv) orow[d] = acc[i][c * 4 + e] / den;
      }
  }
}

template <int DP, int DVP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse2, int B, int S, int q_start, int H, int KH,
                   int D, int Dv, bool bf16s, cudaStream_t stream) {
  const int G = H / KH;
  const int BQ = kRows / G;
  const size_t smem = smem_floats<DP, DVP>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DP, DVP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, KH, B);
  flash_fwd_kernel<DP, DVP><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse2, S,
      q_start + S, q_start, H, KH, D, Dv, G, BQ,
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(D))), bf16s);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16 inputs, (D, Dv) of (64, 64), (80, 80), (128, 128), (192, 192)
// and (192, 128): warp-specialised, on wgmma.
//
// A work item is 128 packed rows (BQ = 128/G positions x G heads of one
// kv head and batch), the JAX kernel's (bq*G, D) packing; a CTA stays on
// its SM and takes items in a fixed order (longest key range first, in a
// snake over the CTAs, so the CTAs get like shares), which hides each
// item's first loads behind the previous item's work and keeps short
// prefills in one wave.  Three warpgroups: 0 and 1 are consumers of 64
// rows each, 2 a producer whose one thread loads each item's Q (one TMA
// box of G heads x BQ positions lands as the packed rows, into one of two
// buffers, or the one) and keeps a ring of kStages K tiles and kStages V
// tiles of BN keys (128; 64 at D = Dv = 192) in flight, each guarded by a
// full and an
// empty mbarrier (K and V have rings of their own, so a K slot is free
// again as soon as Q.K^T has read it).  A row of Q, K or V in shared
// memory is one to three 128-byte swizzle atoms of 64 columns;
// D = 80 is padded to two atoms (128 columns) and TMA fills the 48
// columns past D with zeros, because the 128-byte swizzle, which the
// wgmma descriptors need to read without bank conflicts, is 64 bf16
// columns wide (a 64-byte swizzle would fit 80 as 5 x 16 but halves the
// rate at which shared memory feeds the tensor cores).
//
// Per tile j a consumer issues S_j = Q.K_j^T (wgmma m64n128k16, Q and K
// K-major from shared memory) and O += P_{j-1}.V_{j-1} (m64n64k16 per
// 64-column atom, P from registers in the A-fragment layout, V from
// shared memory as the transposed, N-major operand), then runs the
// softmax of S_j while P_{j-1}.V_{j-1} is still in flight.  The two
// consumers take turns issuing their products (named barriers 1 and 2),
// so one warpgroup's exponentials overlap the other's products.  The
// scale is folded into one FMA per score (scale * log2 e) and the
// exponential is ex2.approx; the running max, the denominator and O stay
// in float32 registers.  setmaxnreg gives the consumers 240 registers and
// leaves the producer 24.
//
// D = 192 (MLA's 128 nope + 64 rope columns of q and k) is three atoms a
// row.  MLA's v is 128 columns wide (Dv = 128, two atoms), and that
// instance keeps 128-key tiles: one Q buffer (48 KiB), a two-slot K ring
// (2 x 48 KiB) and a two-slot V ring (2 x 32 KiB), 209 KiB; S_j is 12
// k-steps of m64n128k16, P.V two atoms, and a consumer holds S 64, O 64
// and P 32 registers, as at D = 128.  With one Q buffer the producer
// loads the next item's Q once both consumers have S_j of the item's last
// tile, so it overlaps the last P.V and the epilogue.  At S = 256 the
// longest item walks 2 key tiles where 64-key tiles took 4, and P.V, the
// accumulator and the stores cover the 128 columns the model keeps
// rather than v zero-padded to 192.  The equal-width instance (192, 192:
// v of 192 columns, every one computed) cannot hold two 128-key rings
// and a Q buffer (3 x 48 KiB x 2 + 48 KiB = 336 KiB), so its K/V tiles
// hold 64 keys (24 KiB): two Q buffers, 193 KiB, S_j one m64n64k16
// product a k-step, 96 accumulator registers of O and 32 of S.
// ---------------------------------------------------------------------------

constexpr int kWgRows = 128;    // packed query rows of a CTA
constexpr int kStages = 2;      // slots of the K ring and of the V ring
constexpr int kWgThreads = 384; // consumer warpgroups 0, 1; producer 2
constexpr int kMaxSmem = 232448;  // dynamic shared memory a CTA may have

// Built with -DFA_STAMPS (attention_times.py --split), thread 0 of each
// consumer warpgroup records, in fa_stamps[CTA][warpgroup]: clock64() and
// %globaltimer at its start and at its end (words 0-3), and for each of
// its first kStampItems items (6 words from 4 + 6n) clock64() at the
// item's start, when its S_0 is done, when its last P.V is done and when
// its output is written, then its tile count and query tile + 1.
// flash_attention_stamps copies them out.  Without the macro nothing is
// recorded.
#ifdef FA_STAMPS
constexpr int kStampCTAs = 1024, kStampItems = 4;
constexpr int kStampWords = 4 + 6 * kStampItems;
__device__ unsigned long long fa_stamps[kStampCTAs][2][kStampWords];
__device__ __forceinline__ unsigned long long* stamp_row(int wg, int t) {
  return (t == 0 && blockIdx.x < kStampCTAs) ? fa_stamps[blockIdx.x][wg]
                                             : nullptr;
}
__device__ __forceinline__ void stamp_time(unsigned long long* row,
                                           int word) {
  if (row == nullptr) return;
  unsigned long long g;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g));
  row[word] = clock64();
  row[word + 1] = g;
}
#define FA_STAMP(n, i)                                 \
  do {                                                 \
    if (st_row && (n) < kStampItems)                   \
      st_row[4 + 6 * (n) + (i)] = clock64();           \
  } while (0)
#define FA_STAMP_ITEM(n, tiles, qt)                    \
  do {                                                 \
    if (st_row && (n) < kStampItems) {                 \
      st_row[4 + 6 * (n) + 4] = (tiles);               \
      st_row[4 + 6 * (n) + 5] = (qt) + 1;              \
    }                                                  \
  } while (0)
#else
#define FA_STAMP(n, i) \
  do {                 \
  } while (0)
#define FA_STAMP_ITEM(n, tiles, qt) \
  do {                              \
  } while (0)
#endif

// q and k rows of D columns, v and o rows of DV <= D
template <int D, int DV>
struct WgShape {
  // keys of a K/V tile: 64 only where v too is three atoms a row
  static constexpr int BN = D > 128 && DV > 128 ? 64 : 128;
  static constexpr int NA = (D + 63) / 64;     // 64-column atoms of q, k
  static constexpr int NAV = (DV + 63) / 64;   // 64-column atoms of v, o
  static constexpr int KD = D / 16;            // k-steps of Q.K^T
  static constexpr int Q_ATOM = kWgRows * 128; // bytes of one atom column
  static constexpr int KV_ATOM = BN * 128;
  static constexpr int QBUF = NA * Q_ATOM;     // bytes of a Q buffer
  static constexpr int KTILE = NA * KV_ATOM;   // bytes of a K tile
  static constexpr int VTILE = NAV * KV_ATOM;  // bytes of a V tile
  static constexpr int RINGS = kStages * (KTILE + VTILE);
  static constexpr int BARS = (4 * kStages + 4) * 8;
  // v narrower than q (MLA): each warpgroup writes O an atom at a time
  // into shared memory (64 rows x 128 bytes) and one TMA store takes it
  // out; the equal-width instances store from registers
  static constexpr bool STAGE_O = NAV < NA;
  static constexpr int O_STAGE = STAGE_O ? 2 * 64 * 128 : 0;
  // two Q buffers where they fit (the next item's Q loads while this
  // item's S products still read), else one
  static constexpr int QBUFS =
      1024 + 2 * QBUF + RINGS + O_STAGE + BARS <= kMaxSmem ? 2 : 1;
  static constexpr int SMEM = 1024 + QBUFS * QBUF + RINGS + O_STAGE + BARS;
  static_assert(SMEM <= kMaxSmem, "the wgmma kernel's tiles do not fit");
};

// S (64 rows x BN keys) = Q (this warpgroup's 64 rows) . K^T, both
// K-major in shared memory
template <int D, int DV>
__device__ __forceinline__ void issue_s(float (&s)[WgShape<D, DV>::BN / 2],
                                        const uint8_t* qrows,
                                        const uint8_t* ktile) {
  using W = WgShape<D, DV>;
#pragma unroll
  for (int kk = 0; kk < W::KD; ++kk) {
    const uint64_t da =
        sw128_desc(qrows + (kk >> 2) * W::Q_ATOM + (kk & 3) * 32);
    const uint64_t db =
        sw128_desc(ktile + (kk >> 2) * W::KV_ATOM + (kk & 3) * 32);
    if constexpr (W::BN == 128) {
      wgmma_ss_n128(s, da, db, kk > 0);
    } else {
      wgmma_ss_n64(s, da, db, kk > 0);
    }
  }
  wgmma_commit();
}

// O += P . V, P from registers, V N-major in shared memory, one product
// per 64-column atom of v
template <int D, int DV>
__device__ __forceinline__ void issue_pv(
    float (&acc)[WgShape<D, DV>::NAV][32],
    const uint32_t (&p)[WgShape<D, DV>::BN / 16][4], const uint8_t* vtile) {
  using W = WgShape<D, DV>;
#pragma unroll
  for (int kk = 0; kk < W::BN / 16; ++kk)
#pragma unroll
    for (int a = 0; a < W::NAV; ++a)
      wgmma_rs_n64(acc[a], p[kk],
                   sw128_desc(vtile + a * W::KV_ATOM + kk * 16 * 128));
  wgmma_commit();
}

// online softmax of the scores of the BN keys k0 ... in s (rows: this
// lane's two, at key positions row_pos; q0 the item's first), in base 2
// with the scale folded into one FMA: s becomes the exp2 weights, rs
// their sums over the lane's columns, corr the factors that rescale the
// rows' earlier state, m the running maxima.  bf16s: each score is first
// rounded to bfloat16 and scaled (bf16_score; scale_log2 is then log2 e),
// the weights are summed as P.V reads them, rounded to bfloat16, and the
// tile's sum of a row is itself rounded to bfloat16 (the JAX package sums
// p in bfloat16, a chunk at a time), held by the quad's first lane so
// that the final sum over the quad's lanes counts it once
template <int BN>
__device__ __forceinline__ void online_softmax(float (&s)[BN / 2],
                                               float (&m)[2],
                                               float (&corr)[2],
                                               float (&rs)[2], int k0,
                                               int q0, const int (&row_pos)[2],
                                               int lane, float scale_log2,
                                               bool bf16s, float scale) {
  const bool masked = k0 + BN - 1 > q0;  // some key past some row
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < BN / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      const int key = k0 + i * 8 + (lane & 3) * 2 + (e & 1);
      if (bf16s) s[4 * i + e] = bf16_score(s[4 * i + e], scale);
      if (masked && key > row_pos[h]) s[4 * i + e] = -INFINITY;
      mx[h] = fmaxf(mx[h], s[4 * i + e]);
    }
  float mc[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    // a row with no key yet (an idle row) keeps max -inf: offset 0
    mc[h] = mx[h] == -INFINITY ? 0.f : mx[h] * scale_log2;
    corr[h] = ex2(m[h] * scale_log2 - mc[h]);
    m[h] = mx[h];
    rs[h] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < BN / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = ex2(fmaf(s[4 * i + e], scale_log2, -mc[e >> 1]));
      s[4 * i + e] = x;
      rs[e >> 1] += bf16s ? bf16_round(x) : x;
    }
  if (bf16s) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float t = rs[h] + __shfl_xor_sync(0xffffffffu, rs[h], 1);
      t += __shfl_xor_sync(0xffffffffu, t, 2);
      rs[h] = (lane & 3) == 0 ? bf16_round(t) : 0.f;
    }
  }
}

// O's rows (this lane's two: rows r and r + 8 of its warp's 16) times
// their 1/l through shared memory: for each 64-column atom the
// warpgroup writes its 64 rows into stg (128-byte swizzled, as a TMA box
// lands: 16-byte chunk c of row r at chunk c ^ (r % 8)), and its thread 0
// stores them with one TMA box of G heads x 64/G positions, which skips
// positions past S.  Thread 0 first waits until its previous store has
// read stg.  Needs 64 % G == 0, so that the rows are whole positions.
template <int NAV>
__device__ __forceinline__ void store_rows_tma(
    const CUtensorMap* tm_o, uint8_t* stg, const float (&acc)[NAV][32],
    const float (&inv)[2], int wg, int t, int warp, int lane, int col0,
    int pos0, int b) {
#pragma unroll
  for (int a = 0; a < NAV; ++a) {
    if (t == 0) bulk_wait_read<0>();
    warpgroup_sync(3 + wg);  // stg is free
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 + (lane >> 2) + h * 8;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        *reinterpret_cast<uint32_t*>(stg + r * 128 + ((i ^ (r & 7)) << 4) +
                                     (lane & 3) * 4) =
            pack_bf16(acc[a][4 * i + 2 * h] * inv[h],
                      acc[a][4 * i + 2 * h + 1] * inv[h]);
    }
    fence_proxy_async();
    warpgroup_sync(3 + wg);  // the warpgroup's rows are in stg
    if (t == 0) {
      tma_store_4d(tm_o, stg, a * 64, col0, pos0, b);
      bulk_commit();
    }
  }
}

__device__ __forceinline__ void rescale(float (&acc)[32],
                                        const float (&corr)[2]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    acc[4 * i + 0] *= corr[0];
    acc[4 * i + 1] *= corr[0];
    acc[4 * i + 2] *= corr[1];
    acc[4 * i + 3] *= corr[1];
  }
}

// the CTA's n-th work item (longest key range first, in a snake over the
// CTAs so that every CTA gets a like share); false past the last
__device__ __forceinline__ bool work_item(int n, int n_items, int KH, int B,
                                          int n_qt, int& qt, int& kvh,
                                          int& b) {
  const int c = (n & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int w = n * gridDim.x + c;
  if (w >= n_items) return false;
  qt = n_qt - 1 - w / (KH * B);
  kvh = w % KH;
  b = (w / KH) % B;
  return true;
}

template <int D, int DV>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_o,
                       __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse2, int B, int S, int q_start,
                       int H, int KH, int G, int BQ, float scale_log2,
                       bool bf16s, float scale) {
  using W = WgShape<D, DV>;
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte alignment: the period of the 128-byte swizzle
  uint8_t* Qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  uint8_t* Ks = Qs + W::QBUFS * W::QBUF;
  uint8_t* Vs = Ks + kStages * W::KTILE;
  uint8_t* Os = Vs + kStages * W::VTILE;  // W::O_STAGE bytes
  uint64_t* full_k = reinterpret_cast<uint64_t*>(Os + W::O_STAGE);
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty_k = full_v + kStages;
  uint64_t* empty_v = empty_k + kStages;
  uint64_t* full_q = empty_v + kStages;  // W::QBUFS Q buffers (of 2)
  uint64_t* empty_q = full_q + 2;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int R = BQ * G;  // packed rows of an item
  const int n_qt = (S + BQ - 1) / BQ;
  const int n_items = n_qt * KH * B;
  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full_k[st], 1);
      mbar_init(&full_v[st], 1);
      mbar_init(&empty_k[st], 8);  // lane 0 of each consumer warp
      mbar_init(&empty_v[st], 8);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&full_q[i], 1);
      mbar_init(&empty_q[i], 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 256) {
      tma_prefetch(&tm_q);
      tma_prefetch(&tm_k);
      tma_prefetch(&tm_v);
      int qt, kvh, b, it = 0;
      for (int n = 0; work_item(n, n_items, KH, B, n_qt, qt, kvh, b); ++n) {
        const int qb = W::QBUFS == 2 ? n & 1 : 0;
        mbar_wait(&empty_q[qb], (W::QBUFS == 2 ? (n >> 1) & 1 : n & 1) ^ 1);
        mbar_expect_tx(&full_q[qb], W::NA * R * 128);
#pragma unroll
        for (int a = 0; a < W::NA; ++a)
          tma_load_4d(Qs + qb * W::QBUF + a * W::Q_ATOM, &tm_q, &full_q[qb],
                      a * 64, kvh * G, qt * BQ, b);
        const int n_tiles =
            (q_start + min(qt * BQ + BQ, S) - 1) / W::BN + 1;
        for (int j = 0; j < n_tiles; ++j, ++it) {
          const int st = it % kStages, ph = (it / kStages) & 1;
          mbar_wait(&empty_k[st], ph ^ 1);
          mbar_expect_tx(&full_k[st], W::KTILE);
#pragma unroll
          for (int a = 0; a < W::NA; ++a)
            tma_load_4d(Ks + st * W::KTILE + a * W::KV_ATOM, &tm_k,
                        &full_k[st], a * 64, kvh, j * W::BN, b);
          mbar_wait(&empty_v[st], ph ^ 1);
          mbar_expect_tx(&full_v[st], W::VTILE);
#pragma unroll
          for (int a = 0; a < W::NAV; ++a)
            tma_load_4d(Vs + st * W::VTILE + a * W::KV_ATOM, &tm_v,
                        &full_v[st], a * 64, kvh, j * W::BN, b);
        }
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int t = tid & 127, warp = t >> 5, lane = t & 31;
    const int bar_me = 1 + wg, bar_other = 2 - wg;
#ifdef FA_STAMPS
    unsigned long long* st_row = stamp_row(wg, t);
    stamp_time(st_row, 0);
#endif
    if (wg == 1) named_arrive(1);  // warpgroup 0 issues first
    int qt, kvh, b, it = 0;
    for (int n = 0; work_item(n, n_items, KH, B, n_qt, qt, kvh, b); ++n) {
      const int q0 = qt * BQ;
      const int n_tiles = (q_start + min(q0 + BQ, S) - 1) / W::BN + 1;
      FA_STAMP(n, 0);
      FA_STAMP_ITEM(n, n_tiles, qt);
      const int qb = W::QBUFS == 2 ? n & 1 : 0;
      // is this the CTA's last item?
      int nqt, nkvh, nb;
      const bool last_item = !work_item(n + 1, n_items, KH, B, n_qt, nqt,
                                        nkvh, nb);
      // this lane's rows: r and r + 8 of its warp's 16 (row r: query
      // row q0 + r/G at key position q_start + q0 + r/G, head kvh*G +
      // r%G); rows past R or S are computed on whatever the Q buffer
      // holds there and never written
      int row_pos[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wg * 64 + warp * 16 + (lane >> 2) + h * 8;
        const int pos = q0 + r / G;
        row_pos[h] = (r < R && pos < S) ? q_start + pos : -1;
      }
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
      // S_j: s[4i+e], row h = e/2, key 8i + 2(lane%4) + e%2
      float s[W::BN / 2];
      float acc[W::NAV][32];      // O: the same layout, 64 columns an atom
      uint32_t p[W::BN / 16][4];  // P_{j-1} as A fragments, 16 keys each
#pragma unroll
      for (int i = 0; i < W::BN / 2; ++i) s[i] = 0.f;
#pragma unroll
      for (int a = 0; a < W::NAV; ++a)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[a][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < W::BN / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[kk][e] = 0u;
      const uint8_t* qrows = Qs + qb * W::QBUF + wg * 64 * 128;
      mbar_wait(&full_q[qb], W::QBUFS == 2 ? (n >> 1) & 1 : n & 1);

      // tile 0: S_0 alone
      {
        const int st = it % kStages, ph = (it / kStages) & 1;
        mbar_wait(&full_k[st], ph);
        named_sync(bar_me);
        fence_regs(s);
        wgmma_fence();
        issue_s<D, DV>(s, qrows, Ks + st * W::KTILE);
        named_arrive(bar_other);  // the other warpgroup's products next
        wgmma_wait<0>();
        fence_regs(s);
        FA_STAMP(n, 1);
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(&empty_k[st]);
          if (n_tiles == 1) mbar_arrive(&empty_q[qb]);  // Q read
        }
        float corr[2], rs[2];
        online_softmax<W::BN>(s, m, corr, rs, 0, q_start + q0, row_pos,
                              lane, scale_log2, bf16s, scale);
        l[0] = rs[0];
        l[1] = rs[1];
        to_afrag<W::BN>(p, s);  // the weights as P's A fragments
        ++it;
      }
      // tile j: S_j and P_{j-1}.V_{j-1} on the tensor cores, then the
      // softmax of S_j while P_{j-1}.V_{j-1} may still run
      for (int j = 1; j < n_tiles; ++j, ++it) {
        const int st = it % kStages, ph = (it / kStages) & 1;
        const int pst = (it + kStages - 1) % kStages;  // tile j - 1
        const int pph = ((it + 2 * kStages - 1) / kStages) & 1;
        mbar_wait(&full_k[st], ph);
        mbar_wait(&full_v[pst], pph);
        named_sync(bar_me);
        fence_regs(s);
#pragma unroll
        for (int a = 0; a < W::NAV; ++a) fence_regs(acc[a]);
        fence_regs(p);
        wgmma_fence();
        issue_s<D, DV>(s, qrows, Ks + st * W::KTILE);
        issue_pv<D, DV>(acc, p, Vs + pst * W::VTILE);
        named_arrive(bar_other);
        wgmma_wait<1>();  // S_j done
        fence_regs(s);
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(&empty_k[st]);
          if (j == n_tiles - 1) mbar_arrive(&empty_q[qb]);
        }
        float corr[2], rs[2];
        online_softmax<W::BN>(s, m, corr, rs, j * W::BN, q_start + q0,
                              row_pos, lane, scale_log2, bf16s, scale);
        wgmma_wait<0>();  // P_{j-1}.V_{j-1} done: free its V slot
#pragma unroll
        for (int a = 0; a < W::NAV; ++a) fence_regs(acc[a]);
        fence_regs(p);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty_v[pst]);
#pragma unroll
        for (int a = 0; a < W::NAV; ++a) rescale(acc[a], corr);
#pragma unroll
        for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + rs[h];
        to_afrag<W::BN>(p, s);  // the weights as P's A fragments
      }

      // the last tile's P.V
      {
        const int pst = (it + kStages - 1) % kStages;
        const int pph = ((it + 2 * kStages - 1) / kStages) & 1;
        mbar_wait(&full_v[pst], pph);
        named_sync(bar_me);
#pragma unroll
        for (int a = 0; a < W::NAV; ++a) fence_regs(acc[a]);
        fence_regs(p);
        wgmma_fence();
        issue_pv<D, DV>(acc, p, Vs + pst * W::VTILE);
        // warpgroup 1 arrived once ahead of its first turn: its last turn
        // of the CTA hands nothing on, so every arrival meets a wait
        if (wg == 0 || !last_item) named_arrive(bar_other);
        wgmma_wait<0>();
        FA_STAMP(n, 2);
#pragma unroll
        for (int a = 0; a < W::NAV; ++a) fence_regs(acc[a]);
        fence_regs(p);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty_v[pst]);
      }

#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      }
      // the staged instance's warpgroup rows are whole positions when
      // 64 % G == 0: stored by TMA; else, and in the other instances,
      // each lane stores its rows from registers (4 bytes a lane, a
      // quad's 16 bytes a row an instruction)
      bool staged = false;
      if constexpr (W::STAGE_O) {
        if (64 % G == 0) {
          staged = true;
          float inv[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = wg * 64 + warp * 16 + (lane >> 2) + h * 8;
            inv[h] = 1.f / fmaxf(l[h], 1e-30f);
            if (row_pos[h] >= 0 && lse2 != nullptr && (lane & 3) == 0)
              lse2[(static_cast<size_t>(b) * H + kvh * G + r % G) * S +
                   row_pos[h] - q_start] = m[h] * scale_log2 +
                                           log2f(fmaxf(l[h], 1e-30f));
          }
          store_rows_tma<W::NAV>(&tm_o, Os + wg * 64 * 128, acc, inv, wg, t,
                                 warp, lane, kvh * G, q0 + wg * (64 / G), b);
        }
      }
      if (!staged) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (row_pos[h] < 0) continue;
          const int r = wg * 64 + warp * 16 + (lane >> 2) + h * 8;
          const int row = row_pos[h] - q_start;
          const float inv = 1.f / fmaxf(l[h], 1e-30f);
          // the row's log-sum-exp of its scaled scores, in base 2, for the
          // backward: m is the raw maximum, the weights ex2(s*c - m*c)
          if (lse2 != nullptr && (lane & 3) == 0)
            lse2[(static_cast<size_t>(b) * H + kvh * G + r % G) * S + row] =
                m[h] * scale_log2 + log2f(fmaxf(l[h], 1e-30f));
          __nv_bfloat16* orow =
              o + ((static_cast<size_t>(b) * S + row) * H + kvh * G + r % G) *
                      DV;
#pragma unroll
          for (int a = 0; a < W::NAV; ++a)
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const int col = a * 64 + i * 8 + (lane & 3) * 2;
              if (col < DV) {
                *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                    __floats2bfloat162_rn(acc[a][4 * i + 2 * h] * inv,
                                          acc[a][4 * i + 2 * h + 1] * inv);
              }
            }
        }
      }
      FA_STAMP(n, 3);
    }
    // the TMA stores have read stg and written o before the CTA ends
    if constexpr (W::STAGE_O) {
      if (t == 0) bulk_wait<0>();
    }
#ifdef FA_STAMPS
    stamp_time(st_row, 2);
#endif
  }
}

int sm_count() {
  static int n[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (n[dev] == 0 &&
      cudaDeviceGetAttribute(&n[dev], cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 132;
  return n[dev];
}

template <int D, int DV>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* o, float* lse2, int B, int S, int q_start,
                         int H, int KH, bool bf16s, cudaStream_t stream) {
  using W = WgShape<D, DV>;
  const int G = H / KH;
  const int BQ = kWgRows / G;
  // q as (D, H, S, B) with boxes of 64 columns x G heads x BQ positions:
  // an item's packed rows, in the order p*G + g
  // o (staged instances) in boxes of 64 columns x G heads x 64/G
  // positions: a warpgroup's rows
  CUtensorMap mq, mk, mv, mo{};
  if (!rows_map(&mq, q, 2, B, S, S, H, D, BQ, G) ||
      !rows_map(&mk, k, 2, B, q_start + S, q_start + S, KH, D, W::BN) ||
      !rows_map(&mv, v, 2, B, q_start + S, q_start + S, KH, DV, W::BN) ||
      (W::STAGE_O &&
       !rows_map(&mo, o, 2, B, S, S, H, DV, 64 % G == 0 ? 64 / G : 1, G)))
    return cudaErrorNotSupported;
  const int smem = W::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<D, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long n_items =
      static_cast<long long>((S + BQ - 1) / BQ) * KH * B;
  const int grid = static_cast<int>(
      n_items < sm_count() ? n_items : static_cast<long long>(sm_count()));
  flash_fwd_wgmma_kernel<D, DV><<<grid, kWgThreads, smem, stream>>>(
      mq, mk, mv, mo, static_cast<__nv_bfloat16*>(o), lse2, B, S, q_start,
      H, KH, G, BQ,
      bf16s ? kLog2e
            : static_cast<float>(1.4426950408889634 /
                                 std::sqrt(static_cast<double>(D))),
      bf16s, static_cast<float>(1.0 / std::sqrt(static_cast<double>(D))));
  return cudaGetLastError();
}

}  // namespace

// q: (B, S, H, D); k: (B, Sk, KH, D); v: (B, Sk, KH, Dv); o: (B, S, H,
// Dv) with Sk = q_start + S: query row i at key position q_start + i
// (causal, the rectangle's bottom-right aligned), contiguous and 16-byte
// aligned, float32 (0 < Dv <= D <= 192, on the FMA kernel) or, with
// is_bf16, bfloat16 ((D, Dv) of (64, 64), (80, 80), (128, 128), (192,
// 192) or (192, 128), MLA's, on wgmma).  H % KH == 0, H / KH <= 64.
// bf16_scores: the scores and weights rounded to bfloat16 (the JAX
// package's bfloat16 score_dtype; float32 inputs are first rounded to
// bfloat16).  lse2: null, or float32 (B, H, S) that receives each row's
// log-sum-exp of its scaled scores in base 2 (for the backward).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse2,
                                   int B, int S, int H, int KH, int D,
                                   int Dv, int is_bf16, int q_start,
                                   int bf16_scores, void* stream) {
  const bool bf16_pair = D == Dv ? (D == 64 || D == 80 || D == 128 ||
                                    D == 192)
                                 : (D == 192 && Dv == 128);
  if (B < 1 || S < 1 || KH < 1 || H < KH || H % KH != 0 ||
      H / KH > kRows || D < 1 || D > 192 || Dv < 1 || Dv > D ||
      B > 65535 || KH > 65535 || q_start < 0 ||
      static_cast<long long>(q_start) + S > (1ll << 31) - 1 ||
      (is_bf16 && static_cast<long long>(S) * KH * B > (1ll << 31) - 1) ||
      (is_bf16 && !bf16_pair)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l2 = static_cast<float*>(lse2);
  const int q0 = q_start;
  const bool bs = bf16_scores != 0;
  cudaError_t err;
  if (is_bf16 && D == 64) {
    err = launch_wgmma<64, 64>(q, k, v, o, l2, B, S, q0, H, KH, bs, st);
  } else if (is_bf16 && D == 80) {
    err = launch_wgmma<80, 80>(q, k, v, o, l2, B, S, q0, H, KH, bs, st);
  } else if (is_bf16 && D == 128) {
    err = launch_wgmma<128, 128>(q, k, v, o, l2, B, S, q0, H, KH, bs, st);
  } else if (is_bf16 && Dv == 128) {
    err = launch_wgmma<192, 128>(q, k, v, o, l2, B, S, q0, H, KH, bs, st);
  } else if (is_bf16) {
    err = launch_wgmma<192, 192>(q, k, v, o, l2, B, S, q0, H, KH, bs, st);
  } else if (D <= 64) {
    err = launch<64, 64>(q, k, v, o, l2, B, S, q0, H, KH, D, Dv, bs,
                         st);
  } else if (D <= 96) {
    err = launch<96, 96>(q, k, v, o, l2, B, S, q0, H, KH, D, Dv, bs,
                         st);
  } else if (D <= 128) {
    err = launch<128, 128>(q, k, v, o, l2, B, S, q0, H, KH, D, Dv, bs,
                         st);
  } else if (Dv <= 128) {
    err = launch<192, 128>(q, k, v, o, l2, B, S, q0, H, KH, D, Dv, bs,
                         st);
  } else {
    err = launch<192, 192>(q, k, v, o, l2, B, S, q0, H, KH, D, Dv, bs,
                         st);
  }
  return static_cast<int>(err);
}

#ifdef FA_STAMPS
// the stamps of the last launches (fa_stamps, kStampCTAs x 2 x
// kStampWords words) into host memory at dst, then zeroed
extern "C" int flash_attention_stamps(void* dst) {
  cudaError_t err = cudaMemcpyFromSymbol(dst, fa_stamps, sizeof(fa_stamps));
  void* dev = nullptr;
  if (err == cudaSuccess) err = cudaGetSymbolAddress(&dev, fa_stamps);
  if (err == cudaSuccess) err = cudaMemset(dev, 0, sizeof(fa_stamps));
  return static_cast<int>(err);
}
#endif
