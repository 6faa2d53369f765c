// Single-token attention over a KV cache up to position pos (flash
// decoding: the live keys split across CTAs, merged in the same launch).
//
// Replaces the TPU kernel src/repro/kernels/flash_decode/kernel.py:63
// flash_decode (_decode_kernel, :27): grid (batch, kv head, kv block)
// with the online-softmax state carried in VMEM scratch across the
// sequential kv-block axis and the blocks past pos skipped.  Plain
// version: repro_torch/kernels/flash_decode/ref.py decode_attention, the
// numerics of the model's cached_decode_attention.
//
// Bound on an H100: bytes.  Every live key and value row of the cache is
// read once and used for G query heads (4*G*D operations a row of 2*D
// elements): about 4 operations a byte in bfloat16, far under the card's
// ratio, so the least time is the live cache over 3.35 TB/s.  At the
// serving shape (batch 4, 288 keys) that is 2.4 MB, under a microsecond:
// there the bound is the launch and the chain of dependent memory round
// trips of one CTA, so the kernel is one launch with as few round trips
// as it can have.
//
// Design: the kernel reads exactly the keys [0, pos], never the rest of
// the cache.  The live keys are cut into n_splits contiguous ranges (a
// multiple of 64 keys each, chosen by the wrapper), one CTA per (split,
// kv head, batch); the wrapper cuts a range only while the card has
// fewer CTAs than SMs and each would still walk several tiles, since a
// merge of splits costs dependent memory round trips.  Tiles of cache
// rows reach shared memory by TMA (tensor maps over the live rows only,
// so rows past pos arrive as zeros; 128-byte swizzle), each ring slot
// guarded by an mbarrier, and the first tiles are requested before q is
// read.
//
// bfloat16 caches (the serving path, decode_mma_kernel): every warp is a
// flash-decoding worker of its own over 16-key tiles, with both products
// on the tensor cores (mma.sync; the G <= 8 heads are the rows of the A
// operand), its running max, sum and output rows in registers, and no
// barrier of the CTA until the warps merge.  Working from registers and
// tensor cores, a warp spends a few dozen instructions a tile, so the
// card's memory, not its issue slots, sets the time of a long cache.
//
// float32 caches (the card-against-host parity checks, decode_fma_kernel):
// four groups of 128 threads, each streaming its tiles through a ring of
// its own; per tile each thread dots one key with up to 4 of the heads (q
// pre-scaled by scale * log2 e, read from shared memory as a broadcast),
// one warp per head takes the tile's max and turns the scores into exp2
// weights, and each thread folds its share of the keys into an 8-column
// slice of one head's float32 accumulator, so float32 inputs keep
// float32 accuracy.
//
// With one split the CTA normalises and writes out itself.  With more,
// each CTA writes its partial (max, denominator, accumulator), fences,
// and bumps a per-(batch, kv head) arrival counter; the CTA that arrives
// last merges the splits, writes out and sets the counter back to 0, so
// the wrapper's counters stay zeroed between calls without a memset.  q
// is cast to the cache's type by the wrapper, as cached_decode_attention
// does; the probabilities stay float32 until the bfloat16 kernel rounds
// them for its P.V product (the plain version rounds them to the cache's
// type too).
//
// A cache split by positions across ranks (the "model" axis of a mesh
// that cannot split the kv heads): each rank attends to its own stretch
// and the ranks combine their outputs by each head's log-sum-exp.  Given
// an lse pointer, whichever CTA writes out (the one split, or the last to
// merge) also writes ln(sum exp(scaled score)) of its head, from the max
// and sum it merged anyway; the wrapper then asks for a float32 out, so
// that the combine rounds once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace repro_hopper;

constexpr int kGroups = 4;          // groups of 128 threads in a CTA
constexpr int kThreads = 128 * kGroups;
constexpr int kRing = 3;            // slots of a group's ring
constexpr int kSlot = 16384;        // bytes of a slot: K and V of a tile

// the 4 float32 values of 16 bytes of a cache row
__device__ __forceinline__ void unpack4(const uint4& u, float (&x)[4]) {
  x[0] = __uint_as_float(u.x);
  x[1] = __uint_as_float(u.y);
  x[2] = __uint_as_float(u.z);
  x[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void group_sync(int grp) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + grp) : "memory");
}

// shared memory of a float32 CTA (NA: 128-byte atoms of a padded row)
template <int GM, int NA>
struct Smem {
  static constexpr int TK = 64 / NA;  // keys of a tile: NA * TK * 128 = 8 KB
  static constexpr int DP = NA * 32;  // padded head dim
  static constexpr int RING = kGroups * kRing * kSlot;  // 1024-aligned
  static constexpr int Q = RING;                  // float [GM][DP]
  static constexpr int SC = Q + GM * DP * 4;      // float [kGroups][GM][TK+1]
  static constexpr int ST = SC + kGroups * GM * (TK + 1) * 4;
  // float m, l, corr [kGroups][GM]; fac [kGroups][GM]; M, L [GM]
  static constexpr int BAR = ST + (4 * kGroups + 2) * GM * 4 + 8;
  static constexpr int BYTES = 1024 + ((BAR + 7) / 8) * 8 +
                               kGroups * kRing * 8 + 16;
  static_assert(RING >= kThreads * 8 * 4, "the slice sums reuse the ring");
};

constexpr float kLn2 = 0.6931471805599453f;

// a head's natural log-sum-exp of its scaled scores from the running max
// mx (log2 units, q pre-scaled by scale * log2 e) and the sum den of
// 2^(x - mx): ln(2^mx * den)
__device__ __forceinline__ float lse_of(float mx, float den) {
  return (mx + log2f(den)) * kLn2;
}

// With n_splits > 1, after the CTA wrote its partials of kv heads kvh0
// ... kvh0 + hc - 1: the last CTA of this (batch, head group) to arrive
// merges the splits into out (and, when lse is not null, each head's
// log-sum-exp into lse) and sets the arrival counter (that of kvh0) back
// to 0.  Every thread of the CTA calls it.
__device__ void merge_splits(const float* part_o, const float* part_ml,
                             int* counters, float* lse, void* out,
                             int out_bf16, int b, int kvh0, int hc, int H,
                             int KH, int D, int G, int n_splits,
                             int* last_s) {
  const int t = threadIdx.x;
  __threadfence();
  __syncthreads();
  int* counter = counters + static_cast<size_t>(b) * KH + kvh0;
  if (t == 0) *last_s = atomicAdd(counter, 1) == n_splits - 1;
  __syncthreads();
  if (!*last_s) return;
  __threadfence();
  for (int idx = t; idx < hc * G * D; idx += blockDim.x) {
    const int kvh = kvh0 + idx / (G * D);
    const int g = (idx / D) % G, d = idx % D;
    const size_t first = (static_cast<size_t>(b) * KH + kvh) * n_splits * G;
    // one pass, rescaling to the running max (every split saw a key)
    float mx = -INFINITY, den = 0.f, o = 0.f;
    for (int s = 0; s < n_splits; ++s) {
      const size_t i = first + s * G + g;
      const float ms = __ldcg(part_ml + i * 2);
      const float ls = __ldcg(part_ml + i * 2 + 1);
      const float os = __ldcg(part_o + i * D + d);
      const float m_new = fmaxf(mx, ms);
      const float a = ex2(mx - m_new), w = ex2(ms - m_new);
      den = den * a + ls * w;
      o = o * a + os * w;
      mx = m_new;
    }
    const size_t oi = (static_cast<size_t>(b) * H + kvh * G + g) * D + d;
    if (out_bf16) {
      static_cast<__nv_bfloat16*>(out)[oi] =
          __float2bfloat16(o / fmaxf(den, 1e-30f));
    } else {
      static_cast<float*>(out)[oi] = o / fmaxf(den, 1e-30f);
    }
    if (lse != nullptr && d == 0)
      lse[static_cast<size_t>(b) * H + kvh * G + g] = lse_of(mx, den);
  }
  if (t == 0) *counter = 0;  // zeroed for the next call on this stream
}

// part_o: (B, KH, n_splits, G, D); part_ml: (B, KH, n_splits, G, 2);
// counters: B * KH ints, all 0 between calls (unused with one split)
template <int GM, int NA>
__global__ void __launch_bounds__(kThreads, 1)
decode_fma_kernel(const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  const float* __restrict__ q, void* __restrict__ out,
                  int out_bf16, float* __restrict__ part_o,
                  float* __restrict__ part_ml, int* __restrict__ counters,
                  float* __restrict__ lse,
                  int H, int KH, int D, int G, int pos, int keys_per_split,
                  float scale_log2) {
  using L = Smem<GM, NA>;
  constexpr int VEC = 4, TK = L::TK, DP = L::DP;  // VEC: floats of 16 B
  constexpr int NHG = 128 / TK;                    // head groups of scores
  constexpr int HPT = GM > NHG ? GM / NHG : 1;     // heads a thread scores
  constexpr int CHP = DP / 8;                      // 8-column slices
  constexpr int NP = GM * CHP;                     // (head, slice) pairs
  constexpr int NSL = 128 / NP;                    // key slices of P.V
  static_assert(NP <= 128, "one thread per (head, 8 columns)");
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte alignment: the period of the 128-byte swizzle
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  float* qs = reinterpret_cast<float*>(sm + L::Q);
  float* st = reinterpret_cast<float*>(sm + L::ST);
  float* m_s = st;                        // [kGroups][GM]
  float* l_s = m_s + kGroups * GM;
  float* corr_s = l_s + kGroups * GM;
  float* fac_s = corr_s + kGroups * GM;
  float* mt_s = fac_s + kGroups * GM;     // [GM]: the CTA's max and sum
  float* lt_s = mt_s + GM;
  int* last_s = reinterpret_cast<int*>(lt_s + GM);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + ((L::BAR + 7) / 8) * 8);

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int n_splits = gridDim.x;
  const int t = threadIdx.x, grp = t >> 7, gt = t & 127;
  const int warp = gt >> 5, lane = t & 31;
  const int k_begin = split * keys_per_split;
  const int k_end = min(k_begin + keys_per_split, pos + 1);
  const int n_tiles = (k_end - k_begin + TK - 1) / TK;
  // this group's tiles: grp, grp + kGroups, ...
  const int my_tiles = n_tiles > grp ? (n_tiles - grp + kGroups - 1) / kGroups
                                     : 0;
  const uint8_t* ring = sm + grp * kRing * kSlot;
  uint64_t* gfull = full + grp * kRing;
  float* sc = reinterpret_cast<float*>(sm + L::SC) + grp * GM * (TK + 1);
  float* m_g = m_s + grp * GM;
  float* l_g = l_s + grp * GM;
  float* corr_g = corr_s + grp * GM;

  // tile i of group g (keys k_begin + (g + kGroups*i)*TK ...) into slot
  // i % kRing of its ring: K atoms, then V atoms
  auto issue = [&](int g, int i) {
    const int s = i % kRing;
    const int key0 = k_begin + (g + kGroups * i) * TK;
    uint8_t* slot = sm + (g * kRing + s) * kSlot;
    uint64_t* bar = &full[g * kRing + s];
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect_tx(bar, kSlot);
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      tma_load_4d(slot + a * TK * 128, &tm_k, bar, a * 32, kvh, key0,
                  b);
      tma_load_4d(slot + (NA + a) * TK * 128, &tm_v, bar, a * 32,
                  kvh, key0, b);
    }
  };
  if (t == 0) {
    // the first tiles of every group are requested before anything else,
    // so their round trip overlaps the loads of q below
    tma_prefetch(&tm_k);
    tma_prefetch(&tm_v);
    for (int i = 0; i < kGroups * kRing; ++i) mbar_init(&full[i], 1);
    mbar_init_fence();
    for (int i = 0; i < kRing; ++i)
      for (int g = 0; g < kGroups; ++g)
        if (g + kGroups * i < n_tiles) issue(g, i);
  }
  for (int idx = t; idx < GM * DP; idx += kThreads) {
    const int g = idx / DP, d = idx - g * DP;
    qs[idx] = (g < G && d < D)
                  ? q[(static_cast<size_t>(b) * H + kvh * G + g) * D + d] *
                        scale_log2
                  : 0.f;
  }
  if (t < kGroups * GM) {
    m_s[t] = -INFINITY;
    l_s[t] = 0.f;
  }
  __syncthreads();

  // this thread's scores: key gt % TK against heads hg*HPT ...
  const int skey = gt % TK, hg = gt / TK;
  // its share of P.V: head pg, columns 8*pc ..., keys psl + NSL*k
  const int pg = (gt % NP) / CHP, pc = (gt % NP) % CHP, psl = gt / NP;
  const bool pv_on = pg < G && pc * 8 < D;
  const int pv_atom = (pc * 32) >> 7, pv_chunk = ((pc * 32) & 127) >> 4;
  float acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.f;

  for (int i = 0; i < my_tiles; ++i) {
    const int s = i % kRing;
    mbar_wait(&gfull[s], (i / kRing) & 1);
    const uint8_t* kt = ring + s * kSlot;
    const uint8_t* vt = kt + NA * TK * 128;
    const int key0 = k_begin + (grp + kGroups * i) * TK;

    // scores, in log2 units
    if (hg * HPT < GM) {
      float dot[HPT];
#pragma unroll
      for (int h = 0; h < HPT; ++h) dot[h] = 0.f;
#pragma unroll
      for (int a = 0; a < NA; ++a)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int col = (a * 8 + c) * VEC;
          if (col < D) {
            float x[VEC];
            unpack4(*reinterpret_cast<const uint4*>(
                          kt + a * TK * 128 + skey * 128 +
                          ((c ^ (skey & 7)) << 4)),
                      x);
#pragma unroll
            for (int h = 0; h < HPT; ++h) {
              const float4* qg = reinterpret_cast<const float4*>(
                  qs + (hg * HPT + h) * DP + col);
#pragma unroll
              for (int e4 = 0; e4 < VEC / 4; ++e4) {
                const float4 qv = qg[e4];
                dot[h] = fmaf(qv.x, x[4 * e4], dot[h]);
                dot[h] = fmaf(qv.y, x[4 * e4 + 1], dot[h]);
                dot[h] = fmaf(qv.z, x[4 * e4 + 2], dot[h]);
                dot[h] = fmaf(qv.w, x[4 * e4 + 3], dot[h]);
              }
            }
          }
        }
      const bool live = key0 + skey < k_end;
#pragma unroll
      for (int h = 0; h < HPT; ++h)
        sc[(hg * HPT + h) * (TK + 1) + skey] = live ? dot[h] : -INFINITY;
    }
    group_sync(grp);

    // per head: the tile's max, the running sum, exp2 weights
    for (int g = warp; g < G; g += 4) {
      float* sg = sc + g * (TK + 1);
      float mx = -INFINITY;
#pragma unroll
      for (int k = lane; k < TK; k += 32) mx = fmaxf(mx, sg[k]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_g[g];
      const float m_new = fmaxf(m_old, mx);  // finite: a tile has a key
      float sum = 0.f;
#pragma unroll
      for (int k = lane; k < TK; k += 32) {
        const float pw = ex2(sg[k] - m_new);
        sg[k] = pw;
        sum += pw;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = ex2(m_old - m_new);  // 0 on the first tile
        corr_g[g] = corr;
        l_g[g] = l_g[g] * corr + sum;
        m_g[g] = m_new;
      }
    }
    group_sync(grp);

    // acc += P[head, keys] . V[keys, 8 columns]
    if (pv_on) {
      const float corr = corr_g[pg];
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] *= corr;
      const float* pw = sc + pg * (TK + 1);
      const uint8_t* vrows = vt + pv_atom * TK * 128;
#pragma unroll 4
      for (int k = psl; k < TK; k += NSL) {
        const float w = pw[k];
#pragma unroll
        for (int h = 0; h < 8 / VEC; ++h) {
          float x[VEC];
          unpack4(*reinterpret_cast<const uint4*>(
                        vrows + k * 128 + (((pv_chunk + h) ^ (k & 7)) << 4)),
                    x);
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[h * VEC + e] = fmaf(w, x[e], acc[h * VEC + e]);
        }
      }
    }
    group_sync(grp);  // slot s and the scores are free again
    if (gt == 0 && i + kRing < my_tiles) issue(grp, i + kRing);
  }
  __syncthreads();  // every group done: the ring holds the slices' sums now

  // merge the groups: the CTA's max and sum per head, each group's factor
  if (t < G) {
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < kGroups; ++i) mx = fmaxf(mx, m_s[i * GM + t]);
    float den = 0.f;
#pragma unroll
    for (int i = 0; i < kGroups; ++i) {
      const float f = ex2(m_s[i * GM + t] - mx);  // 0 for a group with no
      fac_s[i * GM + t] = f;                      // tile (max -inf)
      den = fmaf(l_s[i * GM + t], f, den);
    }
    mt_s[t] = mx;
    lt_s[t] = den;
  }
  __syncthreads();
  float* red = reinterpret_cast<float*>(sm);
  {
    const float f = pv_on ? fac_s[grp * GM + pg] : 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) red[t * 8 + e] = acc[e] * f;
  }
  __syncthreads();
  if (t < NP && pv_on) {
    float o8[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) o8[e] = 0.f;
    for (int i = 0; i < kGroups * NSL; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) o8[e] += red[(i * NP + t) * 8 + e];
    const int h = kvh * G + pg;
    if (n_splits == 1) {
      const float inv = 1.f / fmaxf(lt_s[pg], 1e-30f);
      const size_t o0 = (static_cast<size_t>(b) * H + h) * D + pc * 8;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (pc * 8 + e >= D) break;
        if (out_bf16) {
          static_cast<__nv_bfloat16*>(out)[o0 + e] =
              __float2bfloat16(o8[e] * inv);
        } else {
          static_cast<float*>(out)[o0 + e] = o8[e] * inv;
        }
      }
      if (lse != nullptr && pc == 0)
        lse[static_cast<size_t>(b) * H + h] = lse_of(mt_s[pg], lt_s[pg]);
    } else {
      const size_t p0 =
          ((static_cast<size_t>(b) * KH + kvh) * n_splits + split) * G + pg;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (pc * 8 + e >= D) break;
        part_o[p0 * D + pc * 8 + e] = o8[e];
      }
      if (pc == 0) {
        part_ml[p0 * 2] = mt_s[pg];
        part_ml[p0 * 2 + 1] = lt_s[pg];
      }
    }
  }
  if (n_splits == 1) return;

  merge_splits(part_o, part_ml, counters, lse, out, out_bf16, b, kvh, 1, H,
               KH, D, G, n_splits, last_s);
}

template <int GM, int NA>
cudaError_t launch_fma(const void* q, const void* kc, const void* vc,
                       void* out, int out_bf16, float* po, float* pml,
                       int* counters, float* lse, int B, int Smax, int H,
                       int KH, int D, int pos, int ns, int kps,
                       cudaStream_t stream) {
  constexpr int TK = Smem<GM, NA>::TK;
  CUtensorMap mk, mv;
  if (!rows_map(&mk, kc, 4, B, pos + 1, Smax, KH, D, TK) ||
      !rows_map(&mv, vc, 4, B, pos + 1, Smax, KH, D, TK))
    return cudaErrorNotSupported;
  const int smem = Smem<GM, NA>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      decode_fma_kernel<GM, NA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(ns, KH, B);
  decode_fma_kernel<GM, NA><<<grid, kThreads, smem, stream>>>(
      mk, mv, static_cast<const float*>(q), out, out_bf16, po, pml, counters,
      lse, H, KH, D, H / KH, pos, kps,
      static_cast<float>(1.4426950408889634 /
                         std::sqrt(static_cast<double>(D))));
  return cudaGetLastError();
}

template <int NA>
cudaError_t by_group(int G, const void* q, const void* kc, const void* vc,
                     void* out, int out_bf16, float* po, float* pml,
                     int* cnt, float* lse, int B, int Smax, int H, int KH,
                     int D, int pos, int ns, int kps, cudaStream_t st) {
  if (G <= 1)
    return launch_fma<1, NA>(q, kc, vc, out, out_bf16, po, pml, cnt, lse, B,
                             Smax, H, KH, D, pos, ns, kps, st);
  if (G <= 2)
    return launch_fma<2, NA>(q, kc, vc, out, out_bf16, po, pml, cnt, lse, B,
                             Smax, H, KH, D, pos, ns, kps, st);
  if (G <= 4)
    return launch_fma<4, NA>(q, kc, vc, out, out_bf16, po, pml, cnt, lse, B,
                             Smax, H, KH, D, pos, ns, kps, st);
  return launch_fma<8, NA>(q, kc, vc, out, out_bf16, po, pml, cnt, lse, B,
                           Smax, H, KH, D, pos, ns, kps, st);
}

// ---------------------------------------------------------------------------
// bfloat16 caches, the serving path.  A CTA covers HC kv heads of one
// batch (HC = 1 while the card has SMs to spare, up to 8 when B x KH
// fills it, so that a tile of HC heads is one contiguous stretch of the
// cache).  Its W = 16 / NA warps form W / HC sets; warp w works on head
// w % HC in set w / HC, and set i takes the tiles i, i + W/HC, ... of 16
// keys x HC heads, through a three-slot TMA ring of its own (16 rows x
// NA 128-byte atoms a head, K then V, 128-byte swizzled), with a full
// mbarrier (TMA bytes) and an empty one (the set's HC warps) per slot.
// Each warp is a flash-decoding worker: both products run on the tensor
// cores with mma.sync m16n8k16 (the G <= 8 query heads are rows 0..7 of
// the A operand, rows 8..15 zero; K and V come from shared memory through
// ldmatrix, V transposed), and its running max, sum and output rows stay
// in registers; no barrier of the CTA runs until the warps merge their
// states in shared memory at the end.  The rings hold 192 KB.
// ---------------------------------------------------------------------------

constexpr int kWarpKeys = 16;  // keys of a tile

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a (16x16, row) * b (16x8, col); a's rows 8..15 are zero
__device__ __forceinline__ void mma_rows8(float (&c)[4], uint32_t a0,
                                          uint32_t a2, uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

template <int NA, int HC>
struct MmaShape {
  static constexpr int W = 16 / NA;    // warps of a CTA
  static constexpr int SETS = W / HC;  // warp sets, each with a ring
  static constexpr int HEAD = kWarpKeys * 128;  // bytes of a head's atom
  static constexpr int ATOM = HC * HEAD;        // one box: HC heads
  static constexpr int SLOT = 2 * NA * ATOM;    // K atoms, then V atoms
  static constexpr int RING = SETS * kRing * SLOT;  // 192 KB
  static constexpr int DP = NA * 64;                // padded head dim
  static constexpr int ST = RING + 2 * SETS * kRing * 8;  // after barriers
  // float m, l [W][8]; the last-CTA flag
  static constexpr int BYTES = 1024 + ST + 2 * W * 8 * 4 + 16;
  static_assert(RING >= W * 8 * DP * 4, "the warps' rows reuse the ring");
  static_assert(SETS >= 1, "at most W heads a CTA");
};

// the byte offset of 16-byte chunk c of row r of a head's atoms in a
// tile (atom c / 8 of the head at a stride of HC heads)
template <int HC>
__device__ __forceinline__ int sw_off(int r, int c) {
  return (c >> 3) * (HC * kWarpKeys * 128) + r * 128 +
         (((c & 7) ^ (r & 7)) << 4);
}

// DK: the head dim when it is one of the models' (64, 80, 128), so that
// the loops over it fold at compile time; 0 for any other D
template <int NA, int HC, int DK>
__global__ void __launch_bounds__(MmaShape<NA, HC>::W * 32, 1)
decode_mma_kernel(const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  const __nv_bfloat16* __restrict__ q, void* __restrict__ out,
                  int out_bf16, float* __restrict__ part_o,
                  float* __restrict__ part_ml, int* __restrict__ counters,
                  float* __restrict__ lse,
                  int H, int KH, int D_run, int G, int pos,
                  int keys_per_split, float scale_log2) {
  using M = MmaShape<NA, HC>;
  const int D = DK > 0 ? DK : D_run;
  constexpr int W = M::W, SETS = M::SETS, DP = M::DP;
  constexpr int KDM = NA * 4;  // k-steps of 16 columns, at most
  constexpr int NDM = NA * 8;  // n-tiles of 8 columns, at most
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + M::RING);
  uint64_t* empty = full + SETS * kRing;
  float* m_s = reinterpret_cast<float*>(sm + M::ST);  // [W][8]
  float* l_s = m_s + W * 8;
  int* last_s = reinterpret_cast<int*>(l_s + W * 8);

  const int split = blockIdx.x, kvh0 = blockIdx.y * HC, b = blockIdx.z;
  const int n_splits = gridDim.x;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int head = warp % HC, set = warp / HC, kvh = kvh0 + head;
  const int k_begin = split * keys_per_split;
  const int k_end = min(k_begin + keys_per_split, pos + 1);
  const int n_tiles = (k_end - k_begin + kWarpKeys - 1) / kWarpKeys;
  const int my_tiles = n_tiles > set ? (n_tiles - set + SETS - 1) / SETS : 0;
  uint8_t* ring = sm + set * kRing * M::SLOT;
  uint64_t* bfull = full + set * kRing;
  uint64_t* bempty = empty + set * kRing;
  const bool issuer = head == 0 && lane == 0;

  // q as A fragments: row g = lane / 4 (head kvh*G + g), columns
  // 16*kd + 2*(lane % 4) (+8); zero past G and D.  Loaded first, so
  // that their round trip overlaps the set-up of the ring below
  const int g = lane >> 2, tq = lane & 3;
  uint32_t qf[KDM][2];
#pragma unroll
  for (int kd = 0; kd < KDM; ++kd)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = kd * 16 + h * 8 + tq * 2;
      qf[kd][h] = (g < G && col < D)
                      ? *reinterpret_cast<const uint32_t*>(
                            q + (static_cast<size_t>(b) * H + kvh * G + g) * D +
                            col)
                      : 0u;
    }
  // tile i of this set (keys k_begin + (set + SETS*i)*16 ... of heads
  // kvh0 ...) into slot i % kRing
  auto issue = [&](int i) {
    const int s = i % kRing;
    const int key0 = k_begin + (set + SETS * i) * kWarpKeys;
    uint8_t* slot = ring + s * M::SLOT;
    if (i >= kRing)  // the slot was read through the generic proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect_tx(&bfull[s], M::SLOT);
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      tma_load_4d(slot + a * M::ATOM, &tm_k, &bfull[s], a * 64, key0, kvh0,
                  b);
      tma_load_4d(slot + (NA + a) * M::ATOM, &tm_v, &bfull[s], a * 64, key0,
                  kvh0, b);
    }
  };
  if (issuer) {
    tma_prefetch(&tm_k);
    tma_prefetch(&tm_v);
    for (int s = 0; s < kRing; ++s) {
      mbar_init(&bfull[s], 1);
      mbar_init(&bempty[s], HC);  // lane 0 of each warp of the set
    }
    mbar_init_fence();
    for (int i = 0; i < kRing && i < my_tiles; ++i) issue(i);
  }

  float m = -INFINITY, l = 0.f;  // row g, in log2 units
  float acc[NDM][4];             // rows g (e < 2) and g + 8 (zero)
#pragma unroll
  for (int n = 0; n < NDM; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  __syncthreads();  // the barriers are initialised

  for (int i = 0; i < my_tiles; ++i) {
    const int s = i % kRing;
    mbar_wait(&bfull[s], (i / kRing) & 1);
    const uint8_t* kt = ring + s * M::SLOT + head * M::HEAD;
    const uint8_t* vt = kt + NA * M::ATOM;
    const int key0 = k_begin + (set + SETS * i) * kWarpKeys;

    // scores of the 16 keys: sc[j][e], key 8j + 2*tq + e (e < 2)
    // two chains of k-steps (even, odd) halve the dependent mma latency
    float sc[2][4], sd[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = sd[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KDM; ++kd) {
      if (kd * 16 < D) {
        uint32_t kb[4];
        const int r = ((lane >> 4) << 3) + (lane & 7);
        ldsm_x4(kb, kt + sw_off<HC>(r, 2 * kd + ((lane >> 3) & 1)));
        float (&acc_s)[2][4] = (kd & 1) ? sd : sc;
        mma_rows8(acc_s[0], qf[kd][0], qf[kd][1], kb[0], kb[1]);
        mma_rows8(acc_s[1], qf[kd][0], qf[kd][1], kb[2], kb[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) sc[j][e] += sd[j][e];
    float x[4], mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = key0 + j * 8 + tq * 2 + e;
        x[2 * j + e] = key < k_end ? sc[j][e] * scale_log2 : -INFINITY;
        mx = fmaxf(mx, x[2 * j + e]);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);  // finite: key0 is live
    const float corr = ex2(m - m_new);  // 0 on the first tile
    float p[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) p[k] = ex2(x[k] - m_new);
    l = l * corr + (p[0] + p[1]) + (p[2] + p[3]);
    m = m_new;
#pragma unroll
    for (int n = 0; n < NDM; ++n) {
      acc[n][0] *= corr;
      acc[n][1] *= corr;
    }
    const uint32_t pa0 = pack_bf16(p[0], p[1]), pa2 = pack_bf16(p[2], p[3]);
#pragma unroll
    for (int dp = 0; dp < NDM / 2; ++dp) {
      if (dp * 16 < D) {
        uint32_t vb[4];
        const int r = (((lane >> 3) & 1) << 3) + (lane & 7);
        ldsm_x4_t(vb, vt + sw_off<HC>(r, 2 * dp + (lane >> 4)));
        mma_rows8(acc[2 * dp], pa0, pa2, vb[0], vb[1]);
        mma_rows8(acc[2 * dp + 1], pa0, pa2, vb[2], vb[3]);
      }
    }
    __syncwarp();  // every lane is done with slot s
    if (lane == 0) mbar_arrive(&bempty[s]);
    if (issuer && i + kRing < my_tiles) {
      mbar_wait(&bempty[s], (i / kRing) & 1);  // the set is done with it
      issue(i + kRing);
    }
    __syncwarp();
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);

  // merge the warps of each head: rows g of every warp in shared memory
  __syncthreads();  // every ring is idle: it holds the rows now
  float* rows = reinterpret_cast<float*>(sm);  // [W][8][DP]
  if (tq == 0) {
    m_s[warp * 8 + g] = m;
    l_s[warp * 8 + g] = l;
  }
#pragma unroll
  for (int n = 0; n < NDM; ++n)
    *reinterpret_cast<float2*>(rows + (warp * 8 + g) * DP + n * 8 + tq * 2) =
        make_float2(acc[n][0], acc[n][1]);
  __syncthreads();
  // each output element merges its head's warps itself: no further
  // barrier between the rows in shared memory and out
  for (int idx = t; idx < HC * G * D; idx += W * 32) {
    const int hh = idx / (G * D), gg = (idx / D) % G, d = idx % D;
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < SETS; ++i)
      mx = fmaxf(mx, m_s[(i * HC + hh) * 8 + gg]);
    float o = 0.f, den = 0.f;
#pragma unroll
    for (int i = 0; i < SETS; ++i) {
      const int w = i * HC + hh;
      const float f = ex2(m_s[w * 8 + gg] - mx);  // 0 for a warp with no
      o = fmaf(rows[(w * 8 + gg) * DP + d], f, o);  // tile (max -inf)
      den = fmaf(l_s[w * 8 + gg], f, den);
    }
    if (n_splits == 1) {
      const size_t oi =
          (static_cast<size_t>(b) * H + (kvh0 + hh) * G + gg) * D + d;
      const float v = o / fmaxf(den, 1e-30f);
      if (out_bf16) {
        static_cast<__nv_bfloat16*>(out)[oi] = __float2bfloat16(v);
      } else {
        static_cast<float*>(out)[oi] = v;
      }
      if (lse != nullptr && d == 0)
        lse[static_cast<size_t>(b) * H + (kvh0 + hh) * G + gg] =
            lse_of(mx, den);
    } else {
      const size_t p0 =
          ((static_cast<size_t>(b) * KH + kvh0 + hh) * n_splits + split) * G +
          gg;
      part_o[p0 * D + d] = o;
      if (d == 0) {
        part_ml[p0 * 2] = mx;
        part_ml[p0 * 2 + 1] = den;
      }
    }
  }
  if (n_splits == 1) return;
  merge_splits(part_o, part_ml, counters, lse, out, out_bf16, b, kvh0, HC,
               H, KH, D, G, n_splits, last_s);
}

template <int NA, int HC, int DK>
cudaError_t launch_mma(const void* q, const void* kc, const void* vc,
                       void* out, int out_bf16, float* po, float* pml,
                       int* counters, float* lse, int B, int Smax, int H,
                       int KH, int D, int pos, int ns, int kps,
                       cudaStream_t stream) {
  CUtensorMap mk, mv;
  if (!heads_map(&mk, kc, B, pos + 1, Smax, KH, D, kWarpKeys, HC) ||
      !heads_map(&mv, vc, B, pos + 1, Smax, KH, D, kWarpKeys, HC))
    return cudaErrorNotSupported;
  using M = MmaShape<NA, HC>;
  cudaError_t err = cudaFuncSetAttribute(
      decode_mma_kernel<NA, HC, DK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, M::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(ns, KH / HC, B);
  decode_mma_kernel<NA, HC, DK><<<grid, M::W * 32, M::BYTES, stream>>>(
      mk, mv, static_cast<const __nv_bfloat16*>(q), out, out_bf16, po, pml,
      counters, lse, H, KH, D, H / KH, pos, kps,
      static_cast<float>(1.4426950408889634 /
                         std::sqrt(static_cast<double>(D))));
  return cudaGetLastError();
}

template <int NA, int DK>
cudaError_t by_heads(int hc, const void* q, const void* kc, const void* vc,
                     void* out, int out_bf16, float* po, float* pml,
                     int* cnt, float* lse, int B, int Smax, int H, int KH,
                     int D, int pos, int ns, int kps, cudaStream_t st) {
  switch (hc) {
    case 1:
      return launch_mma<NA, 1, DK>(q, kc, vc, out, out_bf16, po, pml, cnt,
                                   lse, B, Smax, H, KH, D, pos, ns, kps, st);
    case 2:
      return launch_mma<NA, 2, DK>(q, kc, vc, out, out_bf16, po, pml, cnt,
                                   lse, B, Smax, H, KH, D, pos, ns, kps, st);
    case 4:
      return launch_mma<NA, 4, DK>(q, kc, vc, out, out_bf16, po, pml, cnt,
                                   lse, B, Smax, H, KH, D, pos, ns, kps, st);
    default:
      return launch_mma<NA, 8, DK>(q, kc, vc, out, out_bf16, po, pml, cnt,
                                   lse, B, Smax, H, KH, D, pos, ns, kps, st);
  }
}

}  // namespace

// q: (B, H, D) and k_cache, v_cache: (B, Smax, KH, D), contiguous and
// 16-byte aligned, all float32 or (cache_bf16) all bfloat16; out: (B, H,
// D), float32 or (out_bf16) bfloat16.  Attends keys [0, pos]; the keys
// are cut into n_splits ranges of keys_per_split.  With n_splits > 1,
// part_o (B, KH, n_splits, G, D) and part_ml (B, KH, n_splits, G, 2) are
// float32 scratch and counters holds B * KH ints that are 0 (the kernel
// leaves them 0); with one split none of the three is touched.  lse: null,
// or (B, H) float32 that takes each head's natural log-sum-exp of its
// scaled scores over keys [0, pos] (what a partial over a stretch of a
// cache split across ranks needs for the ranks' combine); out is written
// the same either way.  A CTA covers heads_per_cta kv heads (1, 2, 4 or
// 8 dividing KH; 1 for float32 and for a bfloat16 D other than 64, 80 or
// 128).  One launch.  H % KH == 0, H / KH <= 8, D <= 128 and D a multiple
// of 16 bytes' worth of elements.
extern "C" int flash_decode_fwd(const void* q, const void* kc,
                                const void* vc, void* out, void* part_o,
                                void* part_ml, void* counters, void* lse_out,
                                int B, int Smax, int H, int KH, int D,
                                int pos, int n_splits, int keys_per_split,
                                int heads_per_cta, int cache_bf16,
                                int out_bf16, void* stream) {
  const int vec = cache_bf16 ? 8 : 4;
  if (B < 1 || B > 65535 || KH < 1 || KH > 65535 || H % KH != 0 ||
      H / KH > 8 || D < vec || D > 128 || D % vec != 0 || pos < 0 ||
      pos >= Smax || n_splits < 1 ||
      static_cast<long long>(n_splits - 1) * keys_per_split > pos ||
      static_cast<long long>(n_splits) * keys_per_split < pos + 1 ||
      (n_splits > 1 && (part_o == nullptr || part_ml == nullptr ||
                        counters == nullptr)) ||
      (heads_per_cta != 1 && heads_per_cta != 2 && heads_per_cta != 4 &&
       heads_per_cta != 8) ||
      KH % heads_per_cta != 0 ||
      ((!cache_bf16 || (D != 64 && D != 80 && D != 128)) &&
       heads_per_cta != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = H / KH;
  float* po = static_cast<float*>(part_o);
  float* pml = static_cast<float*>(part_ml);
  int* cnt = static_cast<int*>(counters);
  float* lse = static_cast<float*>(lse_out);
  cudaError_t err;
  // NA: 128-byte atoms of a row, D padded up to 1, 2 or 4 of them
  if (cache_bf16 && (D == 64 || D == 80 || D == 128)) {
    err = D == 64   ? by_heads<1, 64>(heads_per_cta, q, kc, vc, out, out_bf16,
                                      po, pml, cnt, lse, B, Smax, H, KH, D,
                                      pos, n_splits, keys_per_split, st)
          : D == 80 ? by_heads<2, 80>(heads_per_cta, q, kc, vc, out, out_bf16,
                                      po, pml, cnt, lse, B, Smax, H, KH, D,
                                      pos, n_splits, keys_per_split, st)
                    : by_heads<2, 128>(heads_per_cta, q, kc, vc, out,
                                       out_bf16, po, pml, cnt, lse, B, Smax,
                                       H, KH, D, pos, n_splits,
                                       keys_per_split, st);
  } else if (cache_bf16) {
    err = D <= 64 ? launch_mma<1, 1, 0>(q, kc, vc, out, out_bf16, po, pml,
                                        cnt, lse, B, Smax, H, KH, D, pos,
                                        n_splits, keys_per_split, st)
                  : launch_mma<2, 1, 0>(q, kc, vc, out, out_bf16, po, pml,
                                        cnt, lse, B, Smax, H, KH, D, pos,
                                        n_splits, keys_per_split, st);
  } else {
    err = D <= 64 ? by_group<2>(G, q, kc, vc, out, out_bf16, po, pml, cnt,
                                lse, B, Smax, H, KH, D, pos, n_splits,
                                keys_per_split, st)
                  : by_group<4>(G, q, kc, vc, out, out_bf16, po, pml, cnt,
                                lse, B, Smax, H, KH, D, pos, n_splits,
                                keys_per_split, st);
  }
  return static_cast<int>(err);
}
