// Causal grouped-query flash attention, forward.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:69
// flash_attention (_flash_kernel, :29): grid (batch, kv head, q block,
// kv block) with the online-softmax state carried in VMEM scratch across
// the sequential kv-block axis.  Plain version: repro_torch/kernels/
// flash_attention/ref.py attention_ref.
//
// Bound on an H100: operations.  4*D*S(S+1)/2 per head against 2*D*S*2
// bytes of q, k, v and o: at S=256, D=64 about 128 operations a byte in
// bfloat16 and 64 in float32, so the card's multipliers, not its memory,
// set the least time once S is past a few hundred.
//
// Design: CTAs run in parallel and in no order, so the TPU's sequential
// kv-block axis becomes a loop inside the CTA.  One CTA owns (batch, kv
// head, BQ query positions) and holds the BQ*G rows of all G query heads
// that share the kv head (kRows = 64 rows: BQ = 64/G), so every K/V tile
// read from device memory serves G heads, as the JAX kernel's (bq*G, D)
// packing does.  Per key tile (kBK = 64 keys) the CTA stages K and V in
// shared memory as float32; 128 threads form 16 row groups of 4 rows x 8
// column groups, each thread computes a 4x8 block of scores from
// conflict-free float4 reads, the row max and sum are reduced with warp
// shuffles over the 8 threads of a row group, and the probabilities go
// through shared memory (one warp writes and reads its own rows) into a
// 4 x (DP/8) slice of the output accumulator.  The running max,
// denominator and accumulator stay in float32 registers for the whole
// CTA.  Key tiles wholly above the diagonal are never loaded; positions
// past S (a ragged last tile, any S) and head columns past D (D = 80 runs
// padded to 96) are zero-filled and masked.  Products are plain float32
// FMAs, so float32 inputs keep float32 accuracy.  bfloat16 inputs, whose D
// is 64, 80 or 128 in every dense model of the repo, take a second kernel
// of the same shape whose two products run on the tensor cores
// (mma.sync; see flash_fwd_mma_kernel).  wgmma, TMA and a pipelined K/V
// ring are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 128;  // 16 row groups x 8 column groups
constexpr int kRows = 64;      // query rows (position, head) of a CTA
constexpr int kBK = 64;        // keys of a tile
constexpr float kNegInf = -1e30f;

template <int DP>
constexpr size_t smem_floats() {
  return static_cast<size_t>(kRows) * (DP + 4) +  // Q
         static_cast<size_t>(kBK) * (DP + 4) +    // K
         static_cast<size_t>(kBK) * DP +          // V
         static_cast<size_t>(kRows) * (kBK + 4);  // P
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int S,
                 int H, int KH, int D, int G, int BQ, float scale) {
  constexpr int QS = DP + 4;  // row strides (floats): 16-byte aligned rows
  constexpr int KS = DP + 4;  // whose float4 reads hit distinct banks
  constexpr int VS = DP;
  constexpr int PS = kBK + 4;
  constexpr int CPT = DP / 32;  // float4 output chunks per thread and row
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

  // row r of the CTA is query position q0 + r / G of head kvh*G + r % G;
  // the G heads of one position are contiguous in q and o
  for (int idx = tid; idx < kRows * DP; idx += kThreads) {
    const int r = idx / DP, d = idx - (idx / DP) * DP;
    const int pos = q0 + r / G;
    float val = 0.f;
    if (r < R && pos < S && d < D) {
      val = q[((static_cast<size_t>(b) * S + pos) * H + kvh * G) * D +
              static_cast<size_t>(r % G) * D + d];
    }
    Qs[r * QS + d] = val;
  }

  int row_pos[4];  // -1: a row past R or S, never written
  float m[4], l[4], acc[4][CPT * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg * 4 + i;
    const int pos = q0 + r / G;
    row_pos[i] = (r < R && pos < S) ? pos : -1;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT * 4; ++c) acc[i][c] = 0.f;
  }

  const int last = min(q0 + BQ, S) - 1;  // the CTA's last position
  const int n_tiles = last / kBK + 1;    // tiles above the diagonal skipped
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's K/V are no longer read
    for (int idx = tid; idx < kBK * DP; idx += kThreads) {
      const int key = idx / DP, d = idx - (idx / DP) * DP;
      float kval = 0.f, vval = 0.f;
      if (k0 + key < S && d < D) {
        const size_t off =
            ((static_cast<size_t>(b) * S + k0 + key) * KH + kvh) * D + d;
        kval = k[off];
        vval = v[off];
      }
      Ks[key * KS + d] = kval;
      Vs[key * VS + d] = vval;
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
    // 8 neighbouring lanes of one warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] *= scale;
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
        const float p =
            (k0 + cg + 8 * j <= row_pos[i]) ? expf(s[i][j] - m_new) : 0.f;
        Ps[(rg * 4 + i) * PS + cg + 8 * j] = p;
        rs += p;
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
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
    const float den = fmaxf(l[i], 1e-30f);
    float* orow =
        o + ((static_cast<size_t>(b) * S + row_pos[i]) * H + kvh * G) * D +
        static_cast<size_t>(r % G) * D;
#pragma unroll
    for (int c = 0; c < CPT; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = c * 32 + cg * 4 + e;
        if (d < D) orow[d] = acc[i][c * 4 + e] / den;
      }
  }
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int H, int KH, int D, cudaStream_t stream) {
  const int G = H / KH;
  const int BQ = kRows / G;
  const size_t smem = smem_floats<DP>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, KH, B);
  flash_fwd_kernel<DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, H, KH, D, G,
      BQ, static_cast<float>(1.0 / std::sqrt(static_cast<double>(D))));
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16 inputs with D in {64, 80, 128}: the same CTA (64 rows of G heads
// x 64-key tiles), with the two products on the tensor cores
// (mma.sync m16n8k16, bfloat16 in, float32 accumulate).  Each warp owns 16
// of the CTA's rows: its Q fragments stay in registers for the whole CTA,
// K and V tiles are staged in shared memory as bfloat16 and read with
// ldmatrix (V transposed), the scores of a 16 x 64 tile sit in the
// accumulator layout, whose two 16 x 8 tiles per 16 keys are also the
// layout of the A operand of P @ V, so the probabilities go from
// registers to the second product without shared memory.  The row max
// and sum reduce over the 4 lanes that share a row.  P is rounded to
// bfloat16 for the product; the denominator sums it in float32.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// c += a (16x16, row) * b (16x8, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
constexpr size_t mma_smem_bytes() {
  return static_cast<size_t>(kRows + 2 * kBK) * (D + 8) * 2;  // Q, K, V
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, int S, int H, int KH,
                     int G, int BQ, float scale) {
  constexpr int LD = D + 8;   // row stride (elements): ldmatrix rows of 8
                              // addresses land on distinct banks
  constexpr int CH = D / 8;   // 16-byte chunks of a row
  constexpr int KD = D / 16;  // k-steps over the head dim
  constexpr int ND = D / 8;   // 8-column tiles of the output
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_u4);
  __nv_bfloat16* Ks = Qs + kRows * LD;
  __nv_bfloat16* Vs = Ks + kBK * LD;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest key range first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * BQ;
  const int R = BQ * G;

  for (int idx = tid; idx < kRows * CH; idx += kThreads) {
    const int r = idx / CH, c = idx - (idx / CH) * CH;
    const int pos = q0 + r / G;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < R && pos < S) {
      val = *reinterpret_cast<const uint4*>(
          q + ((static_cast<size_t>(b) * S + pos) * H + kvh * G + r % G) * D +
          c * 8);
    }
    *reinterpret_cast<uint4*>(Qs + r * LD + c * 8) = val;
  }
  __syncthreads();
  uint32_t qf[KD][4];  // A fragments of the warp's 16 rows
#pragma unroll
  for (int kd = 0; kd < KD; ++kd)
    ldsm_x4(qf[kd], Qs + (warp * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD +
                        kd * 16 + (lane >> 4) * 8);

  // this lane's two rows: r and r + 8 of the warp's 16
  int row_pos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + (lane >> 2) + h * 8;
    const int pos = q0 + r / G;
    row_pos[h] = (r < R && pos < S) ? pos : -1;
  }
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int last = min(q0 + BQ, S) - 1;
  const int n_tiles = last / kBK + 1;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's K/V are no longer read
    for (int idx = tid; idx < kBK * CH; idx += kThreads) {
      const int key = idx / CH, c = idx - (idx / CH) * CH;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (k0 + key < S) {
        const size_t off =
            ((static_cast<size_t>(b) * S + k0 + key) * KH + kvh) * D + c * 8;
        kv = *reinterpret_cast<const uint4*>(k + off);
        vv = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(Ks + key * LD + c * 8) = kv;
      *reinterpret_cast<uint4*>(Vs + key * LD + c * 8) = vv;
    }
    __syncthreads();

    // scores: 8 tiles of 8 keys; s[j][e]: row r (e < 2) or r + 8, key
    // k0 + 8j + 2*(lane % 4) + e % 2
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd)
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t kb[4];
        ldsm_x4(kb, Ks + ((jp * 2 + (lane >> 4)) * 8 + (lane & 7)) * LD +
                        kd * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * jp], qf[kd], kb[0], kb[1]);
        mma_bf16(s[2 * jp + 1], qf[kd], kb[2], kb[3]);
      }

    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + j * 8 + (lane & 3) * 2 + e;
          float x = s[j][h * 2 + e] * scale;
          x = key <= row_pos[h] ? x : kNegInf;
          s[j][h * 2 + e] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      corr[h] = expf(m[h] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + j * 8 + (lane & 3) * 2 + e;
          const float p =
              key <= row_pos[h] ? expf(s[j][h * 2 + e] - m_new) : 0.f;
          s[j][h * 2 + e] = p;
          rs += p;
        }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l[h] = l[h] * corr[h] + rs;
      m[h] = m_new;
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // acc += P (16 x 64) @ V (64 x D), 16 keys per step
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        uint32_t vb[4];
        ldsm_x4_t(vb, Vs + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD +
                          (dp * 2 + (lane >> 4)) * 8);
        mma_bf16(acc[2 * dp], pa, vb[0], vb[1]);
        mma_bf16(acc[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row_pos[h] < 0) continue;
    const int r = warp * 16 + (lane >> 2) + h * 8;
    const float den = fmaxf(l[h], 1e-30f);
    __nv_bfloat16* orow =
        o + ((static_cast<size_t>(b) * S + row_pos[h]) * H + kvh * G + r % G) *
                D;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + (lane & 3) * 2) =
          __floats2bfloat162_rn(acc[n][h * 2] / den, acc[n][h * 2 + 1] / den);
    }
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       int B, int S, int H, int KH, cudaStream_t stream) {
  const int G = H / KH;
  const int BQ = kRows / G;
  const size_t smem = mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, KH, B);
  flash_fwd_mma_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S,
      H, KH, G, BQ, static_cast<float>(1.0 / std::sqrt(static_cast<double>(D))));
  return cudaGetLastError();
}

}  // namespace

// q, o: (B, S, H, D); k, v: (B, S, KH, D), contiguous and 16-byte
// aligned, float32 (0 < D <= 128, on the FMA kernel) or, with is_bf16,
// bfloat16 (D of 64, 80 or 128, on the tensor cores).  Causal;
// H % KH == 0, H / KH <= 64.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int B, int S,
                                   int H, int KH, int D, int is_bf16,
                                   void* stream) {
  if (B < 1 || S < 1 || KH < 1 || H % KH != 0 || H / KH > kRows || D < 1 ||
      D > 128 || B > 65535 || KH > 65535 ||
      (is_bf16 && D != 64 && D != 80 && D != 128)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16 && D == 64) {
    err = launch_mma<64>(q, k, v, o, B, S, H, KH, st);
  } else if (is_bf16 && D == 80) {
    err = launch_mma<80>(q, k, v, o, B, S, H, KH, st);
  } else if (is_bf16) {
    err = launch_mma<128>(q, k, v, o, B, S, H, KH, st);
  } else if (D <= 64) {
    err = launch<64>(q, k, v, o, B, S, H, KH, D, st);
  } else if (D <= 96) {
    err = launch<96>(q, k, v, o, B, S, H, KH, D, st);
  } else {
    err = launch<128>(q, k, v, o, B, S, H, KH, D, st);
  }
  return static_cast<int>(err);
}
