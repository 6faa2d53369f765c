// Single-token attention over a KV cache up to position pos (flash
// decoding: split over the keys, then a combine pass).
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
// ratio, so the least time is the live cache over 3.35 TB/s.
//
// Design: the kernel reads exactly the keys [0, pos], never the rest of
// the cache.  The live keys are cut into n_splits contiguous ranges (a
// multiple of 64 keys each, chosen by the wrapper so that batch x kv heads
// x splits fills the card), one CTA per (split, kv head, batch).  In a
// CTA, a group of LPK lanes owns one key at a time: lane c holds the 16
// bytes of the key's row at d = c*VEC, so a group reads whole rows with
// 16-byte loads, reduces its G dot products with warp shuffles, and
// folds the key into the group's own online softmax state (running max,
// denominator, G x VEC accumulator slice in float32 registers).  Groups
// take 4 neighbouring keys per step, so each lane keeps 8 loads in
// flight.  The CTA's groups then merge their states in shared memory and
// write one partial (max, denominator, accumulator) per split; the
// combine kernel merges the splits and divides.  q is cast to the
// cache's type by the wrapper, as cached_decode_attention does; the
// probabilities stay float32 (the plain version rounds them to the
// cache's type before the value sum, a difference well inside the 2e-2
// bfloat16 tolerance).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 128;
constexpr int kKeysPerStep = 4;  // neighbouring keys a group takes per step
constexpr float kNegInf = -1e30f;

// 16 bytes of a cache row: 4 float32 or 8 bfloat16 values
template <typename T>
struct Chunk;
template <>
struct Chunk<float> {
  static constexpr int N = 4;
  __device__ static float get(const uint4& u, int e) {
    const unsigned w = e == 0 ? u.x : e == 1 ? u.y : e == 2 ? u.z : u.w;
    return __uint_as_float(w);
  }
};
template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static float get(const uint4& u, int e) {
    const int h = e >> 1;
    const unsigned w = h == 0 ? u.x : h == 1 ? u.y : h == 2 ? u.z : u.w;
    // a bfloat16 is the high half of a float32; element 2h is the low
    // half of word h (little endian)
    return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
  }
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// part_o: (B, KH, n_splits, G, D); part_ml: (B, KH, n_splits, G, 2)
template <typename T, int LPK, int GM>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc, float* __restrict__ part_o,
                    float* __restrict__ part_ml, int Smax, int H, int KH,
                    int D, int G, int pos, int keys_per_split, float scale) {
  constexpr int VEC = Chunk<T>::N;
  constexpr int NG = kThreads / LPK;  // lane groups of the CTA
  constexpr int DPAD = LPK * VEC;     // head columns a group covers
  __shared__ float sm_acc[NG][GM][DPAD];
  __shared__ float sm_m[NG][GM], sm_l[NG][GM], sm_w[NG][GM];
  __shared__ float sm_mx[GM], sm_den[GM];

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int n_splits = gridDim.x;
  const int lane = threadIdx.x % LPK;
  const int grp = threadIdx.x / LPK;
  const bool active = lane * VEC < D;
  const int d0 = lane * VEC;

  float qf[GM][VEC];
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      qf[g][e] = (g < G && active)
                     ? to_f(q[(static_cast<size_t>(b) * H + kvh * G + g) * D +
                              d0 + e])
                     : 0.f;

  float m[GM], l[GM], acc[GM][VEC];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
  }

  const int k_begin = split * keys_per_split;
  const int k_end = min(k_begin + keys_per_split, pos + 1);
  const size_t row = static_cast<size_t>(KH) * D;  // elements between keys
  const T* kbase = kc + (static_cast<size_t>(b) * Smax * KH + kvh) * D + d0;
  const T* vbase = vc + (static_cast<size_t>(b) * Smax * KH + kvh) * D + d0;
  // every lane runs every step (the shuffles need the whole warp)
  const int per_step = NG * kKeysPerStep;
  const int n_steps = (k_end - k_begin + per_step - 1) / per_step;
  for (int it = 0; it < n_steps; ++it) {
    const int key0 = k_begin + (it * NG + grp) * kKeysPerStep;
    uint4 kr[kKeysPerStep], vr[kKeysPerStep];
#pragma unroll
    for (int kk = 0; kk < kKeysPerStep; ++kk) {
      const int key = key0 + kk;
      if (active && key < k_end) {
        kr[kk] = *reinterpret_cast<const uint4*>(kbase + key * row);
        vr[kk] = *reinterpret_cast<const uint4*>(vbase + key * row);
      } else {
        kr[kk] = make_uint4(0u, 0u, 0u, 0u);
        vr[kk] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    float s[kKeysPerStep][GM];
#pragma unroll
    for (int kk = 0; kk < kKeysPerStep; ++kk)
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          dot = fmaf(qf[g][e], Chunk<T>::get(kr[kk], e), dot);
#pragma unroll
        for (int off = LPK / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        s[kk][g] = dot * scale;
      }
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float mx = m[g];
#pragma unroll
      for (int kk = 0; kk < kKeysPerStep; ++kk)
        if (key0 + kk < k_end) mx = fmaxf(mx, s[kk][g]);
      const float corr = expf(m[g] - mx);
      l[g] *= corr;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[g][e] *= corr;
#pragma unroll
      for (int kk = 0; kk < kKeysPerStep; ++kk) {
        const float p = key0 + kk < k_end ? expf(s[kk][g] - mx) : 0.f;
        l[g] += p;
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[g][e] = fmaf(p, Chunk<T>::get(vr[kk], e), acc[g][e]);
      }
      m[g] = mx;
    }
  }

  // merge the CTA's groups (a group that saw no key has weight 0)
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (lane == 0) {
      sm_m[grp][g] = m[g];
      sm_l[grp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) sm_acc[grp][g][d0 + e] = acc[g][e];
  }
  __syncthreads();
  if (threadIdx.x < G) {
    const int g = threadIdx.x;
    float mx = kNegInf;
    for (int i = 0; i < NG; ++i) mx = fmaxf(mx, sm_m[i][g]);
    float den = 0.f;
    for (int i = 0; i < NG; ++i) {
      const float w = expf(sm_m[i][g] - mx);
      sm_w[i][g] = w;
      den += sm_l[i][g] * w;
    }
    sm_mx[g] = mx;
    sm_den[g] = den;
  }
  __syncthreads();
  const size_t base =
      ((static_cast<size_t>(b) * KH + kvh) * n_splits + split) * G;
  for (int idx = threadIdx.x; idx < G * D; idx += kThreads) {
    const int g = idx / D, d = idx - (idx / D) * D;
    float o = 0.f;
    for (int i = 0; i < NG; ++i) o = fmaf(sm_acc[i][g][d], sm_w[i][g], o);
    part_o[(base + g) * D + d] = o;
    if (d == 0) {
      part_ml[(base + g) * 2] = sm_mx[g];
      part_ml[(base + g) * 2 + 1] = sm_den[g];
    }
  }
}

template <typename To>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* __restrict__ part_o,
                      const float* __restrict__ part_ml, To* __restrict__ out,
                      int H, int KH, int D, int G, int n_splits) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / G, g = h - (h / G) * G;
  const size_t first = (static_cast<size_t>(b) * KH + kvh) * n_splits * G + g;
  float mx = kNegInf;
  for (int s = 0; s < n_splits; ++s)
    mx = fmaxf(mx, part_ml[(first + static_cast<size_t>(s) * G) * 2]);
  float den = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    const size_t i = first + static_cast<size_t>(s) * G;
    den += part_ml[i * 2 + 1] * expf(part_ml[i * 2] - mx);
  }
  den = fmaxf(den, 1e-30f);
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float o = 0.f;
    for (int s = 0; s < n_splits; ++s) {
      const size_t i = first + static_cast<size_t>(s) * G;
      o = fmaf(part_o[i * D + d], expf(part_ml[i * 2] - mx), o);
    }
    store(out + (static_cast<size_t>(b) * H + h) * D + d, o / den);
  }
}

template <typename T, int LPK, int GM>
cudaError_t launch_split(const void* q, const void* kc, const void* vc,
                         float* part_o, float* part_ml, int B, int Smax,
                         int H, int KH, int D, int pos, int n_splits,
                         int keys_per_split, float scale,
                         cudaStream_t stream) {
  const dim3 grid(n_splits, KH, B);
  decode_split_kernel<T, LPK, GM><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), part_o, part_ml, Smax, H, KH, D, H / KH,
      pos, keys_per_split, scale);
  return cudaGetLastError();
}

template <typename T, int LPK>
cudaError_t by_group(int G, const void* q, const void* kc, const void* vc,
                     float* po, float* pml, int B, int Smax, int H, int KH,
                     int D, int pos, int ns, int kps, float scale,
                     cudaStream_t st) {
  if (G <= 1)
    return launch_split<T, LPK, 1>(q, kc, vc, po, pml, B, Smax, H, KH, D,
                                   pos, ns, kps, scale, st);
  if (G <= 2)
    return launch_split<T, LPK, 2>(q, kc, vc, po, pml, B, Smax, H, KH, D,
                                   pos, ns, kps, scale, st);
  if (G <= 4)
    return launch_split<T, LPK, 4>(q, kc, vc, po, pml, B, Smax, H, KH, D,
                                   pos, ns, kps, scale, st);
  return launch_split<T, LPK, 8>(q, kc, vc, po, pml, B, Smax, H, KH, D, pos,
                                 ns, kps, scale, st);
}

}  // namespace

// q: (B, H, D) and k_cache, v_cache: (B, Smax, KH, D), contiguous, all
// float32 or (cache_bf16) all bfloat16; out: (B, H, D), float32 or
// (out_bf16) bfloat16.  Attends keys [0, pos]; the keys are cut into
// n_splits ranges of keys_per_split; part_o (B, KH, n_splits, G, D) and
// part_ml (B, KH, n_splits, G, 2) are float32 scratch.  H % KH == 0,
// H / KH <= 8, D <= 128 and D a multiple of 16 bytes' worth of elements.
extern "C" int flash_decode_fwd(const void* q, const void* kc,
                                const void* vc, void* out, void* part_o,
                                void* part_ml, int B, int Smax, int H,
                                int KH, int D, int pos, int n_splits,
                                int keys_per_split, int cache_bf16,
                                int out_bf16, void* stream) {
  const int vec = cache_bf16 ? 8 : 4;
  if (B < 1 || B > 65535 || KH < 1 || KH > 65535 || H % KH != 0 ||
      H / KH > 8 || D < vec || D > 128 || D % vec != 0 || pos < 0 ||
      pos >= Smax || n_splits < 1 ||
      static_cast<long long>(n_splits - 1) * keys_per_split > pos ||
      static_cast<long long>(n_splits) * keys_per_split < pos + 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale =
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  const int G = H / KH;
  const int chunks = D / vec;
  float* po = static_cast<float*>(part_o);
  float* pml = static_cast<float*>(part_ml);
  cudaError_t err;
  if (cache_bf16) {
    err = chunks <= 8
              ? by_group<__nv_bfloat16, 8>(G, q, kc, vc, po, pml, B, Smax, H,
                                           KH, D, pos, n_splits,
                                           keys_per_split, scale, st)
              : by_group<__nv_bfloat16, 16>(G, q, kc, vc, po, pml, B, Smax,
                                            H, KH, D, pos, n_splits,
                                            keys_per_split, scale, st);
  } else {
    err = chunks <= 16
              ? by_group<float, 16>(G, q, kc, vc, po, pml, B, Smax, H, KH, D,
                                    pos, n_splits, keys_per_split, scale, st)
              : by_group<float, 32>(G, q, kc, vc, po, pml, B, Smax, H, KH, D,
                                    pos, n_splits, keys_per_split, scale,
                                    st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, B);
  if (out_bf16) {
    decode_combine_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        po, pml, static_cast<__nv_bfloat16*>(out), H, KH, D, G, n_splits);
  } else {
    decode_combine_kernel<float><<<grid, kThreads, 0, st>>>(
        po, pml, static_cast<float*>(out), H, KH, D, G, n_splits);
  }
  return static_cast<int>(cudaGetLastError());
}
