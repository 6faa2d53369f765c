// Separable Gaussian blur of a tile of output pixels of an edge-padded
// image.
//
// Replaces the TPU kernel src/repro/kernels/gaussian/kernel.py:36
// blur_rows (_blur_kernel, :21), which assembles a row band plus its K-1
// halo from two VMEM blocks.  Plain version: repro_torch/kernels/gaussian/
// ref.py blur_rows_ref (on the columns [col0, col0+n_cols+K-1) of the
// padded image for a column window).
//
// Bound on an H100: bytes.  The tile's padded rows are read once and the
// output written once (4 bytes each), against 4K operations per output
// pixel (a vertical and a horizontal pass of K taps): 31 operations a
// byte at K=31, under the card's ~20 float32 operations per byte.
//
// Design: one CTA per kRows x 128 output tile, in two passes through
// shared memory, with nothing but data in the inner loops.
// - The taps are read once into registers: K is a template argument
//   (31, the paper's filter) and the tap loops unroll into FFMAs on
//   registers.  Any other K in [1, 63] takes the kTaps = 0 instance of the
//   same kernel, whose loops run to a run-time K on taps in shared memory.
// - Vertical pass in registers: a thread owns one column of the tile's
//   band and kRowsPerThread consecutive output rows.  It reads the
//   kRowsPerThread + K - 1 inputs of its column straight from global
//   memory (a warp reads 32 neighbouring floats of a row: coalesced) and
//   slides each through its accumulators, then writes its sums to shared
//   memory.  Padded rows are 8222 floats at the paper's size: 8-byte, not
//   16-byte aligned, so the reads are 4-byte ones (no TMA tensor map can
//   describe that stride).
// - Horizontal pass: a warp makes a row of the tile, each lane 4 adjacent
//   outputs from 4 + K - 1 sums read with 16-byte shared-memory loads
//   (conflict-free: the lanes read consecutive 16 bytes), stored with one
//   16-byte store where the output rows are 16-byte aligned.
// Each output sums k = 0..K-1 in the plain version's order, in FMAs.  The
// kernel indexes the whole padded image from (row0, col0), so one launch
// serves one packet or tile, no slice copy.  Its shared memory stays under
// 48 KB, so no launch sets a function attribute.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxTaps = 63;
constexpr int kTileW = 128;   // output columns of a tile: 32 lanes x 4

// columns of a band row in shared memory: the 16-byte loads of the last
// lane reach 124 + 4 * ceil((K + 3) / 4) = 4 * ceil((K + 127) / 4)
__host__ __device__ constexpr int band_stride(int max_k) {
  return (kTileW + max_k - 1 + 3) / 4 * 4;
}

// kRowsPerThread + K - 1 inputs of one column (from src, rows wp apart)
// slid through kRowsPerThread accumulators; past n_in rows (kEdge) the
// inputs read as 0.
template <int kRowsPerThread, bool kEdge, typename Tap>
__device__ __forceinline__ void vertical(float (&acc)[kRowsPerThread],
                                         const float* __restrict__ src,
                                         int wp, int K, int n_in, Tap tap) {
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) acc[r] = 0.0f;
#pragma unroll
  for (int i = 0; i < kRowsPerThread + K - 1; ++i) {
    const float v = (!kEdge || i < n_in)
                        ? __ldg(src + static_cast<size_t>(i) * wp)
                        : 0.0f;
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const int k = i - r;
      if (k >= 0 && k < K) acc[r] = fmaf(tap(k), v, acc[r]);
    }
  }
}

template <int kTaps, int kRows, int kRowsPerThread, int kWarps,
          int kMinBlocks>
__global__ void __launch_bounds__(32 * kWarps, kMinBlocks)
gaussian_kernel(const float* __restrict__ img, const float* __restrict__ w,
                float* __restrict__ out, int row0, int n_rows, int col0,
                int n_cols, int wp, int k_run) {
  constexpr int kThreads = 32 * kWarps;
  constexpr int kMaxK = kTaps ? kTaps : kMaxTaps;
  constexpr int kStride = band_stride(kMaxK);
  constexpr int kGroups = kRows / kRowsPerThread;
  // band columns a group's threads cover: the band rounded to warps
  constexpr int kSlots = (kTileW + kMaxK - 1 + 31) / 32 * 32;
  static_assert(kRows % kRowsPerThread == 0 && kRows % kWarps == 0,
                "a tile is whole groups of rows and whole rows a warp");
  static_assert(sizeof(float) * (kRows * kStride + 64) <= 48 * 1024,
                "static shared memory");
  __shared__ __align__(16) float sums[kRows][kStride];
  __shared__ __align__(16) float taps_s[64];

  const int K = kTaps ? kTaps : k_run;
  const int tid = threadIdx.x;
  for (int k = tid; k < K; k += kThreads) taps_s[k] = w[k];
  __syncthreads();
  float taps_r[kTaps ? kTaps : 1];
  if constexpr (kTaps != 0) {
#pragma unroll
    for (int k = 0; k < kTaps; ++k) taps_r[k] = taps_s[k];
  }
  auto tap = [&](int k) {
    if constexpr (kTaps != 0) {
      return taps_r[k];
    } else {
      return taps_s[k];
    }
  };

  const int r_base = blockIdx.y * kRows;    // tile's first row, of the packet
  const int c_base = blockIdx.x * kTileW;   // its first column, of the window
  const int rows_here = min(kRows, n_rows - r_base);
  const int band_w = min(kTileW, n_cols - c_base) + K - 1;

  // vertical pass: item (g, x) is rows [g * kRowsPerThread, +kRowsPerThread)
  // of band column x
  for (int item = tid; item < kGroups * kSlots; item += kThreads) {
    const int g = item / kSlots, x = item - g * kSlots;
    const int r0 = g * kRowsPerThread;
    if (x >= band_w || r0 >= rows_here) continue;
    const float* src = img + static_cast<size_t>(row0 + r_base + r0) * wp +
                       col0 + c_base + x;
    float acc[kRowsPerThread];
    if (r0 + kRowsPerThread <= rows_here) {
      vertical<kRowsPerThread, false>(acc, src, wp, K, 0, tap);
    } else {
      vertical<kRowsPerThread, true>(acc, src, wp, K,
                                     rows_here - r0 + K - 1, tap);
    }
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) sums[r0 + r][x] = acc[r];
  }
  __syncthreads();

  // horizontal pass: warp w makes rows w, w + kWarps, ...; lane l makes
  // tile columns [4l, 4l + 4)
  const int lane = tid & 31, warp = tid >> 5;
  const int c = 4 * lane;
  if (c_base + c >= n_cols) return;
  const bool vec_store = n_cols % 4 == 0 && c_base + c + 4 <= n_cols;
#pragma unroll
  for (int j = 0; j < kRows / kWarps; ++j) {
    const int r = warp + j * kWarps;
    if (r >= rows_here) break;
    const float4* s4 = reinterpret_cast<const float4*>(&sums[r][c]);
    float o[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int q = 0; q < (K + 6) / 4; ++q) {
      const float4 f = s4[q];
      const float v[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const int k = 4 * q + e - p;
          if (k >= 0 && k < K) o[p] = fmaf(tap(k), v[e], o[p]);
        }
      }
    }
    float* dst = out + static_cast<size_t>(r_base + r) * n_cols + c_base + c;
    if (vec_store) {
      *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        if (c_base + c + p < n_cols) dst[p] = o[p];
      }
    }
  }
}

// One launch over output rows [row0, row0+n_rows) x columns [col0,
// col0+n_cols) (in output pixels; the padded image has K-1 more of each).
template <int kTaps, int kRows, int kRowsPerThread, int kWarps,
          int kMinBlocks>
cudaError_t launch(const float* img, const float* w, float* out, int row0,
                   int n_rows, int col0, int n_cols, int wp, int K,
                   cudaStream_t stream) {
  if (n_rows > 0 && n_cols > 0) {
    const dim3 grid((n_cols + kTileW - 1) / kTileW,
                    (n_rows + kRows - 1) / kRows);
    gaussian_kernel<kTaps, kRows, kRowsPerThread, kWarps, kMinBlocks>
        <<<grid, 32 * kWarps, 0, stream>>>(img, w, out, row0, n_rows, col0,
                                           n_cols, wp, K);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int gaussian_blur_rows(const float* img, const float* w,
                                  float* out, int row0, int n_rows, int col0,
                                  int n_cols, int hp, int wp, int K,
                                  void* stream) {
  if (K < 1 || K > kMaxTaps || row0 < 0 || n_rows < 0 || col0 < 0 ||
      n_cols < 0 || row0 + n_rows + K - 1 > hp ||
      col0 + n_cols + K - 1 > wp) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // tiles of 40 rows x 128 columns, a thread a column of the band, 5
  // warps, 4 CTAs an SM (kernel_variants.py times other shapes)
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      K == 31 ? launch<31, 40, 40, 5, 4>(img, w, out, row0, n_rows, col0,
                                         n_cols, wp, K, s)
              : launch<0, 40, 40, 5, 4>(img, w, out, row0, n_rows, col0,
                                        n_cols, wp, K, s));
}
