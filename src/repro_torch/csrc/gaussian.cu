// Separable Gaussian blur of a band of output rows of an edge-padded image.
//
// Replaces the TPU kernel src/repro/kernels/gaussian/kernel.py:36
// blur_rows (_blur_kernel, :21), which assembles a row band plus its K-1
// halo from two VMEM blocks.  Plain version: repro_torch/kernels/gaussian/
// ref.py blur_rows_ref.
//
// Bound on an H100: bytes.  The band's padded rows are read once and the
// output written once (4 bytes each), against 4K operations per output
// pixel (a vertical and a horizontal pass of K taps): 31 operations a
// byte at K=31, under the card's ~20 float32 operations per byte.
//
// Design: one CTA per (kTileH x kTileW) output tile.  The tile plus its
// K-1 halo in both directions is staged in shared memory with coalesced
// row loads; the vertical pass writes (kTileH x kTileW+K-1) partial sums
// to shared memory, and the horizontal pass reads them.  Each pass sums
// k = 0..K-1 in the plain version's order.  The kernel indexes the whole
// padded image from row0, so one launch serves one packet, no slice copy.
#include <cuda_runtime.h>

namespace {

constexpr int kTileH = 32;
constexpr int kTileW = 64;
constexpr int kThreads = 256;
constexpr int kMaxTaps = 63;

size_t smem_bytes(int K) {
  const int bw = kTileW + K - 1;
  return sizeof(float) * static_cast<size_t>((kTileH + K - 1) * bw +
                                             kTileH * bw);
}

__global__ void __launch_bounds__(kThreads)
gaussian_kernel(const float* __restrict__ img, const float* __restrict__ w,
                float* __restrict__ out, int row0, int n_rows, int wp,
                int K) {
  extern __shared__ float smem[];
  __shared__ float taps[kMaxTaps];
  const int wout = wp - (K - 1);
  const int bw = kTileW + K - 1;
  const int bh = kTileH + K - 1;
  float* band = smem;                // bh x bw padded input
  float* tmp = smem + bh * bw;       // kTileH x bw vertical sums
  const int r_base = blockIdx.y * kTileH;
  const int c_base = blockIdx.x * kTileW;
  const int band_rows = n_rows + K - 1;
  for (int k = threadIdx.x; k < K; k += kThreads) taps[k] = w[k];
  for (int idx = threadIdx.x; idx < bh * bw; idx += kThreads) {
    const int rr = idx / bw, cc = idx - (idx / bw) * bw;
    const int gr = r_base + rr, gc = c_base + cc;
    band[idx] = (gr < band_rows && gc < wp)
                    ? img[static_cast<size_t>(row0 + gr) * wp + gc]
                    : 0.0f;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kTileH * bw; idx += kThreads) {
    const int rr = idx / bw, cc = idx - (idx / bw) * bw;
    float acc = 0.0f;
    for (int k = 0; k < K; ++k) acc += taps[k] * band[(rr + k) * bw + cc];
    tmp[idx] = acc;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kTileH * kTileW; idx += kThreads) {
    const int rr = idx / kTileW, cc = idx % kTileW;
    const int orow = r_base + rr, ocol = c_base + cc;
    if (orow < n_rows && ocol < wout) {
      float acc = 0.0f;
      for (int k = 0; k < K; ++k) acc += taps[k] * tmp[rr * bw + cc + k];
      out[static_cast<size_t>(orow) * wout + ocol] = acc;
    }
  }
}

}  // namespace

extern "C" int gaussian_blur_rows(const float* img, const float* w,
                                  float* out, int row0, int n_rows, int hp,
                                  int wp, int K, void* stream) {
  if (K < 1 || K > kMaxTaps || row0 < 0 || row0 + n_rows + K - 1 > hp) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int wout = wp - (K - 1);
  if (n_rows > 0 && wout > 0) {
    const size_t smem = smem_bytes(K);
    cudaFuncSetAttribute(gaussian_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    const dim3 grid((wout + kTileW - 1) / kTileW,
                    (n_rows + kTileH - 1) / kTileH);
    gaussian_kernel<<<grid, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(img, w, out, row0,
                                                           n_rows, wp, K);
  }
  return static_cast<int>(cudaGetLastError());
}
