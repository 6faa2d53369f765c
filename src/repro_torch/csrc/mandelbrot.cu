// Mandelbrot escape-iteration counts of a pixel tile.
//
// Replaces the TPU kernel src/repro/kernels/mandelbrot/kernel.py:49
// escape_counts (_mandel_kernel, :24), which runs the fixed max_iter loop
// over a row tile with a liveness mask.  Plain version: repro_torch/
// kernels/mandelbrot/ref.py escape_counts.
//
// Bound on an H100: float32 operations, 8 per iteration actually executed
// (the counts this run's pixels reach); the output is 4 bytes a pixel.
//
// Design: the OpenCL one-thread-per-pixel mapping with early exit.  Once a
// pixel escapes the plain version freezes its z, so it can never count
// again: stopping there gives the same counts as the masked fixed loop,
// and the per-row irregularity the paper balances comes back.  The counts
// are compared exactly with the plain version, so every operation is an
// _rn intrinsic in the plain version's order (never contracted into an
// FMA; the source is also built with -fmad=false) and the division is
// IEEE.  The tile is (row0, n_rows) x (col0, n_cols), so one kernel serves
// row packets and 2-D tiles.
#include <cuda_runtime.h>

namespace {

constexpr float kX0 = -2.25f, kX1 = 0.75f;
constexpr float kY0 = -1.5f, kY1 = 1.5f;

// lo + ((hi - lo) * (i + 0.5)) / extent, as the plain version computes it
__device__ __forceinline__ float axis(int i, float lo, float hi,
                                      int extent) {
  const float t = __fadd_rn(static_cast<float>(i), 0.5f);
  return __fadd_rn(lo, __fdiv_rn(__fmul_rn(hi - lo, t),
                                 static_cast<float>(extent)));
}

__global__ void mandelbrot_kernel(int* __restrict__ out, int row0, int n_rows,
                                  int col0, int n_cols, int width, int height,
                                  int max_iter) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (c >= n_cols || r >= n_rows) return;
  const float cr = axis(col0 + c, kX0, kX1, width);
  const float ci = axis(row0 + r, kY0, kY1, height);
  float zr = 0.0f, zi = 0.0f;
  int cnt = 0;
  for (; cnt < max_iter; ++cnt) {
    const float zr2 = __fmul_rn(zr, zr);
    const float zi2 = __fmul_rn(zi, zi);
    if (!(__fadd_rn(zr2, zi2) <= 4.0f)) break;
    const float nzr = __fadd_rn(__fsub_rn(zr2, zi2), cr);
    const float nzi = __fadd_rn(__fmul_rn(__fmul_rn(2.0f, zr), zi), ci);
    zr = nzr;
    zi = nzi;
  }
  out[static_cast<size_t>(r) * n_cols + c] = cnt;
}

}  // namespace

extern "C" int mandelbrot_counts(int* out, int row0, int n_rows, int col0,
                                 int n_cols, int width, int height,
                                 int max_iter, void* stream) {
  if (n_rows > 0 && n_cols > 0) {
    const dim3 block(32, 8);
    const dim3 grid((n_cols + block.x - 1) / block.x,
                    (n_rows + block.y - 1) / block.y);
    mandelbrot_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        out, row0, n_rows, col0, n_cols, width, height, max_iter);
  }
  return static_cast<int>(cudaGetLastError());
}
