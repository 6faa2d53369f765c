// Mandelbrot escape-iteration counts of a pixel tile.
//
// Replaces the TPU kernel src/repro/kernels/mandelbrot/kernel.py:49
// escape_counts (_mandel_kernel, :24), which runs the fixed max_iter loop
// over a row tile with a liveness mask.  Plain version: repro_torch/
// kernels/mandelbrot/ref.py escape_counts.
//
// Bound on an H100: float32 operations, 8 per iteration actually executed
// (the counts this run's pixels reach); the output is 4 bytes a pixel.
// What limits it is the SMs' instruction rate: the counts are compared
// exactly, so no operation of an iteration may be contracted, and each
// takes a float32 instruction slot of its own.
//
// Design: one thread per pixel with early exit, as the OpenCL kernel.  Once
// a pixel escapes the plain version freezes its z, so it never counts
// again: stopping there gives the masked fixed loop's counts, and the
// per-row irregularity the paper balances comes back.
// - The iterations run in blocks of U with no branch inside a block: the
//   escape test of each step folds into a sticky predicate (NaN fails it,
//   as the escape test wants).  A block whose test failed is rolled back to
//   the z saved at its start and finished by the checked one-step loop,
//   which stops at the escape: no step after an escape is ever kept, so
//   the count is exact by construction.  The last max_iter % U steps take
//   the checked loop too.  A step is 3 FMUL, 3 FADD, 1 FFMA and 1 FSETP;
//   the block's two branches, counter and loop test are spread over U
//   steps (the saves cost no instruction).
// - zi' = fmaf(zr * zi, 2, ci): scaling by 2 is exact, so this is the
//   plain version's round(round(2 zr) zi) + ci, rounded once more, except
//   where zr * zi is subnormal (absorbed by ci, which is never that small
//   on this grid) or overflows (only after an escape, which is rolled
//   back).  Every other operation is an _rn intrinsic in the plain
//   version's order; the source is built with -fmad=false, which does not
//   touch an explicit __fmaf_rn.  The coordinates' division is IEEE.
// The tile is (row0, n_rows) x (col0, n_cols), so one kernel serves row
// packets and 2-D tiles.
#include <cuda_runtime.h>

namespace {

constexpr float kX0 = -2.25f, kX1 = 0.75f;
constexpr float kY0 = -1.5f, kY1 = 1.5f;
// iterations a block, of the entry point's kernel: 8.25 instructions an
// iteration against 8.5 at U = 8 (kernel_variants.py times others)
constexpr int kUnroll = 16;

// lo + ((hi - lo) * (i + 0.5)) / extent, as the plain version computes it
__device__ __forceinline__ float axis(int i, float lo, float hi,
                                      int extent) {
  const float t = __fadd_rn(static_cast<float>(i), 0.5f);
  return __fadd_rn(lo, __fdiv_rn(__fmul_rn(hi - lo, t),
                                 static_cast<float>(extent)));
}

// One iteration z <- z^2 + c; returns whether |z|^2 <= 4 held before it.
__device__ __forceinline__ bool step(float& zr, float& zi, float cr,
                                     float ci) {
  const float zr2 = __fmul_rn(zr, zr);
  const float zi2 = __fmul_rn(zi, zi);
  const bool inside = __fadd_rn(zr2, zi2) <= 4.0f;
  zi = __fmaf_rn(__fmul_rn(zr, zi), 2.0f, ci);
  zr = __fadd_rn(__fsub_rn(zr2, zi2), cr);
  return inside;
}

template <int U>
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
  const int blocked = max_iter - max_iter % U;
  while (cnt < blocked) {
    const float sr = zr, si = zi;
    bool ok = true;
#pragma unroll
    for (int u = 0; u < U; ++u) ok &= step(zr, zi, cr, ci);
    if (!ok) {
      zr = sr;
      zi = si;
      break;
    }
    cnt += U;
  }
  // at most U - 1 steps after a roll-back, max_iter % U after the blocks
  while (cnt < max_iter && step(zr, zi, cr, ci)) ++cnt;
  out[static_cast<size_t>(r) * n_cols + c] = cnt;
}

template <int U>
cudaError_t launch(int* out, int row0, int n_rows, int col0, int n_cols,
                   int width, int height, int max_iter, cudaStream_t stream) {
  if (n_rows > 0 && n_cols > 0) {
    const dim3 block(32, 8);
    const dim3 grid((n_cols + block.x - 1) / block.x,
                    (n_rows + block.y - 1) / block.y);
    mandelbrot_kernel<U><<<grid, block, 0, stream>>>(
        out, row0, n_rows, col0, n_cols, width, height, max_iter);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int mandelbrot_counts(int* out, int row0, int n_rows, int col0,
                                 int n_cols, int width, int height,
                                 int max_iter, void* stream) {
  return static_cast<int>(launch<kUnroll>(out, row0, n_rows, col0, n_cols,
                                          width, height, max_iter,
                                          static_cast<cudaStream_t>(stream)));
}
