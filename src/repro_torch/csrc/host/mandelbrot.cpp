// Mandelbrot escape-iteration counts of a pixel tile on the host CPU.
//
// The host group's counterpart of the JAX package's jitted range entries
// src/repro/kernels/mandelbrot/ops.py:20 (_run) and :38 (_run_tile).  Plain
// version: repro_torch/kernels/mandelbrot/ref.py escape_counts, whose counts
// this routine equals bit for bit:
// - the pixel coordinates come in as float32 arrays from the plain
//   version's _axis (numpy, IEEE division);
// - an iteration is spelled as ref.py spells it: the escape test
//   (zr2 + zi2) <= 4 on the z before it, then (zr2 - zi2) + cr and
//   ((2 zr) zi) + ci, each operation rounded on its own (-ffp-contract=off;
//   csrc/mandelbrot.cu keeps the same order on the card);
// - an escaped pixel's z is frozen and its count no longer moves, so
//   stopping once every pixel of a block has escaped changes no count.
// Design: a block of kLanes pixels of one row iterates in lockstep, the
// escape test a mask (the loop over lanes vectorises); every kCheckEvery
// iterations the block stops if no lane is left.  Chunks of a row's
// columns are pulled by the threads (parallel.h): rows near the set take
// far longer than rows far from it.
#include <cstdint>

#include "parallel.h"

namespace {

constexpr int kLanes = 32;
constexpr int kCheckEvery = 8;
constexpr int kChunkCols = 128;

void escape_block(const float* cr_in, float ci, int n, int max_iter,
                  int32_t* out) {
  float cr[kLanes], zr[kLanes], zi[kLanes];
  int32_t cnt[kLanes];
  for (int l = 0; l < kLanes; ++l) {
    // a padding lane starts at c = 4 + ci i, which escapes at once
    cr[l] = l < n ? cr_in[l] : 4.0f;
    zr[l] = 0.0f;
    zi[l] = 0.0f;
    cnt[l] = 0;
  }
  for (int it = 0; it < max_iter;) {
    const int stop = it + kCheckEvery < max_iter ? it + kCheckEvery
                                                 : max_iter;
    for (; it < stop; ++it) {
      for (int l = 0; l < kLanes; ++l) {
        const float zr2 = zr[l] * zr[l];
        const float zi2 = zi[l] * zi[l];
        const bool alive = (zr2 + zi2) <= 4.0f;
        const float nzr = (zr2 - zi2) + cr[l];
        const float nzi = ((2.0f * zr[l]) * zi[l]) + ci;
        zr[l] = alive ? nzr : zr[l];
        zi[l] = alive ? nzi : zi[l];
        cnt[l] += alive ? 1 : 0;
      }
    }
    bool any = false;
    for (int l = 0; l < kLanes; ++l) {
      any |= (zr[l] * zr[l] + zi[l] * zi[l]) <= 4.0f;
    }
    if (!any) break;
  }
  for (int l = 0; l < n; ++l) out[l] = cnt[l];
}

}  // namespace

// out (n_rows, n_cols) int32 counts of the pixels xs[c] + ys[r] i.
extern "C" int host_mandelbrot_counts(int32_t* out, const float* xs,
                                      const float* ys, int n_rows,
                                      int n_cols, int max_iter,
                                      int n_threads) {
  if (n_rows < 0 || n_cols < 0 || max_iter < 0) {
    return repro_host::kBadArgument;
  }
  const int64_t per_row = (n_cols + kChunkCols - 1) / kChunkCols;
  return repro_host::parallel_for(
      per_row * n_rows, n_threads, [&](int64_t chunk) {
        const int r = static_cast<int>(chunk / per_row);
        const int c1 = static_cast<int>(chunk % per_row) * kChunkCols;
        const int c2 = c1 + kChunkCols < n_cols ? c1 + kChunkCols : n_cols;
        for (int c = c1; c < c2; c += kLanes) {
          const int n = c2 - c < kLanes ? c2 - c : kLanes;
          escape_block(xs + c, ys[r], n, max_iter,
                       out + static_cast<int64_t>(r) * n_cols + c);
        }
      });
}
