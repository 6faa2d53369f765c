// Separable Gaussian blur of an output tile on the host CPU.
//
// The host group's counterpart of the JAX package's jitted entries
// src/repro/kernels/gaussian/ops.py:29 (_run) and :60 (_run_tile).  Plain
// version: repro_torch/kernels/gaussian/ref.py blur_rows_ref, in its order:
// the vertical pass over the window's n_cols + K - 1 padded columns, then
// the horizontal pass, each a sum of the taps k = 0 .. K-1 in turn, every
// product and sum rounded on its own in float32 (-ffp-contract=off).
// Design: one output row a chunk, read straight from the image padded once
// (no copy of the window): the vertical sums of the row in a buffer of the
// thread's, each pass a loop over columns inside the loop over taps, which
// vectorises and keeps each element's order of taps.
#include <cstdint>
#include <vector>

#include "parallel.h"

// out (n_rows, n_cols) = blur of output rows [row0, row0 + n_rows) x cols
// [col0, col0 + n_cols) of the (Hp, Wp) padded image ip with taps w (K,)
extern "C" int host_gaussian_blur_rows(const float* ip, const float* w,
                                       float* out, int row0, int n_rows,
                                       int col0, int n_cols, int Hp, int Wp,
                                       int K, int n_threads) {
  if (K < 1 || row0 < 0 || col0 < 0 || n_rows < 0 || n_cols < 0 ||
      row0 + n_rows + K - 1 > Hp || col0 + n_cols + K - 1 > Wp) {
    return repro_host::kBadArgument;
  }
  const int span = n_cols + K - 1;
  return repro_host::parallel_for(n_rows, n_threads, [&](int64_t r) {
    std::vector<float> tmp(span, 0.0f);
    float* t = tmp.data();
    const float* band = ip + (row0 + r) * static_cast<int64_t>(Wp) + col0;
    for (int k = 0; k < K; ++k) {
      const float wk = w[k];
      const float* src = band + static_cast<int64_t>(k) * Wp;
      for (int j = 0; j < span; ++j) t[j] = t[j] + wk * src[j];
    }
    float* o = out + r * static_cast<int64_t>(n_cols);
    for (int c = 0; c < n_cols; ++c) o[c] = 0.0f;
    for (int k = 0; k < K; ++k) {
      const float wk = w[k];
      for (int c = 0; c < n_cols; ++c) o[c] = o[c] + wk * t[c + k];
    }
  });
}
