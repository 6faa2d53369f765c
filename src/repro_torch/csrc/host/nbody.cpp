// One Euler step of all-pairs gravitation for a slice of targets, on the
// host CPU.
//
// The host group's counterpart of the JAX package's jitted range entry
// src/repro/kernels/nbody/ops.py:25 (_run).  Plain version:
// repro_torch/kernels/nbody/ref.py step_rows: the interaction
// rsqrt(r2) / r2 * m, spelled 1.0f / sqrtf(r2) / r2 * m, r2 = (dx dx +
// dy dy + dz dz) + eps2, then v = vel + acc dt and p = pos + v dt, rows
// [x, y, z, m, vx, vy, vz] out.  The acceleration's sum over sources runs
// in another order than torch's reduction, so the rows agree to rtol/atol
// 2e-4, as the JAX package's kernel test holds them.
// Design: the sources are copied once into four arrays (x, y, z, m); a
// chunk is kTargets targets, which share each source's loads.  Each target
// sums its float32 acceleration in kLanes partial sums, partial l taking
// sources j = l mod kLanes in increasing j, then adds the partials in lane
// order: a fixed order that lets the loop over lanes vectorise without
// -ffast-math.  A partial sums the sources of one block of kBlock (128 a
// lane) into a block sum, which it then adds to its total: at the paper's
// size a running sum takes 128 terms and a total 112, where one running
// sum over a lane's 14,336 sources ended 10x further from float64 than
// the plain version.
// A short last chunk repeats its last target, so every target takes the
// same code and its row does not depend on the chunk it falls in or the
// number of threads.
#include <cmath>
#include <cstdint>
#include <vector>

#include "parallel.h"

namespace {

constexpr int kLanes = 16;
constexpr int kTargets = 4;
constexpr int kBlock = 128 * kLanes;

}  // namespace

// out (n_tgt, 7) rows of bodies [tgt0, tgt0 + n_tgt) of the (n, 4)
// [x, y, z, m] pos_mass and (n, 3) vel after one step of dt
extern "C" int host_nbody_step(const float* pos_mass, const float* vel,
                               float* out, int n, int tgt0, int n_tgt,
                               float eps2, float dt, int n_threads) {
  if (n < 0 || tgt0 < 0 || n_tgt < 0 || tgt0 + n_tgt > n) {
    return repro_host::kBadArgument;
  }
  if (n_tgt == 0) return repro_host::kOk;
  std::vector<float> soa;
  try {
    soa.resize(4 * static_cast<size_t>(n));
  } catch (const std::exception&) {
    return repro_host::kFailed;
  }
  float* sx = soa.data();
  float* sy = sx + n;
  float* sz = sy + n;
  float* sm = sz + n;
  for (int64_t j = 0; j < n; ++j) {
    sx[j] = pos_mass[4 * j];
    sy[j] = pos_mass[4 * j + 1];
    sz[j] = pos_mass[4 * j + 2];
    sm[j] = pos_mass[4 * j + 3];
  }
  const int64_t n_chunks = (n_tgt + kTargets - 1) / kTargets;
  const int n_full = n - n % kLanes;
  return repro_host::parallel_for(n_chunks, n_threads, [&](int64_t chunk) {
    const int first = tgt0 + static_cast<int>(chunk) * kTargets;
    const int count = tgt0 + n_tgt - first < kTargets
                          ? tgt0 + n_tgt - first : kTargets;
    float tx[kTargets], ty[kTargets], tz[kTargets];
    for (int q = 0; q < kTargets; ++q) {
      const int64_t i = first + (q < count ? q : count - 1);
      tx[q] = sx[i];
      ty[q] = sy[i];
      tz[q] = sz[i];
    }
    float ax[kTargets][kLanes] = {}, ay[kTargets][kLanes] = {},
          az[kTargets][kLanes] = {};
    float bx[kTargets][kLanes], by[kTargets][kLanes], bz[kTargets][kLanes];
    auto interact = [&](int q, int l, int j) {
      const float dx = sx[j] - tx[q];
      const float dy = sy[j] - ty[q];
      const float dz = sz[j] - tz[q];
      const float r2 = ((dx * dx + dy * dy) + dz * dz) + eps2;
      const float s = 1.0f / std::sqrt(r2) / r2 * sm[j];
      bx[q][l] = bx[q][l] + dx * s;
      by[q][l] = by[q][l] + dy * s;
      bz[q][l] = bz[q][l] + dz * s;
    };
    for (int b0 = 0; b0 < n; b0 += kBlock) {
      const int b1 = b0 + kBlock < n ? b0 + kBlock : n;
      const int full = b1 < n_full ? b1 : n_full;
      for (int q = 0; q < kTargets; ++q) {
        for (int l = 0; l < kLanes; ++l) {
          bx[q][l] = 0.0f;
          by[q][l] = 0.0f;
          bz[q][l] = 0.0f;
        }
      }
      for (int j0 = b0; j0 < full; j0 += kLanes) {
        for (int q = 0; q < kTargets; ++q) {
          for (int l = 0; l < kLanes; ++l) interact(q, l, j0 + l);
        }
      }
      for (int q = 0; q < kTargets; ++q) {
        for (int j = full; j < b1; ++j) interact(q, j - full, j);
        for (int l = 0; l < kLanes; ++l) {
          ax[q][l] = ax[q][l] + bx[q][l];
          ay[q][l] = ay[q][l] + by[q][l];
          az[q][l] = az[q][l] + bz[q][l];
        }
      }
    }
    for (int q = 0; q < count; ++q) {
      float acc[3] = {0.0f, 0.0f, 0.0f};
      for (int l = 0; l < kLanes; ++l) {
        acc[0] = acc[0] + ax[q][l];
        acc[1] = acc[1] + ay[q][l];
        acc[2] = acc[2] + az[q][l];
      }
      const int64_t i = first + q;
      float* row = out + (i - tgt0) * 7;
      const float t[3] = {tx[q], ty[q], tz[q]};
      for (int c = 0; c < 3; ++c) {
        const float v = vel[3 * i + c] + acc[c] * dt;
        row[c] = t[c] + v * dt;
        row[4 + c] = v;
      }
      row[3] = sm[i];
    }
  });
}
