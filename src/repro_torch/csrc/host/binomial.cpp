// European call options on a binomial lattice, on the host CPU.
//
// The host group's counterpart of the JAX package's jitted range entry
// src/repro/kernels/binomial/ops.py:27 (_run).  Plain version:
// repro_torch/kernels/binomial/ref.py price_options, in its order: dt, the
// up and down factors, the risk-neutral probabilities and the discount
// formed as it forms them, the leaves s0 exp(vdt (2j - steps)), and each
// step of the induction disc (pd v[i] + pu v[i+1]), every operation rounded
// on its own in float32 (-ffp-contract=off).  expf may round otherwise than
// torch's vectorised exp by an ulp, so the values agree to rtol 1e-4 /
// atol 1e-3, as the JAX package's kernel test holds them.
// Design: kLanes options a chunk, in lockstep: the lattice (steps + 1
// nodes x kLanes) in a buffer of the chunk's, node-major so that the loop
// over options vectorises; the front shrinks by one node a step, in place
// (node i is rewritten after node i + 1 is read), so the nodes the plain
// version keeps as trailing garbage are never computed.
#include <cmath>
#include <cstdint>
#include <vector>

#include "parallel.h"

namespace {

constexpr int kLanes = 16;
constexpr float kRiskFree = 0.02f;
constexpr float kVolatility = 0.30f;

}  // namespace

// out (n,) = values of the calls with spot s0, strike k, expiry t (years)
extern "C" int host_binomial_price(const float* s0, const float* strike,
                                   const float* t_years, float* out, int n,
                                   int steps, int n_threads) {
  if (n < 0 || steps < 1) return repro_host::kBadArgument;
  const int64_t n_chunks = (static_cast<int64_t>(n) + kLanes - 1) / kLanes;
  const float fsteps = static_cast<float>(steps);
  return repro_host::parallel_for(n_chunks, n_threads, [&](int64_t chunk) {
    const int64_t a = chunk * kLanes;
    const int m = n - a < kLanes ? static_cast<int>(n - a) : kLanes;
    float vdt[kLanes], pu[kLanes], pd[kLanes], disc[kLanes], sp[kLanes],
        kk[kLanes];
    for (int l = 0; l < kLanes; ++l) {
      // a padding lane prices the chunk's last option again
      const int64_t i = a + (l < m ? l : m - 1);
      const float dt = t_years[i] / fsteps;
      vdt[l] = kVolatility * std::sqrt(dt);
      const float u = std::exp(vdt[l]);
      const float d = 1.0f / u;
      const float g = std::exp(kRiskFree * dt);
      pu[l] = (g - d) / (u - d);
      pd[l] = 1.0f - pu[l];
      disc[l] = std::exp(-kRiskFree * dt);
      sp[l] = s0[i];
      kk[l] = strike[i];
    }
    std::vector<float> lattice(static_cast<size_t>(steps + 1) * kLanes);
    float* v = lattice.data();
    for (int j = 0; j <= steps; ++j) {
      const float e = 2.0f * static_cast<float>(j) - fsteps;
      for (int l = 0; l < kLanes; ++l) {
        const float s_t = sp[l] * std::exp(vdt[l] * e);
        const float x = s_t - kk[l];
        v[j * kLanes + l] = x < 0.0f ? 0.0f : x;
      }
    }
    for (int front = steps; front > 0; --front) {
      for (int i = 0; i < front; ++i) {
        float* vi = v + i * kLanes;
        const float* vn = vi + kLanes;
        for (int l = 0; l < kLanes; ++l) {
          vi[l] = disc[l] * (pd[l] * vi[l] + pu[l] * vn[l]);
        }
      }
    }
    for (int l = 0; l < m; ++l) out[a + l] = v[l];
  });
}
