// Sphere-scene ray tracing of a pixel tile on the host CPU: one bounce of
// Lambert shading with hard shadows.
//
// The host group's counterpart of the JAX package's jitted entries
// src/repro/kernels/ray/ops.py:15 (_run) and :29 (_run_tile).  Plain
// version: repro_torch/kernels/ray/ref.py render_rows, whose pixels this
// routine equals bit for bit (a card renders the plain version with the
// same roundings): float32 constants (1e-3f, 1e-6f, 0.15f, 0.85f, the light
// and the background); every dot product adds x, y and z in that order;
// IEEE division and the correctly rounded sqrtf; each operation rounded on
// its own (-ffp-contract=off); the nearest sphere is the first of equal
// distances, and a ray that misses them all takes sphere 0 (argmin).
// Design: one pixel at a time, a row of the tile a chunk; the distances to
// every sphere in one loop that vectorises, then the first minimum.  A
// pixel that misses takes the background without the shading and shadow
// ray, whose results the plain version computes and then drops.
#include <cmath>
#include <cstdint>
#include <limits>
#include <vector>

#include "parallel.h"

namespace {

constexpr float kLight[3] = {8.0f, 10.0f, -2.0f};
constexpr float kBackground[3] = {0.05f, 0.05f, 0.1f};

struct Scene {
  const float* cx;
  const float* cy;
  const float* cz;
  const float* rr;   // radius * radius
  int n;
};

inline float dot3(const float* a, const float* b) {
  return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2];
}

// t of the nearest hit along o + t d (inf for a miss) and its sphere;
// t_buf holds the scene's n distances
inline float intersect(const Scene& sc, const float* o, const float* d,
                       float* t_buf, int* idx) {
  const float inf = std::numeric_limits<float>::infinity();
  for (int s = 0; s < sc.n; ++s) {
    const float ocx = o[0] - sc.cx[s];
    const float ocy = o[1] - sc.cy[s];
    const float ocz = o[2] - sc.cz[s];
    const float b = (ocx * d[0] + ocy * d[1]) + ocz * d[2];
    const float c = ((ocx * ocx + ocy * ocy) + ocz * ocz) - sc.rr[s];
    const float disc = b * b - c;
    const bool ok = disc > 0.0f;
    const float sq = std::sqrt(ok ? disc : 0.0f);
    const float t0 = -b - sq;
    const float t1 = -b + sq;
    const float t = t0 > 1e-3f ? t0 : t1;
    t_buf[s] = (ok && t > 1e-3f) ? t : inf;
  }
  int best = 0;
  for (int s = 1; s < sc.n; ++s) {
    if (t_buf[s] < t_buf[best]) best = s;
  }
  *idx = best;
  return t_buf[best];
}

inline void normalise(float* x, float floor) {
  const float len = std::sqrt(dot3(x, x));
  const float div = len < floor ? floor : len;
  for (int c = 0; c < 3; ++c) x[c] = x[c] / div;
}

}  // namespace

// out (n_rows, n_cols, 3) = shades of the pixels with ray-direction
// coordinates xs[c] and ys[r] (slices of ref.py pixel_axes) in the scene
// of n_spheres (n_spheres, 3) centers, (n_spheres,) radii and
// (n_spheres, 3) colors
extern "C" int host_ray_render(const float* centers, const float* radii,
                               const float* colors, int n_spheres,
                               const float* xs, const float* ys, float* out,
                               int n_rows, int n_cols, int n_threads) {
  if (n_spheres < 1 || n_rows < 0 || n_cols < 0) {
    return repro_host::kBadArgument;
  }
  std::vector<float> soa;
  try {
    soa.resize(4 * static_cast<size_t>(n_spheres));
  } catch (const std::exception&) {
    return repro_host::kFailed;
  }
  for (int s = 0; s < n_spheres; ++s) {
    soa[s] = centers[3 * s];
    soa[n_spheres + s] = centers[3 * s + 1];
    soa[2 * n_spheres + s] = centers[3 * s + 2];
    soa[3 * n_spheres + s] = radii[s] * radii[s];
  }
  const Scene sc{soa.data(), soa.data() + n_spheres,
                 soa.data() + 2 * n_spheres, soa.data() + 3 * n_spheres,
                 n_spheres};
  return repro_host::parallel_for(n_rows, n_threads, [&](int64_t r) {
    std::vector<float> t_buf(n_spheres);
    const float zero[3] = {0.0f, 0.0f, 0.0f};
    for (int c = 0; c < n_cols; ++c) {
      float* px = out + (r * n_cols + c) * 3;
      float d[3] = {xs[c], -ys[r], 1.0f};
      normalise(d, 0.0f);
      int idx;
      const float t = intersect(sc, zero, d, t_buf.data(), &idx);
      if (!std::isfinite(t)) {
        for (int k = 0; k < 3; ++k) px[k] = kBackground[k];
        continue;
      }
      float p[3], nrm[3], l[3], o2[3];
      for (int k = 0; k < 3; ++k) p[k] = zero[k] + d[k] * t;
      const float* ctr = centers + 3 * idx;
      for (int k = 0; k < 3; ++k) nrm[k] = p[k] - ctr[k];
      normalise(nrm, 1e-6f);
      for (int k = 0; k < 3; ++k) l[k] = kLight[k] - p[k];
      normalise(l, 1e-6f);
      const float dl = dot3(nrm, l);
      const float lam = dl < 0.0f ? 0.0f : dl;
      for (int k = 0; k < 3; ++k) o2[k] = p[k] + nrm[k] * 1e-3f;
      int idx_s;
      const float ts = intersect(sc, o2, l, t_buf.data(), &idx_s);
      const float lit = std::isfinite(ts) ? 0.0f : 1.0f;
      const float shade = 0.15f + (0.85f * lam) * lit;
      for (int k = 0; k < 3; ++k) px[k] = colors[3 * idx + k] * shade;
    }
  });
}
