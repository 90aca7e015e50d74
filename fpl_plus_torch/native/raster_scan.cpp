// Raster-scan distance transform (2D and 3D) for the evaluation metrics.
//
// The equivalent of GeodisTK::geodesic{2d,3d}_raster_scan as the reference
// evaluation calls it (PyMIC/pymic/util/evaluation_seg_train.py:122-126,
// 158-162): lamb = 0 on a zero image, i.e. a spacing-weighted chamfer
// distance from the seed voxels over the 26-neighbourhood, relaxed by
// `iters` forward + backward raster passes (the reference uses 2).
//
// A plain C ABI, bound with ctypes (fpl_plus_torch/native/__init__.py).
// Build: g++ -O3 -std=c++17 -shared -fPIC raster_scan.cpp -o libraster_scan.so

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

inline float local_cost(float spatial2, float gray_diff, float lamb) {
  // lamb = 0: the pure spatial step length (the only mode evaluation uses)
  float g = lamb * gray_diff;
  return std::sqrt(spatial2 + g * g);
}

constexpr float kInf = 1e10f;

}  // namespace

extern "C" {

// img: [D*H*W] f32 intensities (zeros for a distance); seeds: [D*H*W] u8,
// nonzero = distance 0; dist: [D*H*W] f32 output; spacing: [3] f32
// (sz, sy, sx).
void raster_scan_distance_3d(const float* img, const uint8_t* seeds,
                             float* dist, int64_t D, int64_t H, int64_t W,
                             const float* spacing, float lamb, int iters) {
  const int64_t n = D * H * W;
  const float sz = spacing[0], sy = spacing[1], sx = spacing[2];
  for (int64_t i = 0; i < n; ++i) dist[i] = seeds[i] ? 0.0f : kInf;

  // the 13 causal neighbours of the forward pass (offsets before (0,0,0) in
  // raster order), mirrored by the backward pass
  struct Nb { int dz, dy, dx; float sp2; };
  std::vector<Nb> nbs;
  for (int dz = -1; dz <= 0; ++dz)
    for (int dy = -1; dy <= 1; ++dy)
      for (int dx = -1; dx <= 1; ++dx) {
        if (dz == 0 && (dy > 0 || (dy == 0 && dx >= 0))) continue;
        float s2 = dz * dz * sz * sz + dy * dy * sy * sy + dx * dx * sx * sx;
        nbs.push_back({dz, dy, dx, s2});
      }

  auto relax = [&](int64_t z, int64_t y, int64_t x, int sign) {
    const int64_t idx = (z * H + y) * W + x;
    float best = dist[idx];
    const float g0 = img[idx];
    for (const Nb& nb : nbs) {
      const int64_t zz = z + sign * nb.dz;
      const int64_t yy = y + sign * nb.dy;
      const int64_t xx = x + sign * nb.dx;
      if (zz < 0 || zz >= D || yy < 0 || yy >= H || xx < 0 || xx >= W)
        continue;
      const int64_t nidx = (zz * H + yy) * W + xx;
      const float cand =
          dist[nidx] + local_cost(nb.sp2, g0 - img[nidx], lamb);
      if (cand < best) best = cand;
    }
    dist[idx] = best;
  };

  for (int it = 0; it < iters; ++it) {
    for (int64_t z = 0; z < D; ++z)
      for (int64_t y = 0; y < H; ++y)
        for (int64_t x = 0; x < W; ++x) relax(z, y, x, +1);
    for (int64_t z = D - 1; z >= 0; --z)
      for (int64_t y = H - 1; y >= 0; --y)
        for (int64_t x = W - 1; x >= 0; --x) relax(z, y, x, -1);
  }
}

// 2D (H, W); spacing = [sy, sx].
void raster_scan_distance_2d(const float* img, const uint8_t* seeds,
                             float* dist, int64_t H, int64_t W,
                             const float* spacing, float lamb, int iters) {
  float sp3[3] = {1.0f, spacing[0], spacing[1]};
  raster_scan_distance_3d(img, seeds, dist, 1, H, W, sp3, lamb, iters);
}

}  // extern "C"
