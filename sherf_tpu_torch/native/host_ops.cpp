// Native host-side data-pipeline kernels for sherf_tpu.
//
// The TPU-VM host prepares rays, AABB intersections and bound masks for
// every item (the per-pixel loops of the reference's dataset helpers,
// e.g. THuman_dataset.py get_rays:13 / get_near_far:67 /
// get_bound_2d_mask:54, which run as NumPy/OpenCV inside torch DataLoader
// workers).  These are the host hot loops when feeding a TPU at full rate;
// here they are multithread-friendly C++ with a plain C ABI consumed via
// ctypes (sherf_tpu/native/__init__.py), with NumPy fallbacks when the
// shared library is unavailable.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// Rays through every pixel: rays_d[i] = ((x, y, 1) @ Kinv^T - T) @ R - origin
// where origin = -R^T T.  Matches geometry/rays.py get_rays_np.
// Kinv, R: row-major 3x3; T: 3.
void generate_rays(int H, int W, const float* Kinv, const float* R,
                   const float* T, float* rays_o, float* rays_d) {
  float origin[3];
  for (int c = 0; c < 3; ++c)
    origin[c] = -(R[0 * 3 + c] * T[0] + R[1 * 3 + c] * T[1] + R[2 * 3 + c] * T[2]);

  for (int y = 0; y < H; ++y) {
    for (int x = 0; x < W; ++x) {
      const float fx = static_cast<float>(x);
      const float fy = static_cast<float>(y);
      // pixel in camera coords: (x, y, 1) @ Kinv^T
      float pc[3];
      for (int c = 0; c < 3; ++c)
        pc[c] = Kinv[c * 3 + 0] * fx + Kinv[c * 3 + 1] * fy + Kinv[c * 3 + 2];
      // world: (pc - T) @ R  (row vector times matrix)
      float pw[3];
      for (int c = 0; c < 3; ++c)
        pw[c] = (pc[0] - T[0]) * R[0 * 3 + c] + (pc[1] - T[1]) * R[1 * 3 + c] +
                (pc[2] - T[2]) * R[2 * 3 + c];
      const int64_t idx = (static_cast<int64_t>(y) * W + x) * 3;
      for (int c = 0; c < 3; ++c) {
        rays_d[idx + c] = pw[c] - origin[c];
        rays_o[idx + c] = origin[c];
      }
    }
  }
}

// Slab-method ray/AABB intersection with the loaders' conventions
// (near_far_aabb_np): bounds padded by margin, |t| distances, misses get
// (0, 1).  bounds: [min xyz, max xyz].
void ray_aabb(int64_t n, const float* rays_o, const float* rays_d,
              const float* bounds, float margin, float* near, float* far,
              uint8_t* mask) {
  const float lo[3] = {bounds[0] - margin, bounds[1] - margin, bounds[2] - margin};
  const float hi[3] = {bounds[3] + margin, bounds[4] + margin, bounds[5] + margin};
  for (int64_t i = 0; i < n; ++i) {
    float tmin = -INFINITY, tmax = INFINITY;
    for (int c = 0; c < 3; ++c) {
      float d = rays_d[i * 3 + c];
      if (d == 0.0f) d = 1e-8f;
      const float o = rays_o[i * 3 + c];
      const float t0 = (lo[c] - o) / d;
      const float t1 = (hi[c] - o) / d;
      tmin = std::max(tmin, std::min(t0, t1));
      tmax = std::min(tmax, std::max(t0, t1));
    }
    const bool hit = tmax > tmin;
    mask[i] = hit ? 1 : 0;
    if (hit) {
      const float a = std::fabs(tmin), b = std::fabs(tmax);
      near[i] = std::min(a, b);
      far[i] = std::max(a, b);
    } else {
      near[i] = 0.0f;
      far[i] = 1.0f;
    }
  }
}

// Scanline fill of a convex polygon into a uint8 mask (OR-accumulating) —
// replaces cv2.fillPoly for the 6 projected box faces of
// get_bound_2d_mask.  pts: (k, 2) int32 vertex loop.
void fill_convex_poly(uint8_t* mask, int H, int W, const int32_t* pts, int k) {
  if (k < 3) return;
  int ymin = H, ymax = -1;
  for (int i = 0; i < k; ++i) {
    ymin = std::min(ymin, pts[i * 2 + 1]);
    ymax = std::max(ymax, pts[i * 2 + 1]);
  }
  ymin = std::max(ymin, 0);
  ymax = std::min(ymax, H - 1);
  for (int y = ymin; y <= ymax; ++y) {
    float xl = INFINITY, xr = -INFINITY;
    for (int i = 0; i < k; ++i) {
      const int j = (i + 1) % k;
      float x0 = static_cast<float>(pts[i * 2]);
      float y0 = static_cast<float>(pts[i * 2 + 1]);
      float x1 = static_cast<float>(pts[j * 2]);
      float y1 = static_cast<float>(pts[j * 2 + 1]);
      if (y0 == y1) {
        if (static_cast<int>(y0) == y) {
          xl = std::min(xl, std::min(x0, x1));
          xr = std::max(xr, std::max(x0, x1));
        }
        continue;
      }
      const float yf = static_cast<float>(y);
      if (yf < std::min(y0, y1) || yf > std::max(y0, y1)) continue;
      const float t = (yf - y0) / (y1 - y0);
      const float x = x0 + t * (x1 - x0);
      xl = std::min(xl, x);
      xr = std::max(xr, x);
    }
    if (xl > xr) continue;
    int a = std::max(static_cast<int>(std::ceil(xl - 0.5f)), 0);
    int b = std::min(static_cast<int>(std::floor(xr + 0.5f)), W - 1);
    for (int x = a; x <= b; ++x) mask[static_cast<int64_t>(y) * W + x] = 1;
  }
}

// The full per-item ray preparation: rays + AABB near/far in one call.
void prepare_rays(int H, int W, const float* Kinv, const float* R,
                  const float* T, const float* bounds, float margin,
                  float* rays_o, float* rays_d, float* near, float* far,
                  uint8_t* mask) {
  generate_rays(H, W, Kinv, R, T, rays_o, rays_d);
  ray_aabb(static_cast<int64_t>(H) * W, rays_o, rays_d, bounds, margin, near,
           far, mask);
}

}  // extern "C"
