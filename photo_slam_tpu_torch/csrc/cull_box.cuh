// The per-entry box by which the blend kernels K1 (blend_fwd.cu) and K2
// (blend_bwd.cu) skip their warps: a pixel-space rectangle that holds every
// pixel at which the kernels' own rounding can find power <= 0 and
// alpha >= 1/255, the only pairs at which either kernel changes any state.
// ops/blend.py::entry_cull_boxes is its plain version; the constants are
// shared.
//
// A pair the kernels count as valid has o e^p' >= m (1 - 3e-7), m =
// kAlphaMin, for its rounded power p' (expf within 2 ulp, one rounded
// product), and p' within 4 u S of the exact power of the rounded dx, dy,
// where S = (|a| dx^2 + |c| dy^2) / 2 + |b dx dy| and u = 2^-24. So its
// |dx|, |dy| satisfy
//   (1 - g)(a dx^2 + c dy^2) - 2 (1 + g)|b dx dy| <= 2 (L + e),
// g = kCullRel >= 4 u, e = kCullAbs >= 3e-7, L = ln(o / m): an ellipse in
// (|dx|, |dy|) when a > 0 and det' = a c (1-g)^2 - b^2 (1+g)^2 > 0, whose
// half-widths are sqrt(2 (L + e) c (1 - g) / det') and the same with a. The
// box widens L + e by kCullScale and the half-widths by kCullPad px (the
// margins of ops/preprocess.py::tight_extents), computed in double. An
// entry with o < 1/255 has an empty box (o e^p' <= o for p' <= 0); one with
// a non-finite term, a <= 0 or det' <= kCullMinDet a c is unbounded.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

constexpr double kCullRel = 1e-6;
constexpr double kCullAbs = 1e-6;
constexpr double kCullScale = 1.001;
constexpr double kCullMinDet = 1e-9;
constexpr float kCullPad = 1.0f;

// (x_lo, x_hi, y_lo, y_hi) in image pixels of the entry whose mean is
// (mx, my), conic (a, b, c) and opacity o.
__device__ __forceinline__ float4 cull_box(float mx, float my, float a,
                                           float b, float c, float o) {
  const float kAlphaMin = (float)(1.0 / 255.0);
  const float inf = CUDART_INF_F;
  if (!(isfinite(mx) && isfinite(my) && isfinite(a) && isfinite(b) &&
        isfinite(c) && isfinite(o)))
    return make_float4(-inf, inf, -inf, inf);
  if (o < kAlphaMin) return make_float4(inf, -inf, inf, -inf);
  const double g_lo = 1.0 - kCullRel;
  const double g_hi = 1.0 + kCullRel;
  const double ad = a, bd = b, cd = c;
  const double det = ad * cd * (g_lo * g_lo) - bd * bd * (g_hi * g_hi);
  if (!(ad > 0.0) || !(det > kCullMinDet * ad * cd))
    return make_float4(-inf, inf, -inf, inf);
  const double l2 =
      2.0 * (kCullScale * (log((double)o / (double)kAlphaMin) + kCullAbs));
  const float ex = (float)sqrt(l2 * cd * g_lo / det) + kCullPad;
  const float ey = (float)sqrt(l2 * ad * g_lo / det) + kCullPad;
  return make_float4(mx - ex, mx + ex, my - ey, my + ey);
}

// Whether the box misses the rect [x0, x1] x [y0, y1] (image pixels): then
// no pixel of the rect has a pair that either kernel would take. False for
// an unbounded box, true for an empty one.
__device__ __forceinline__ bool box_misses(float4 box, float x0, float x1,
                                           float y0, float y1) {
  return !(box.y >= x0 && box.x <= x1 && box.w >= y0 && box.z <= y1);
}
