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
//
// cull_box_bf16 is the same box for X1's chain (blend_bf16_fwd.cu, plain
// version ops/blend.py::entry_cull_boxes_bf16), whose every operation is
// rounded to bf16, u = 2^-8. Its inputs are the values the chain sees: the
// tile-local mean mx' = bf16(x - ox), my', and a', b', c', o' rounded to
// bf16; the box is in the same tile-local frame. Let dx0 = mx' - lx and
// dy0 = my' - ly exactly. Each rounding is within u' = 2^-8 + 2^-23 of
// its exact result (one that is computed in f32 and then rounded to bf16,
// as torch's bf16 sums are, errs by at most u (1 + 2^-24) + 2^-24). With
// a', c' > 0 (a bounded box needs both):
//   dx = dx0 (1 + d1); a' dx dx = a' dx0^2 (1 + d)^4; likewise c' dy dy;
//   quad, their rounded sum, >= (1 - u')^5 (a' dx0^2 + c' dy0^2), both
//   terms being >= 0; -0.5 quad is exact; the cross term (b' dx) dy is
//   within (1 + u')^4 of |b' dx0 dy0|; and p' = bf16(-0.5 quad - cross).
// A pair with p' <= 0 has -p' = (0.5 quad + cross)(1 + d6) with both
// factors >= 0, so
//   2 (-p') >= (1 - u')^6 (a' dx0^2 + c' dy0^2)
//              - 2 (1 - u')(1 + u')^4 |b' dx0 dy0|,
// and g = kBf16CullRel = 0.025 >= 6 u' covers both factors:
// (1 - u')^6 >= 1 - 6 u' and (1 - u')(1 + u')^4 <= (1 + u')^3 < 1 + 6 u'.
// On the alpha side, e = bf16(expf(p')) <= e^p' (1 + 2^-22)(1 + u) and
// alpha = bf16(o' e) (clamped at bf16(0.99), which never lowers it below
// the threshold) <= o' e (1 + u), so alpha >= m = bf16(1/255) =
// 0.003936767578125 needs -p' <= ln(o' / m) + 2 ln(1 + u) + 2^-22 <
// L + 0.0079, and e = kBf16CullAbs = 0.012 leaves 0.004 for underflow:
// a product that lands below bf16's normal range errs by at most 2^-134
// absolutely, which a later product by |dx| < 2^65 keeps below 2^-68. The
// guard that keeps those bounds true: an entry with o' or |mx'| or |my'|
// >= kBf16CullHuge is unbounded (alpha >= m with o' < 2^64 needs e > 2^-75,
// a normal number, so the exp's relative bound holds). A product that
// overflows gives p' = -inf or NaN, which the chain rejects. So the pair
// lies inside the box computed as above from (mx', my', a', b', c', o')
// with m, g and e; o' < m gives an empty box, as for K1.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

constexpr double kCullRel = 1e-6;
constexpr double kCullAbs = 1e-6;
constexpr double kCullScale = 1.001;
constexpr double kCullMinDet = 1e-9;
constexpr float kCullPad = 1.0f;
constexpr double kBf16CullRel = 0.025;
constexpr double kBf16CullAbs = 0.012;
constexpr float kBf16CullHuge = 18446744073709551616.0f;  // 2^64

// The box of an entry with mean (mx, my), conic (a, b, c) and opacity o
// for a chain with threshold alpha_min and slack rel, abs_slack.
__device__ __forceinline__ float4 entry_box(float mx, float my, float a,
                                            float b, float c, float o,
                                            float alpha_min, double rel,
                                            double abs_slack) {
  const float inf = CUDART_INF_F;
  if (!(isfinite(mx) && isfinite(my) && isfinite(a) && isfinite(b) &&
        isfinite(c) && isfinite(o)))
    return make_float4(-inf, inf, -inf, inf);
  if (o < alpha_min) return make_float4(inf, -inf, inf, -inf);
  const double g_lo = 1.0 - rel;
  const double g_hi = 1.0 + rel;
  const double ad = a, bd = b, cd = c;
  const double det = ad * cd * (g_lo * g_lo) - bd * bd * (g_hi * g_hi);
  if (!(ad > 0.0) || !(det > kCullMinDet * ad * cd))
    return make_float4(-inf, inf, -inf, inf);
  const double l2 =
      2.0 * (kCullScale * (log((double)o / (double)alpha_min) + abs_slack));
  const float ex = (float)sqrt(l2 * cd * g_lo / det) + kCullPad;
  const float ey = (float)sqrt(l2 * ad * g_lo / det) + kCullPad;
  return make_float4(mx - ex, mx + ex, my - ey, my + ey);
}

// (x_lo, x_hi, y_lo, y_hi) in image pixels of the entry whose mean is
// (mx, my), conic (a, b, c) and opacity o: K1's and K2's box.
__device__ __forceinline__ float4 cull_box(float mx, float my, float a,
                                           float b, float c, float o) {
  return entry_box(mx, my, a, b, c, o, (float)(1.0 / 255.0), kCullRel,
                   kCullAbs);
}

// X1's box, in the tile-local frame of the bf16-rounded mean (mx, my),
// from the bf16-rounded conic and opacity (each a bf16 value held as a
// float).
__device__ __forceinline__ float4 cull_box_bf16(float mx, float my, float a,
                                                float b, float c, float o) {
  const float inf = CUDART_INF_F;
  if (o >= kBf16CullHuge || fabsf(mx) >= kBf16CullHuge ||
      fabsf(my) >= kBf16CullHuge)
    return make_float4(-inf, inf, -inf, inf);
  return entry_box(mx, my, a, b, c, o, 0.003936767578125f, kBf16CullRel,
                   kBf16CullAbs);
}

// Whether the box misses the rect [x0, x1] x [y0, y1] (image pixels): then
// no pixel of the rect has a pair that either kernel would take. False for
// an unbounded box, true for an empty one.
__device__ __forceinline__ bool box_misses(float4 box, float x0, float x1,
                                           float y0, float y1) {
  return !(box.y >= x0 && box.x <= x1 && box.w >= y0 && box.z <= y1);
}
