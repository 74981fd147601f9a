// Quadrant blend backward at 16x16 px for Hopper (sm_90a): the X4 backward.
//
// Replaces the TPU kernel tools/exp_blend16.py::_bwd_kernel16 (launched by
// blend16_bwd_call). Quadrant q of block b (layout as in blend16_fwd.cu)
// walks its entries back to front from its count - 1, rebuilding each
// pixel's transmittance from final_T, and writes one gradient row per entry
// into d_data [B, K, 4, 16] at [b, k, q]:
//   lanes 0-1  d mean2d = -(a S_x + b S_y, c S_y + b S_x)
//   lane  2    d conic a = -1/2 sum dL/dpower dx^2
//   lane  3    d conic b = -sum dL/dpower dx dy
//   lane  4    d conic c = -1/2 sum dL/dpower dy^2
//   lane  5    d opacity = sum dL/do
//   lanes 6-8  d rgb     = sum alpha T g
// over the quadrant's 256 pixels, dx = mean.x - lx, dy = mean.y - ly in
// quadrant-local pixels. Per entry k and pixel (k < n_contrib, power <= 0,
// alpha >= 1/255) it is K2's step (csrc/blend_bwd.cu): om = max(1 - alpha,
// 0.01), T = T / om, dL/dalpha = g.c T - (Bc + g_T final_T) / om, zero where
// o e^power >= 0.99, dL/do = dL/dalpha e^power, dL/dpower = dL/do o,
// Bc += alpha T g.c. Entry k of quadrant q is d16c[b, k, q, :] (the TPU
// kernel reads its per-pixel terms from a slab that repeats it on sublanes
// 2q and 2q + 1, and its conic from the table; both are this row here).
// Rows at or past the quadrant's count and lanes 9-15 are exact zeros. The
// TPU kernel reduced the per-pixel terms into six spatial moments and the
// colour sums by MXU matmuls; here, as in K2, each thread carries its
// pixels' state in registers and a warp reduces the nine sums directly.
//
// What bounds it on this card: arithmetic, as K2 (an exp, two divisions
// and ~45 operations per contributing pair); the table rows and the pixel
// planes are read once and d_data written once.
//
// Where the earlier design lost its time (1.0979 ms on X4's table
// [836, 768, 4, 16] against K2's 0.9542 ms on the 32 px tiles, though the
// 16 px path has 207.2 M entry-pixel pairs against 457.2 M; 15x its bound,
// NVIDIA H100 80GB HBM3 at 700 W): it was K2's first design, 1.74 ms there:
//   * pixel p = threadIdx.x + 64 j, so each of a quadrant's two warps held
//     rows spread over all 16 of its rows and every entry touched both;
//   * no per-entry box: every pair up to n_contrib paid the power, the exp
//     and the tests, one pixel after another behind branches;
//   * a touched warp reduced its nine sums with nine 5-step shuffle trees,
//     45 shuffles per entry.
// This design is K2's, at 16 px:
//   * a quadrant is two of K2's 16 x 8 px warp blocks: warp w of a quadrant
//     owns its rows 8 w to 8 w + 7, lane l = lx + 8 ly holds pixel
//     (lx + 8 (j & 1), 8 w + ly + 4 (j >> 1)) in slot j, one per 8 x 4
//     quadrant of the warp's block;
//   * the staging thread computes each row's box (cull_box.cuh, shared with
//     K1 and K2) from the row's quadrant-local mean, so the box is in the
//     same frame as dx, dy, and tests it against the rects of the
//     quadrant's two warps, keeping one bit per warp (s_reach). A warp
//     skips an entry, with no power, exp or shuffle, when its bit is clear
//     or when k is at or past the largest n_contrib of its own 128 pixels:
//     every pair it skips is one the pixel loop would have rejected;
//   * a live warp tests its four pixels with no branch between them, then
//     runs the gradient path once per slot in which some lane contributes;
//   * a touched warp reduces its nine sums with K2's 12-shuffle transpose
//     butterfly (butterfly9.cuh); a per-row byte per warp records which
//     warps took part, and the row sum reads only those partials, in warp
//     order: deterministic, no atomics;
//   * one 256-thread block per 32 px block: its four quadrants each on
//     their own two warps, with their own staged rows and their own named
//     barrier (bar.sync 1 + q, 64 threads), so a quadrant never waits for
//     another, and their table rows, adjacent in d16c, are read together;
//   * rows from the walk's start (the quadrant's count, cut to the largest
//     n_contrib of its pixels) up are zero-filled before the walk.
// Predicted before the first timed run: 0.45-0.70 ms on X4's table.
// Measured by tools/time_blend.py --kernel x4b (four rounds in turns, one
// call, NVIDIA H100 80GB HBM3 at 700 W; PERF.md, section 6): 0.8929-0.9081
// ms against the earlier design's 1.0835-1.0909 ms, 13x its bound; without
// the box 0.8986-0.9162, with nine shuffle trees 0.9409-0.9649, with one
// quadrant per 64-thread block 1.2700-1.2805 (72 registers, 8 bytes of
// spills). The prediction missed: it scaled K2's time by the 16 px path's
// entry-pixel pairs, but K2's box already skips most of what 16 px binning
// removes. Here the box skips 26 % of the (entry, warp) pairs and n_contrib
// 2 % (K2: 57 % and 9 %), which leaves 1.16 M live pairs against K2's
// 1.24 M, 2.39 M gradient-path runs against 2.48 M and 44.0 M
// contributing pairs against 46.6 M: the same work as K2, in about K2's
// time (0.9471 ms in that chip_smoke run).
//
// power and alpha are rounded exactly as in the forward (__fmul_rn /
// __fadd_rn, the full-precision expf), so both take the same entries; the
// remaining products may contract into FMAs.

#include <cuda_runtime.h>

#include "butterfly9.cuh"
#include "cull_box.cuh"

namespace {

constexpr int kQuad = 16;
constexpr int kPixels = kQuad * kQuad;  // 256 per quadrant
constexpr int kQuadThreads = 64;        // threads per quadrant: 2 warps
constexpr int kQuadsPerBlock = 4;
constexpr int kThreads = kQuadThreads * kQuadsPerBlock;
constexpr int kWarps = kQuadThreads / 32;  // 2 per quadrant
constexpr int kWarpW = 16;                 // a warp's block: 16 x 8 px
constexpr int kWarpH = 8;
constexpr int kPerThread = 4;              // one pixel per 8 x 4 quadrant
constexpr int kFeat = 16;
constexpr int kQuads = 4;  // table rows per entry, one per quadrant
constexpr int kGrad = kButterflySums;      // gradient lanes 0-8
constexpr int kBatch = kQuadThreads;       // rows staged per round
constexpr int kPartStride = kWarps * kGrad + 1;  // 19 floats per row

// The barrier of one quadrant's 64 threads (named barrier 1 + its slot in
// the block; barrier 0 is __syncthreads').
__device__ __forceinline__ void quad_sync(int slot) {
  asm volatile("bar.sync %0, %1;" ::"r"(slot + 1), "r"(kQuadThreads)
               : "memory");
}

__global__ void __launch_bounds__(kThreads)
blend16_bwd_kernel(const float* __restrict__ d16c,
                   const int* __restrict__ counts_q,
                   const float* __restrict__ final_t,
                   const int* __restrict__ n_contrib,
                   const float* __restrict__ g_color,
                   const float* __restrict__ g_t, int k_max,
                   float* __restrict__ d_data) {
  const float kAlphaMax = 0.99f;
  const float kAlphaMin = (float)(1.0 / 255.0);

  __shared__ float2 s_xy_[kQuadsPerBlock][kBatch];
  __shared__ float4 s_conic_o_[kQuadsPerBlock][kBatch];  // a, b, c, opacity
  __shared__ float s_rgb_[kQuadsPerBlock][3][kBatch];
  // Bit w: the row's box reaches warp w of the quadrant.
  __shared__ unsigned char s_reach_[kQuadsPerBlock][kBatch];
  __shared__ unsigned short s_touched_[kQuadsPerBlock][kBatch];  // byte w
  __shared__ float s_part_[kQuadsPerBlock][kBatch * kPartStride];
  __shared__ int s_warp_nc_[kQuadsPerBlock][kWarps];

  const int slot = threadIdx.x / kQuadThreads;  // the quadrant in the block
  const int quad = blockIdx.x * kQuadsPerBlock + slot;  // 4 b + q
  const int b = quad >> 2;
  const int q = quad & 3;
  const int tid = threadIdx.x % kQuadThreads;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float2* s_xy = s_xy_[slot];
  float4* s_conic_o = s_conic_o_[slot];
  float(*s_rgb)[kBatch] = s_rgb_[slot];
  unsigned char* s_reach = s_reach_[slot];
  unsigned short* s_touched = s_touched_[slot];
  float* s_part = s_part_[slot];
  int* s_warp_nc = s_warp_nc_[slot];

  // Row [b, k, q] of d16c and d_data: kQuads * kFeat floats apart in k.
  const size_t row0 = ((size_t)b * k_max * kQuads + q) * kFeat;
  const size_t rstride = (size_t)kQuads * kFeat;
  const float* rows = d16c + row0;
  const size_t pix0 = (size_t)b * 4 * kPixels + (size_t)q * kPixels;
  const size_t col0 = (size_t)b * 3 * 4 * kPixels + (size_t)q * kPixels;

  // This thread's pixel in each of its warp's 16 x 8 block's four 8 x 4
  // quadrants (quadrant-local pixels): pixel j at (cx + 8 (j & 1),
  // cy + 4 (j >> 1)).
  const int cx = lane & 7;
  const int cy = warp * kWarpH + (lane >> 3);
  const int my_sum = butterfly9_sum(lane);

  float px[kPerThread], py[kPerThread], T[kPerThread], Bc[kPerThread];
  float gr[kPerThread], gg[kPerThread], gb[kPerThread], gtt[kPerThread];
  int nc[kPerThread];
  int nc_max = 0;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int x = cx + (j & 1) * (kWarpW / 2);
    const int y = cy + (j >> 1) * (kWarpH / 2);
    const int p = y * kQuad + x;
    px[j] = (float)x;
    py[j] = (float)y;
    T[j] = final_t[pix0 + p];
    Bc[j] = 0.0f;
    gr[j] = g_color[col0 + p];
    gg[j] = g_color[col0 + 4 * kPixels + p];
    gb[j] = g_color[col0 + 8 * kPixels + p];
    gtt[j] = g_t[pix0 + p] * T[j];
    nc[j] = n_contrib[pix0 + p];
    nc_max = max(nc_max, nc[j]);
  }
  // The warp skips by its own pixels' largest n_contrib; the quadrant's
  // largest bounds the walk.
  nc_max = __reduce_max_sync(0xffffffffu, nc_max);
  if (lane == 0) s_warp_nc[warp] = nc_max;
  quad_sync(slot);
  int quad_nc = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) quad_nc = max(quad_nc, s_warp_nc[w]);
  const int count = min(min(max(counts_q[quad], 0), k_max), quad_nc);

  // Rows from the walk's start up: exact zeros.
  float4* out4 = reinterpret_cast<float4*>(d_data + row0);
  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int e = count * 4 + tid; e < k_max * 4; e += kQuadThreads)
    out4[(size_t)(e >> 2) * (rstride / 4) + (e & 3)] = zero4;

  for (int hi = count; hi > 0; hi -= kBatch) {
    const int lo = max(hi - kBatch, 0);
    const int n = hi - lo;
    if (tid < n) {
      const float* row = rows + (size_t)(lo + tid) * rstride;
      const float4 r0 = reinterpret_cast<const float4*>(row)[0];  // x, y, a, b
      const float4 r1 = reinterpret_cast<const float4*>(row)[1];  // c, o, r, g
      s_xy[tid] = make_float2(r0.x, r0.y);
      s_conic_o[tid] = make_float4(r0.z, r0.w, r1.x, r1.y);
      s_rgb[0][tid] = r1.z;
      s_rgb[1][tid] = r1.w;
      s_rgb[2][tid] = row[8];
      const float4 box = cull_box(r0.x, r0.y, r0.z, r0.w, r1.x, r1.y);
      // The rects of the quadrant's two warps, 16 x 8 px each.
      unsigned reach = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float y0 = (float)(w * kWarpH);
        reach |= (unsigned)!box_misses(box, 0.0f, (float)(kWarpW - 1), y0,
                                       y0 + (float)(kWarpH - 1)) << w;
      }
      s_reach[tid] = (unsigned char)reach;
    }
    quad_sync(slot);

    for (int i = n - 1; i >= 0; --i) {
      const int k = lo + i;
      // Warp-uniform: the entry reaches none of this warp's pixels.
      bool live = k < nc_max && ((s_reach[i] >> warp) & 1u);
      if (live) {
        const float2 xy = s_xy[i];
        const float4 co = s_conic_o[i];
        // The tests of the four pixels first, with no branch between them,
        // so their power and exp chains overlap; most pairs stop here.
        float ex[kPerThread], raw[kPerThread];
        bool ok[kPerThread];
        bool any = false;
#pragma unroll
        for (int j = 0; j < kPerThread; ++j) {
          const float dx = __fsub_rn(xy.x, px[j]);
          const float dy = __fsub_rn(xy.y, py[j]);
          const float quad_form = __fadd_rn(
              __fmul_rn(__fmul_rn(co.x, dx), dx),
              __fmul_rn(__fmul_rn(co.z, dy), dy));
          const float power = __fsub_rn(__fmul_rn(-0.5f, quad_form),
                                        __fmul_rn(__fmul_rn(co.y, dx), dy));
          ex[j] = expf(power);
          raw[j] = __fmul_rn(co.w, ex[j]);
          const float alpha = raw[j] > kAlphaMax ? kAlphaMax : raw[j];
          ok[j] = k < nc[j] && power <= 0.0f && alpha >= kAlphaMin;
          any |= ok[j];
        }
        live = __any_sync(0xffffffffu, any);
        if (live) {
          const float cr = s_rgb[0][i], cg = s_rgb[1][i], cb = s_rgb[2][i];
          float acc[kGrad];
#pragma unroll
          for (int g = 0; g < kGrad; ++g) acc[g] = 0.0f;
#pragma unroll
          for (int j = 0; j < kPerThread; ++j) {
            if (!ok[j]) continue;
            const float dx = __fsub_rn(xy.x, px[j]);
            const float dy = __fsub_rn(xy.y, py[j]);
            const float alpha = raw[j] > kAlphaMax ? kAlphaMax : raw[j];
            const float om = fmaxf(1.0f - alpha, 0.01f);
            T[j] = T[j] / om;
            // Divided outside the select, as in K2.
            const float rest = (Bc[j] + gtt[j]) / om;
            const float aT = alpha * T[j];
            const float gc = gr[j] * cr + gg[j] * cg + gb[j] * cb;
            const float dl_dalpha =
                raw[j] < kAlphaMax ? gc * T[j] - rest : 0.0f;
            Bc[j] += aT * gc;
            const float dl_do = dl_dalpha * ex[j];
            const float dl_dp = dl_do * co.w;
            acc[0] += dl_dp * dx;
            acc[1] += dl_dp * dy;
            acc[2] += dl_dp * dx * dx;
            acc[3] += dl_dp * dx * dy;
            acc[4] += dl_dp * dy * dy;
            acc[5] += dl_do;
            acc[6] += aT * gr[j];
            acc[7] += aT * gg[j];
            acc[8] += aT * gb[j];
          }
          const float total = butterfly9(acc, lane);
          if (my_sum >= 0)
            s_part[i * kPartStride + warp * kGrad + my_sum] = total;
        }
      }
      if (lane == 0)
        reinterpret_cast<unsigned char*>(&s_touched[i])[warp] = live;
    }
    quad_sync(slot);

    if (tid < n) {
      const unsigned touched = s_touched[tid];
      const float* part = s_part + tid * kPartStride;
      float s[kGrad];
#pragma unroll
      for (int g = 0; g < kGrad; ++g) s[g] = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        if ((touched >> (8 * w)) & 0xffu) {
#pragma unroll
          for (int g = 0; g < kGrad; ++g) s[g] += part[w * kGrad + g];
        }
      }
      // This row's conic a, b, c, staged by this thread above.
      const float4 co = s_conic_o[tid];
      float4* row = out4 + (size_t)(lo + tid) * (rstride / 4);
      row[0] = make_float4(-(co.x * s[0] + co.y * s[1]),
                           -(co.z * s[1] + co.y * s[0]), -0.5f * s[2], -s[3]);
      row[1] = make_float4(-0.5f * s[4], s[5], s[6], s[7]);
      row[2] = make_float4(s[8], 0.0f, 0.0f, 0.0f);
      row[3] = zero4;
    }
    // The next round's staging overwrites what this round read.
    quad_sync(slot);
  }
}

}  // namespace

// d16c [B, K, 4, 16] f32 (16-byte aligned), counts_q [4 B] i32, final_t
// [B, 8, 128] f32, n_contrib [B, 8, 128] i32, g_color [B, 3, 8, 128] f32,
// g_t [B, 8, 128] f32 (all contiguous, on the device); d_data [B, K, 4, 16]
// f32 is written in full. Returns the launch's cudaError_t.
extern "C" int blend16_bwd_launch(const float* d16c, const int* counts_q,
                                  const float* final_t, const int* n_contrib,
                                  const float* g_color, const float* g_t,
                                  int num_blocks, int k_max, float* d_data,
                                  void* stream) {
  if (num_blocks <= 0) return (int)cudaSuccess;
  static_assert(kQuads % kQuadsPerBlock == 0, "whole blocks of quadrants");
  blend16_bwd_kernel<<<kQuads / kQuadsPerBlock * num_blocks, kThreads, 0,
                       (cudaStream_t)stream>>>(
      d16c, counts_q, final_t, n_contrib, g_color, g_t, k_max, d_data);
  return (int)cudaGetLastError();
}
