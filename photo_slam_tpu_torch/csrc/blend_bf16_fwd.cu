// Tile blend forward with bf16 inner math for Hopper (sm_90a): the X1
// forward.
//
// Replaces the TPU kernel tools/exp_blend_bf16.py::_fwd_kernel_bf16
// (launched by call_bf16). It is K1 (csrc/blend_fwd.cu) on 32x32 tiles with
// identity tile ids, with the pixel-side chain in bf16 and the transmittance
// and colour in f32. Per entry (in f32, then rounded to bf16 once):
//   mx = bf16(x - tile origin x), my = bf16(y - tile origin y),
// and a, b, c, o rounded to bf16; per pixel, in bf16, each operation rounded
// on its own, at tile-local pixel coordinates lx, ly (0..31, exact in bf16):
//   dx = mx - lx,  dy = my - ly,
//   power = -0.5 ((a dx) dx + (c dy) dy) - (b dx) dy,
//   e = bf16(expf(power)),  alpha = min(bf16(0.99), o e);
// skipped when power > 0 or alpha < bf16(1/255); then in f32, as K1: the
// pixel stops before the entry whose T (1 - alpha) would fall below 1e-4,
// else colour += (alpha T) rgb and T = T (1 - alpha).
//
// What bounds it on this card: arithmetic. The experiment asks whether
// bf16's packed arithmetic speeds the blend up: each bf16x2 instruction
// computes two pixels, so dx, dy, power and the alpha product run at up to
// twice K1's instruction rate; the exp (in f32), the conversions around it
// and the f32 tail do not.
//
// Where the earlier design lost its time (0.8407 ms on the pass-1 tiles
// [836, 1024, 16], 62x its bound, against K1's 0.4071; NVIDIA H100 80GB
// HBM3 at 700 W): it was K1's first design, which K1 has since dropped:
//   * thread t of a 256-thread block owned pixels t + 256 j, so a warp held
//     four 32 px rows spread over the whole tile and nearly every entry
//     touched nearly every warp;
//   * no per-entry box: every pair paid the power, the exp and the tests;
//   * each pixel was tested behind branches, one after another;
//   * the only stop was the block's, once per batch of 256 rows.
// This design is K1's, in bf16x2:
//   * two blocks of 128 threads per tile (kHalves), each the 4 warps of one
//     32 x 16 px half, each staging all of the tile's rows in batches of
//     128. Each warp owns a 16 x 8 px block of the tile; lane l = lx + 8 ly
//     holds pixel (cx + 8 (j & 1), cy + 4 (j >> 1)) in slot j, one per 8 x 4
//     quadrant of the block. Slots (0, 1) and (2, 3) share their row and lie
//     8 px apart, so each pair is one __nv_bfloat162 with x = (cx, cx + 8)
//     and a broadcast y: dx, a dx dx and b dx are the same for both pairs
//     and are computed once an entry;
//   * the staging thread rounds the row to bf16 once and computes its box
//     from the rounded values, in the tile-local frame (cull_box_bf16 in
//     cull_box.cuh, whose comment derives its slack for the bf16 chain's
//     rounding), then tests it against the rects of its block's four warps,
//     keeping one bit per warp (s_reach). A warp skips an entry whose bit
//     is clear with no power, exp or test: the box holds every pair with
//     power <= 0 and alpha >= bf16(1/255), the only pairs at which the
//     kernel changes a pixel's state, so no pixel's arithmetic changes.
//     The bf16 box is wider than K1's and unbounded for splats elongated
//     past det' > 0 at g = 0.025 (chip_smoke.py counts them);
//   * the four pixels' bf16 chains run with no branch between them, then
//     each pixel is applied or stopped in f32 under its own predicate;
//   * a warp stops on its own once all 128 of its pixels have stopped
//     (__all_sync after each entry it evaluates); the block leaves at a
//     batch boundary once all its threads are done (__syncthreads_count).
// Predicted before the first timed run: 0.37-0.47 ms on the pass-1 tiles.
// Measured by tools/time_blend.py --kernel x1 (four rounds in turns, one
// call, NVIDIA H100 80GB HBM3 at 700 W; PERF.md, section 6): 0.3914-0.3966
// ms against the earlier design's 0.8548-0.8624, and 0.3941 against K1's
// 0.4148 in one chip_smoke.py run; with every opacity at 0.99 0.3216-0.3276
// against 0.6449-0.6557. The bf16 box skips 64.6 % of the (entry, warp)
// pairs (K1's 65.1 %); without it 0.8060-0.8085. The warp stop's vote costs
// 1-2 % where no pixel stops (0.3843-0.3870 without it) and wins 16 % at
// opacity 0.99 (0.3707-0.3767 without it). 69 registers, no spills.
//
// The bf16 operations are the explicitly rounded intrinsics (__hsub2_rn,
// __hmul2_rn, __hadd2_rn), which ptxas may not contract into fused
// multiply-adds, in the order of the plain version
// (photo_slam_tpu_torch/tools/exp_blend_bf16.py::call_bf16_plain); expf is
// the full-precision exp of the bf16 power; the f32 tail rounds as K1 does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cull_box.cuh"

namespace {

constexpr int kTile = 32;
constexpr int kPixels = kTile * kTile;  // 1024
constexpr int kThreads = 128;           // a block: 4 warps, half a tile
constexpr int kHalves = 2;              // blocks per tile
constexpr int kMinBlocks = 7;           // resident blocks per SM
constexpr int kWarpW = 16;              // a warp's block: 16 x 8 px
constexpr int kWarpH = 8;
constexpr int kPerThread = 4;           // one pixel per 8 x 4 quadrant
constexpr int kPairs = kPerThread / 2;  // bf16x2 pairs: slots (0, 1), (2, 3)
constexpr int kFeat = 16;
constexpr int kBatch = kThreads;        // entry rows staged per round

// The warp stop: true once every lane's pixels have all stopped.
__device__ __forceinline__ bool warp_stopped(bool mine_done) {
  return __all_sync(0xffffffffu, mine_done);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
blend_bf16_fwd_kernel(const float* __restrict__ data,
                      const int* __restrict__ counts, int k_max, int tiles_x,
                      float* __restrict__ color, float* __restrict__ final_t,
                      int* __restrict__ n_contrib) {
  // bf16(0.99) = 0.98828125 and bf16(1/255) = 0.003936767578125, as floats.
  const float kAlphaMax =
      __bfloat162float(__float2bfloat16_rn((float)0.99));
  const float kAlphaMin =
      __bfloat162float(__float2bfloat16_rn((float)(1.0 / 255.0)));
  const float kTEps = 1e-4f;

  __shared__ __nv_bfloat162 s_m[kBatch];   // (mx, my), tile-local
  __shared__ __nv_bfloat162 s_ab[kBatch];  // (a, b)
  __shared__ __nv_bfloat162 s_co[kBatch];  // (c, o)
  __shared__ float s_rgb[3][kBatch];
  __shared__ unsigned char s_reach[kBatch];  // bit w: the box reaches warp w

  const int blk = blockIdx.x / kHalves;  // the tile
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  // The warp of the tile, 0-7: this block holds warps 4 h to 4 h + 3.
  const int warp = (tid >> 5) + (kThreads / 32) * (blockIdx.x % kHalves);
  const int count = min(max(counts[blk], 0), k_max);
  const float ox = (float)((blk % tiles_x) * kTile);
  const float oy = (float)((blk / tiles_x) * kTile);
  const float* rows = data + (size_t)blk * k_max * kFeat;
  const __nv_bfloat162 neg_half = __float2bfloat162_rn(-0.5f);

  // This thread's pixel in each of its warp's 16 x 8 block's four 8 x 4
  // quadrants (tile-local): slot j at (cx + 8 (j & 1), cy + 4 (j >> 1)).
  // Pair m holds slots 2 m (.x) and 2 m + 1 (.y), both in row cy + 4 m.
  const int cx = (warp & 1) * kWarpW + (lane & 7);
  const int cy = (warp >> 1) * kWarpH + (lane >> 3);
  const __nv_bfloat162 lx =
      __floats2bfloat162_rn((float)cx, (float)(cx + kWarpW / 2));
  __nv_bfloat162 ly[kPairs];
#pragma unroll
  for (int m = 0; m < kPairs; ++m)
    ly[m] = __float2bfloat162_rn((float)(cy + m * (kWarpH / 2)));

  float T[kPerThread], cr[kPerThread], cg[kPerThread], cb[kPerThread];
  int last[kPerThread];
  bool done[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    T[j] = 1.0f;
    cr[j] = cg[j] = cb[j] = 0.0f;
    last[j] = 0;
    done[j] = false;
  }

  for (int base = 0; base < count; base += kBatch) {
    bool mine_done = done[0] && done[1] && done[2] && done[3];
    // The block leaves once every pixel has stopped; this is also the
    // barrier before the batch below overwrites shared memory.
    if (__syncthreads_count(mine_done) == kThreads) break;

    const int k = base + tid;
    if (k < count) {
      const float* row = rows + (size_t)k * kFeat;
      const float4 r0 = reinterpret_cast<const float4*>(row)[0];  // x, y, a, b
      const float4 r1 = reinterpret_cast<const float4*>(row)[1];  // c, o, r, g
      const __nv_bfloat162 mm = __floats2bfloat162_rn(__fsub_rn(r0.x, ox),
                                                      __fsub_rn(r0.y, oy));
      const __nv_bfloat162 ab = __floats2bfloat162_rn(r0.z, r0.w);
      const __nv_bfloat162 co = __floats2bfloat162_rn(r1.x, r1.y);
      s_m[tid] = mm;
      s_ab[tid] = ab;
      s_co[tid] = co;
      s_rgb[0][tid] = r1.z;
      s_rgb[1][tid] = r1.w;
      s_rgb[2][tid] = row[8];
      const float2 mf = __bfloat1622float2(mm);
      const float2 abf = __bfloat1622float2(ab);
      const float2 cof = __bfloat1622float2(co);
      const float4 box =
          cull_box_bf16(mf.x, mf.y, abf.x, abf.y, cof.x, cof.y);
      // The rects of this block's warps, 16 x 8 px each, tile-local.
      unsigned reach = 0;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) {
        const int tw = w + (kThreads / 32) * (blockIdx.x % kHalves);
        const float x0 = (float)((tw & 1) * kWarpW);
        const float y0 = (float)((tw >> 1) * kWarpH);
        reach |= (unsigned)!box_misses(box, x0, x0 + (float)(kWarpW - 1), y0,
                                       y0 + (float)(kWarpH - 1)) << w;
      }
      s_reach[tid] = (unsigned char)reach;
    }
    __syncthreads();
    if (warp_stopped(mine_done)) continue;

    const int n = min(kBatch, count - base);
    for (int i = 0; i < n; ++i) {
      // Warp-uniform: the entry reaches none of this warp's pixels.
      if (!((s_reach[i] >> (tid >> 5)) & 1u)) continue;
      const __nv_bfloat162 mm = s_m[i], ab = s_ab[i], co = s_co[i];
      const __nv_bfloat162 mx = __low2bfloat162(mm), my = __high2bfloat162(mm);
      const __nv_bfloat162 a = __low2bfloat162(ab), b = __high2bfloat162(ab);
      const __nv_bfloat162 c = __low2bfloat162(co), o = __high2bfloat162(co);
      // Shared by both pairs: they have the same two x.
      const __nv_bfloat162 dx = __hsub2_rn(mx, lx);
      const __nv_bfloat162 adxdx = __hmul2_rn(__hmul2_rn(a, dx), dx);
      const __nv_bfloat162 bdx = __hmul2_rn(b, dx);
      // The tests of the four pixels first, with no branch between them,
      // so their chains overlap.
      float alpha[kPerThread];
      bool ok[kPerThread];
#pragma unroll
      for (int m = 0; m < kPairs; ++m) {
        const __nv_bfloat162 dy = __hsub2_rn(my, ly[m]);
        const __nv_bfloat162 quad =
            __hadd2_rn(adxdx, __hmul2_rn(__hmul2_rn(c, dy), dy));
        const __nv_bfloat162 power =
            __hsub2_rn(__hmul2_rn(neg_half, quad), __hmul2_rn(bdx, dy));
        const float2 pf = __bfloat1622float2(power);
        const __nv_bfloat162 e = __floats2bfloat162_rn(expf(pf.x), expf(pf.y));
        const float2 af = __bfloat1622float2(__hmul2_rn(o, e));
        const float pw[2] = {pf.x, pf.y};
        const float al[2] = {af.x, af.y};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = 2 * m + h;
          // min(bf16(0.99), .) that keeps a NaN, as the plain version's
          // clamp does (exact: both sides are bf16 values).
          alpha[j] = al[h] > kAlphaMax ? kAlphaMax : al[h];
          ok[j] = !done[j] && pw[h] <= 0.0f && alpha[j] >= kAlphaMin;
        }
      }
      const float r = s_rgb[0][i], g = s_rgb[1][i], bl = s_rgb[2][i];
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const float test_t = __fmul_rn(T[j], __fsub_rn(1.0f, alpha[j]));
        const bool stop = ok[j] && test_t < kTEps;
        if (ok[j] && !stop) {
          const float w = __fmul_rn(alpha[j], T[j]);
          cr[j] = __fadd_rn(cr[j], __fmul_rn(w, r));
          cg[j] = __fadd_rn(cg[j], __fmul_rn(w, g));
          cb[j] = __fadd_rn(cb[j], __fmul_rn(w, bl));
          T[j] = test_t;
          last[j] = base + i + 1;
        }
        done[j] = done[j] || stop;
      }
      if (warp_stopped(done[0] && done[1] && done[2] && done[3])) break;
    }
  }

  const size_t pix0 = (size_t)blk * kPixels;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int p = (cy + (j >> 1) * (kWarpH / 2)) * kTile + cx +
                  (j & 1) * (kWarpW / 2);
    color[3 * pix0 + p] = cr[j];
    color[3 * pix0 + kPixels + p] = cg[j];
    color[3 * pix0 + 2 * kPixels + p] = cb[j];
    final_t[pix0 + p] = T[j];
    n_contrib[pix0 + p] = last[j];
  }
}

}  // namespace

// data [B, K, 16] f32 (16-byte aligned), counts [B] i32 (both contiguous,
// on the device); color [B, 3, 1024] f32, final_t [B, 1024] f32 and
// n_contrib [B, 1024] i32 are written in full. Returns the launch's
// cudaError_t.
extern "C" int blend_bf16_fwd_launch(const float* data, const int* counts,
                                     int num_tiles, int k_max, int tiles_x,
                                     float* color, float* final_t,
                                     int* n_contrib, void* stream) {
  if (num_tiles <= 0) return (int)cudaSuccess;
  blend_bf16_fwd_kernel<<<kHalves * num_tiles, kThreads, 0,
                          (cudaStream_t)stream>>>(
      data, counts, k_max, tiles_x, color, final_t, n_contrib);
  return (int)cudaGetLastError();
}
