// Tile blend forward for Hopper (sm_90a).
//
// Replaces the TPU kernel photo_slam_tpu/ops/pallas/blend.py::_fwd_kernel
// (launched by _blend_fwd_call, exposed as pallas_blend). Same contract:
// tile b of the batch is image tile tile_ids[b] (32x32 px); its
// depth-ordered [K, 16] entries are composited front to back; per entry
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy,  alpha = min(0.99, o e^power),
// skipped when power > 0 or alpha < 1/255; a pixel stops at the first entry
// whose T (1 - alpha) would fall below 1e-4, and that entry is not applied.
// Outputs color [B, 3, 1024], final T [B, 1024] and n_contrib [B, 1024]
// (index of the last applied entry + 1), pixel p = r * 32 + c. No
// background. Rows at index >= counts[b] are never read.
//
// What bounds it on this card: arithmetic, not memory. Each (entry, pixel)
// pair that the kernel evaluates costs an exp and about twenty separately
// rounded multiplies and adds (FP32 instruction throughput); the entry rows
// (64 B each) are read once per block and are a small share of the time.
//
// Where the earlier design lost its time (0.94 ms on the pass-1 tiles
// [836, 1024, 16], ~60x the bound of the pairs the function needs, the
// applied and stopping ones, and one box per row: 0.0156 ms, NVIDIA H100
// 80GB HBM3 at 700 W):
//   * thread t owned pixels t + 256 j, so a warp held four 32 px rows
//     spread over the whole tile and nearly every entry touched nearly every
//     warp: 90 % of the pairs walked lie outside the splat's alpha >= 1/255
//     ellipse and each still paid the power, the exp and the tests;
//   * a thread's four pixels ran one after another behind branches (done,
//     power > 0, alpha < 1/255), so their power and exp chains never
//     overlapped;
//   * the only stop was the block's, once per batch of 256 rows: a warp
//     whose pixels had all stopped walked on until the whole block had;
//   * one block of 256 threads per tile is 836 blocks of unequal depth,
//     1.6 waves of the card at 4 resident blocks per SM, so the last wave
//     runs partly empty, and at each batch's barrier all 8 warps wait for
//     the one with the most live entries.
// This design (the thread map and the box of K2, csrc/blend_bwd.cu):
//   * each warp owns a 16 x 8 px block of the tile; lane l = lx + 8 ly holds
//     pixel (lx, ly) of each of the block's four 8 x 4 quadrants, slot j =
//     quadrant j. Outputs keep their layout; only the ownership changed;
//   * when a batch is staged, the staging thread also computes the entry's
//     box (cull_box.cuh, shared with K2). A warp skips an entry whose box
//     misses its 16 x 8 rect with no power, exp or test. The kernel changes
//     a pixel's state only at a pair with power <= 0 and alpha >= 1/255
//     (an applied pair and a stopping pair alike), and the box holds every
//     such pair, so a skipped pair is one the loop would have rejected and
//     no pixel's arithmetic changes;
//   * a warp stops on its own: it skips every further entry once all 128 of
//     its pixels have stopped (__all_sync, refreshed after each entry it
//     evaluates). The block still leaves when all its threads are done,
//     checked at each batch boundary; a stopped warp keeps staging rows and
//     reaching every barrier;
//   * a live warp computes its four pixels' dx, dy, power, exp and alpha
//     with no branch between them, so their chains overlap, then applies or
//     stops each pixel under its own predicate;
//   * two blocks of 128 threads per tile (kHalves), each the 4 warps of one
//     32 x 16 px half, each staging all of the tile's rows in batches of
//     128: 1,672 blocks at 7 resident per SM (__launch_bounds__(128, 7), 69
//     registers, no spills, 6.5 KB of staged rows and boxes), so the last
//     wave is finer and a barrier waits for 4 warps, not 8. It stages and
//     boxes every row twice; it still won against one 256-thread block per
//     tile (4 per SM, 64 registers), which stays a variant of
//     tools/time_blend.py (whole-tile).
// Predicted before the first timed run: 0.45-0.70 ms on the pass-1 tiles.
// Measured by tools/time_blend.py, one process, six rounds in turns, on an
// NVIDIA H100 80GB HBM3 at 700 W (PERF.md, section 6): 0.4067-0.4127 ms
// against 0.4115-0.4247 ms for the whole-tile form and 0.9305-0.9381 ms for
// the earlier design; without the box 0.7593-0.7700 ms. That is still ~26x
// the bound above. The room's splats (an untrained map, opacity 0.1) never
// stop a pixel, and there the warp stop's vote costs 1-2 %. On a trained
// map (time_blend.py --map trained: 22.8 % of the pixels stop, but only
// 3.7 % of the warps' blocks stop whole) the warp stop wins all six rounds,
// 0.4478-0.4527 ms against 0.4506-0.4564 ms; with every opacity at 0.99
// (four rounds) 0.3117-0.3236 ms against 0.3768-0.3790 ms.
//
// Every product and sum is rounded on its own (__fmul_rn / __fadd_rn never
// contract into FMAs) in the order the plain PyTorch version
// (ops/blend.py::blend_fwd_plain) evaluates it, and expf is the full-
// precision libm exp, so the two agree to the last bit except where the two
// exp implementations differ.

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
constexpr int kFeat = 16;
constexpr int kBatch = kThreads;        // entry rows staged per round

// The warp stop: true once every lane's pixels have all stopped.
__device__ __forceinline__ bool warp_stopped(bool mine_done) {
  return __all_sync(0xffffffffu, mine_done);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
blend_fwd_kernel(const float* __restrict__ data, const int* __restrict__ counts,
                 const int* __restrict__ tile_ids, int k_max, int tiles_x,
                 float* __restrict__ color, float* __restrict__ final_t,
                 int* __restrict__ n_contrib) {
  const float kAlphaMax = 0.99f;
  const float kAlphaMin = (float)(1.0 / 255.0);
  const float kTEps = 1e-4f;

  __shared__ float2 s_xy[kBatch];
  __shared__ float4 s_conic_o[kBatch];  // a, b, c, opacity
  __shared__ float s_rgb[3][kBatch];
  __shared__ float4 s_box[kBatch];

  const int blk = blockIdx.x / kHalves;  // the tile in the batch
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  // The warp of the tile, 0-7: this block holds warps 4 h to 4 h + 3.
  const int warp = (tid >> 5) + (kThreads / 32) * (blockIdx.x % kHalves);
  const int count = min(counts[blk], k_max);
  const int tile = tile_ids ? tile_ids[blk] : blk;
  const float ox = (float)((tile % tiles_x) * kTile);
  const float oy = (float)((tile / tiles_x) * kTile);
  const float* rows = data + (size_t)blk * k_max * kFeat;

  // This warp's 16 x 8 block (its rect in image pixels) and this thread's
  // pixel in each of the block's four 8 x 4 quadrants: pixel j at
  // (cx + 8 (j & 1), cy + 4 (j >> 1)).
  const int bx = (warp & 1) * kWarpW, by = (warp >> 1) * kWarpH;
  const float wx0 = ox + (float)bx, wx1 = wx0 + (float)(kWarpW - 1);
  const float wy0 = oy + (float)by, wy1 = wy0 + (float)(kWarpH - 1);
  const int cx = bx + (lane & 7);
  const int cy = by + (lane >> 3);

  float px[kPerThread], py[kPerThread];
  float T[kPerThread], cr[kPerThread], cg[kPerThread], cb[kPerThread];
  int last[kPerThread];
  bool done[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    px[j] = ox + (float)(cx + (j & 1) * (kWarpW / 2));
    py[j] = oy + (float)(cy + (j >> 1) * (kWarpH / 2));
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
      const float4* r = reinterpret_cast<const float4*>(rows + (size_t)k * kFeat);
      const float4 r0 = r[0];  // x, y, a, b
      const float4 r1 = r[1];  // c, opacity, r, g
      s_xy[tid] = make_float2(r0.x, r0.y);
      s_conic_o[tid] = make_float4(r0.z, r0.w, r1.x, r1.y);
      s_rgb[0][tid] = r1.z;
      s_rgb[1][tid] = r1.w;
      s_rgb[2][tid] = rows[(size_t)k * kFeat + 8];
      s_box[tid] = cull_box(r0.x, r0.y, r0.z, r0.w, r1.x, r1.y);
    }
    __syncthreads();
    if (warp_stopped(mine_done)) continue;

    const int n = min(kBatch, count - base);
    for (int i = 0; i < n; ++i) {
      const float4 box = s_box[i];
      // Warp-uniform: the entry reaches none of this warp's pixels.
      if (box_misses(box, wx0, wx1, wy0, wy1)) continue;
      const float2 xy = s_xy[i];
      const float4 co = s_conic_o[i];
      // The tests of the four pixels first, with no branch between them,
      // so their power and exp chains overlap.
      float alpha[kPerThread];
      bool ok[kPerThread];
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const float dx = __fsub_rn(xy.x, px[j]);
        const float dy = __fsub_rn(xy.y, py[j]);
        const float quad = __fadd_rn(__fmul_rn(__fmul_rn(co.x, dx), dx),
                                     __fmul_rn(__fmul_rn(co.z, dy), dy));
        const float power = __fsub_rn(__fmul_rn(-0.5f, quad),
                                      __fmul_rn(__fmul_rn(co.y, dx), dy));
        // min(0.99, .) that keeps a NaN (fminf would drop it), so a NaN
        // entry fails the alpha test exactly as in the plain version.
        const float a = __fmul_rn(co.w, expf(power));
        alpha[j] = a > kAlphaMax ? kAlphaMax : a;
        ok[j] = !done[j] && power <= 0.0f && alpha[j] >= kAlphaMin;
      }
      const float r = s_rgb[0][i], g = s_rgb[1][i], b = s_rgb[2][i];
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const float test_t = __fmul_rn(T[j], __fsub_rn(1.0f, alpha[j]));
        const bool stop = ok[j] && test_t < kTEps;
        if (ok[j] && !stop) {
          const float w = __fmul_rn(alpha[j], T[j]);
          cr[j] = __fadd_rn(cr[j], __fmul_rn(w, r));
          cg[j] = __fadd_rn(cg[j], __fmul_rn(w, g));
          cb[j] = __fadd_rn(cb[j], __fmul_rn(w, b));
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

// data [B, K, 16] f32, counts [B] i32, tile_ids [B] i32 or null (tile b of
// the batch is then image tile b) (all contiguous, on the device, data
// 16-byte aligned); color [B, 3, 1024] f32, final_t [B, 1024] f32, n_contrib
// [B, 1024] i32 are written in full. Returns the launch's cudaError_t.
extern "C" int blend_fwd_launch(const float* data, const int* counts,
                                const int* tile_ids, int num_blocks, int k_max,
                                int tiles_x, float* color, float* final_t,
                                int* n_contrib, void* stream) {
  if (num_blocks <= 0) return (int)cudaSuccess;
  blend_fwd_kernel<<<kHalves * num_blocks, kThreads, 0,
                     (cudaStream_t)stream>>>(
      data, counts, tile_ids, k_max, tiles_x, color, final_t, n_contrib);
  return (int)cudaGetLastError();
}
