// Tile blend backward for Hopper (sm_90a).
//
// Replaces the TPU kernel photo_slam_tpu/ops/pallas/blend.py::_bwd_kernel
// (launched by _blend_bwd_call from the pallas_blend custom VJP). Same
// contract: block b walks image tile tile_ids[b]'s depth-ordered [K, 16]
// entries back to front, from counts[b] - 1 down to 0 (counts = the tile's
// counts_eff = min(count, max n_contrib)), rebuilding each pixel's
// transmittance from final_T, and writes one gradient row per entry:
//   lanes 0-1  d mean2d = -(a S_x + b S_y, c S_y + b S_x)
//   lane  2    d conic a = -1/2 sum dL/dpower dx^2
//   lane  3    d conic b = -sum dL/dpower dx dy
//   lane  4    d conic c = -1/2 sum dL/dpower dy^2
//   lane  5    d opacity = sum dL/do
//   lanes 6-8  d rgb     = sum alpha T g
// with S_x = sum dL/dpower dx, S_y = sum dL/dpower dy over the tile's 1024
// pixels, dx = mean.x - px, dy = mean.y - py. Rows >= counts[b] and lanes
// 9-15 are written as exact zeros. Per entry k and pixel p (k < n_contrib[p],
// power <= 0, alpha >= 1/255, alpha = min(0.99, o e^power)):
//   om = max(1 - alpha, 0.01),  T = T / om  (T before entry k),
//   dL/dalpha = g.c T - (Bc + g_T final_T) / om, zero where o e^power >= 0.99,
//   dL/do = dL/dalpha e^power,  dL/dpower = dL/do o,  then Bc += alpha T g.c
// (cuda_rasterizer/backward.cu:398-557; derivation at blend.py:169-199).
//
// What bounds it on this card: arithmetic. A contributing (entry, pixel)
// pair costs an exp, a division and ~45 operations; the rows are read once
// and written once (64 B each), a small share of the time.
//
// Where the earlier design lost its time (1.74-1.76 ms on the pass-1 tiles
// [836, 1024, 16], ~50x the bound of the contributing pairs and one box per
// row, NVIDIA H100 80GB HBM3 at 700 W):
//   * thread t owned pixels t + 256 j, so a warp held four 32 px rows spread
//     over the whole tile and nearly every entry touched nearly every warp:
//     88 % of the pairs walked lie outside the splat's alpha >= 1/255
//     ellipse and each still paid the power, the exp and the tests;
//   * a touched warp reduced its nine sums with nine 5-step shuffle trees,
//     45 shuffles and 45 adds per entry;
//   * batches of 64 rows left 192 threads idle while staging, and ended in
//     a tail where 64 threads each summed 72 partials.
// This design:
//   * each warp owns a 16 x 8 px block of the tile, so a warp's pixels are
//     close together; lane l = lx + 8 ly holds pixel (lx, ly) of each of the
//     block's four 8 x 4 quadrants, slot j = quadrant j. Inputs and outputs
//     keep their layout (pixel p = r * 32 + c); only the ownership changed;
//   * when a batch is staged, the staging thread also computes the entry's
//     box (cull_box.cuh, shared with K1): a pixel-space rectangle that
//     holds every pixel at which this kernel's own rounding can find
//     power <= 0 and alpha >= 1/255. A warp skips an entry, with no power,
//     exp or shuffle,
//     when the box misses its 16 x 8 rect or when k >= the largest
//     n_contrib of its pixels. Every pair it skips is one the pixel loop
//     would have rejected, so the result differs from the earlier design's
//     only in the order of the sums;
//   * a live warp first tests its four pixels with no branch between them,
//     so their power and exp chains overlap; then it runs the gradient path
//     once per slot in which some lane has a contributing pair. That path
//     diverges, so slots are quadrants rather than 2 x 2 quads: a splat
//     lights fewer of them, and more lanes of each;
//   * a touched warp reduces its nine sums with a transpose butterfly
//     (butterfly9): at each step a lane sends the half of its sums that its
//     partner keeps, 5 + 3 + 2 + 1 + 1 = 12 shuffles, and nine lanes end
//     holding one total each, written with one store;
//   * a per-row byte per warp records which warps took part, and the row
//     sum reads only those partials, in warp order: deterministic, no
//     atomics;
//   * batches of 128 rows: the partials [128][8][9] (+1 pad per row, so the
//     row sums read without bank conflicts) and the staged rows and boxes
//     take 44 KB, under the 48 KB of static shared memory. A batch of 256
//     would need 88 KB and cap the SM at two blocks.
// Predicted before the first timed run: 0.55-0.90 ms on the pass-1 tiles.
// Measured by chip_smoke.py's K2 phase on an NVIDIA H100 80GB HBM3 at
// 700 W: 0.9519 / 0.9548 ms against the earlier design's 1.7343 / 1.7515 ms
// in the same call (PERF.md, section 6, with what the time goes to). Without
// the box (tools/time_blend.py --kernel bwd --knockout without-box, same
// card, one call) it takes 1.135-1.143 ms against 0.934-0.945 ms with it;
// in a later call 1.094-1.099 ms against 0.944-0.952 ms.
//
// power and alpha are rounded exactly as in K1 (__fmul_rn / __fadd_rn, the
// full-precision expf), so the two kernels take the same entries; the
// remaining products may contract into FMAs.

#include <cuda_runtime.h>

#include "butterfly9.cuh"
#include "cull_box.cuh"

namespace {

constexpr int kTile = 32;
constexpr int kPixels = kTile * kTile;  // 1024
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;   // 8
constexpr int kWarpW = 16;              // a warp's block: 16 x 8 px
constexpr int kWarpH = 8;
constexpr int kPerThread = 4;           // one pixel per 8 x 4 quadrant
constexpr int kFeat = 16;
constexpr int kGrad = 9;                // gradient lanes 0-8
constexpr int kBatch = 128;             // rows staged and summed per round
constexpr int kPartStride = kWarps * kGrad + 1;  // 73 floats per row

__global__ void __launch_bounds__(kThreads)
blend_bwd_kernel(const float* __restrict__ data, const int* __restrict__ counts,
                 const int* __restrict__ tile_ids,
                 const float* __restrict__ final_t,
                 const int* __restrict__ n_contrib,
                 const float* __restrict__ g_color,
                 const float* __restrict__ g_t, int k_max, int tiles_x,
                 float* __restrict__ d_data) {
  const float kAlphaMax = 0.99f;
  const float kAlphaMin = (float)(1.0 / 255.0);

  __shared__ float2 s_xy[kBatch];
  __shared__ float4 s_conic_o[kBatch];  // a, b, c, opacity
  __shared__ float s_rgb[3][kBatch];
  __shared__ float4 s_box[kBatch];
  __shared__ unsigned long long s_touched[kBatch];  // byte w: warp w summed
  __shared__ float s_part[kBatch * kPartStride];

  const int blk = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int count = min(max(counts[blk], 0), k_max);
  const int tile = tile_ids ? tile_ids[blk] : blk;
  const float ox = (float)((tile % tiles_x) * kTile);
  const float oy = (float)((tile / tiles_x) * kTile);
  const float* rows = data + (size_t)blk * k_max * kFeat;
  float* out = d_data + (size_t)blk * k_max * kFeat;
  const size_t pix0 = (size_t)blk * kPixels;

  // This warp's 16 x 8 block (its rect in image pixels) and this thread's
  // pixel in each of the block's four 8 x 4 quadrants: pixel j at
  // (cx + 8 (j & 1), cy + 4 (j >> 1)).
  const int bx = (warp & 1) * kWarpW, by = (warp >> 1) * kWarpH;
  const float wx0 = ox + (float)bx, wx1 = wx0 + (float)(kWarpW - 1);
  const float wy0 = oy + (float)by, wy1 = wy0 + (float)(kWarpH - 1);
  const int cx = bx + (lane & 7);
  const int cy = by + (lane >> 3);
  const int my_sum = butterfly9_sum(lane);

  float px[kPerThread], py[kPerThread], T[kPerThread], Bc[kPerThread];
  float gr[kPerThread], gg[kPerThread], gb[kPerThread], gtt[kPerThread];
  int nc[kPerThread];
  int nc_max = 0;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int x = cx + (j & 1) * (kWarpW / 2);
    const int y = cy + (j >> 1) * (kWarpH / 2);
    const int p = y * kTile + x;
    px[j] = ox + (float)x;
    py[j] = oy + (float)y;
    T[j] = final_t[pix0 + p];
    Bc[j] = 0.0f;
    gr[j] = g_color[3 * pix0 + p];
    gg[j] = g_color[3 * pix0 + kPixels + p];
    gb[j] = g_color[3 * pix0 + 2 * kPixels + p];
    gtt[j] = g_t[pix0 + p] * T[j];
    nc[j] = n_contrib[pix0 + p];
    nc_max = max(nc_max, nc[j]);
  }
  nc_max = __reduce_max_sync(0xffffffffu, nc_max);

  // Rows past the count: exact zeros (invalid ids gather Gaussian 0, so the
  // transpose would add anything written here into its gradient).
  float4* out4 = reinterpret_cast<float4*>(out);
  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int e = count * (kFeat / 4) + tid; e < k_max * (kFeat / 4);
       e += kThreads)
    out4[e] = zero4;

  for (int hi = count; hi > 0; hi -= kBatch) {
    const int lo = max(hi - kBatch, 0);
    const int n = hi - lo;
    if (tid < n) {
      const int k = lo + tid;
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

    for (int i = n - 1; i >= 0; --i) {
      const int k = lo + i;
      const float4 box = s_box[i];
      // Warp-uniform: the entry reaches none of this warp's pixels.
      bool live = k < nc_max && !box_misses(box, wx0, wx1, wy0, wy1);
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
          const float quad = __fadd_rn(__fmul_rn(__fmul_rn(co.x, dx), dx),
                                       __fmul_rn(__fmul_rn(co.z, dy), dy));
          const float power = __fsub_rn(__fmul_rn(-0.5f, quad),
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
          for (int q = 0; q < kGrad; ++q) acc[q] = 0.0f;
#pragma unroll
          for (int j = 0; j < kPerThread; ++j) {
            if (!ok[j]) continue;
            const float dx = __fsub_rn(xy.x, px[j]);
            const float dy = __fsub_rn(xy.y, py[j]);
            const float alpha = raw[j] > kAlphaMax ? kAlphaMax : raw[j];
            const float om = fmaxf(1.0f - alpha, 0.01f);
            T[j] = T[j] / om;
            // Divided outside the select: a division under a branch inside
            // the divergent pixel branch costs more than the division.
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
    __syncthreads();

    if (tid < n) {
      const unsigned long long touched = s_touched[tid];
      const float* part = s_part + tid * kPartStride;
      float s[kGrad];
#pragma unroll
      for (int q = 0; q < kGrad; ++q) s[q] = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        if ((touched >> (8 * w)) & 0xffu) {
#pragma unroll
          for (int q = 0; q < kGrad; ++q) s[q] += part[w * kGrad + q];
        }
      }
      const float4 co = s_conic_o[tid];
      float4* row = out4 + (size_t)(lo + tid) * (kFeat / 4);
      row[0] = make_float4(-(co.x * s[0] + co.y * s[1]),
                           -(co.z * s[1] + co.y * s[0]), -0.5f * s[2], -s[3]);
      row[1] = make_float4(-0.5f * s[4], s[5], s[6], s[7]);
      row[2] = make_float4(s[8], 0.0f, 0.0f, 0.0f);
      row[3] = zero4;
    }
    // The next round's staging overwrites what this round read.
    __syncthreads();
  }
}

}  // namespace

// data [B, K, 16] f32, counts [B] i32 (counts_eff), tile_ids [B] i32 or
// null (block b then walks tile b), final_t [B, 1024] f32, n_contrib
// [B, 1024] i32, g_color [B, 3, 1024] f32, g_t [B, 1024] f32 (all
// contiguous, on the device, data 16-byte aligned); d_data [B, K, 16] f32 is
// written in full. Returns the launch's cudaError_t.
extern "C" int blend_bwd_launch(const float* data, const int* counts,
                                const int* tile_ids, const float* final_t,
                                const int* n_contrib, const float* g_color,
                                const float* g_t, int num_blocks, int k_max,
                                int tiles_x, float* d_data, void* stream) {
  if (num_blocks <= 0) return (int)cudaSuccess;
  blend_bwd_kernel<<<num_blocks, kThreads, 0, (cudaStream_t)stream>>>(
      data, counts, tile_ids, final_t, n_contrib, g_color, g_t, k_max, tiles_x,
      d_data);
  return (int)cudaGetLastError();
}
