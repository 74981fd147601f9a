// Group-vectorized tile blend forward for Hopper (sm_90a): the X3 forward.
//
// Replaces the TPU kernel tools/exp_blend_vec.py::_fwd_kernel_vec (launched
// by blend_vec). It is K1's function (csrc/blend_fwd.cu) on 32x32 tiles with
// identity tile ids (block pair b rasterizes image tile b), taken in groups
// of G = 64 entries with another rounding. Per group and pixel, over the
// group's entries k < count in order:
//   contrib_k = alive & power <= 0 & alpha >= 1/255,
//   om_k = 1 - alpha_k where contrib_k, else 1,
//   S_k = T * prod_{j <= k} om_j   (T = the pixel's transmittance before
//                                   the group),
//   ok_k = contrib_k & S_k >= 1e-4,  weight_k = alpha_k (S_k / om_k),
// colour += sum_k rgb_k weight_k, n_contrib = the last ok k + 1,
// T *= the product of the ok om_k; a pixel with a contributing entry whose
// S_k < 1e-4 dies, at the end of the group. The TPU kernel built S with a
// log2(G) roll-ladder prefix product over [G, 1024] arrays and the colour
// sum as an MXU matmul; here each thread walks the entries for its pixels
// with a running product, as K1 walks them.
//
// What bounds it on this card: arithmetic, as K1. A pair at which the
// kernel changes a pixel's state costs an exp, ~20 separately rounded
// products and sums and, where it is applied, an IEEE division; the entry
// rows (64 B each) are read once per block.
//
// Where the earlier design lost its time (1.1197 ms on the pass-1 tiles
// [836, 1024, 16] against K1's 0.4142 ms for nearly the same work, 72x the
// bound of the pairs K1 needs and one box per row, 0.0156 ms; NVIDIA H100
// 80GB HBM3 at 700 W): it was K1's first design, which K1 timed at 0.94
// ms:
//   * one 256-thread block per tile, pixel p = threadIdx.x + 256 j, so a
//     warp held four 32 px rows spread over the whole tile and nearly every
//     entry touched nearly every warp;
//   * no per-entry box: every pair paid the power, the exp and the tests;
//   * a thread's four pixels ran one after another behind `continue`
//     branches, so their chains never overlapped;
//   * the only stop was the block's, once per group.
// This design is K1's:
//   * each warp owns a 16 x 8 px block of the tile; lane l = lx + 8 ly holds
//     pixel (lx, ly) of each of the block's four 8 x 4 quadrants, slot j =
//     quadrant j;
//   * the staging thread computes each row's box (cull_box.cuh, shared with
//     K1 and K2) and tests it against the rects of its block's four warps,
//     keeping one bit per warp (s_reach): a warp skips an entry whose box
//     misses its rect on one shared byte, with no power, exp or test. power
//     and alpha are rounded exactly as in K1, so the box holds every pair
//     with power <= 0 and alpha >= 1/255, and those are the only pairs at
//     which this kernel changes a pixel's state: no pixel's arithmetic
//     changes;
//   * a pixel that leaves its group (S < 1e-4) is dead for good, so a warp
//     whose 128 pixels are all dead skips the rest of its group and every
//     later group (__all_sync after each entry it evaluates). It folds its
//     partial group at once: that is the fold the group's end would make,
//     since no later entry applies to its pixels. The block leaves at a
//     batch barrier once all its pixels are dead;
//   * the four pixels' dx, dy, power, exp and alpha are computed with no
//     branch between them, then each pixel is applied or killed under its
//     own predicate; the division runs only for an applied pair;
//   * two blocks of 128 threads per tile (kHalves), each staging all of the
//     tile's rows in batches of 128, so a batch is two whole groups; the
//     walk runs group by group inside the batch and folds once, at the
//     group's end (or at the warp's stop);
//   * at most 80 registers (6 resident blocks per SM; 4 bytes spill), where
//     the uncapped build takes 90 and 5 blocks.
// Predicted before the first timed run: 0.45-0.60 ms on the pass-1 tiles.
// Measured by tools/time_blend.py --kernel x3 (four rounds in turns, one
// call, NVIDIA H100 80GB HBM3 at 700 W; PERF.md, section 6): 0.5349-0.5364
// ms against the earlier design's 1.1134-1.1209 ms, 34x the bound above;
// at opacity 0.99 (94 % of the pixels die) 0.4179-0.4225 against
// 0.8289-0.8390. The box skips 65 % of the (entry, warp) pairs, as in K1;
// without it 0.8030-0.8074. The warp stop's vote costs 2-3 % where no
// pixel dies (0.5197-0.5271 without it) and wins 7 % at opacity 0.99
// (0.4501-0.4509 without it). Earlier forms of this design, in another
// call: the box read from the staged row in the walk 0.598-0.604 ms, the
// reach byte with 90 registers 0.565-0.572.
//
// Every product, sum and the division are rounded on their own (__fmul_rn,
// __fadd_rn, __fdiv_rn; the division is never a reciprocal or
// __fdividef) in the order of the plain version
// (photo_slam_tpu_torch/tools/exp_blend_vec.py::blend_vec_plain); expf is
// the full-precision exp. The plain version sums a group's colour and
// multiplies its om in torch's order, so the two agree within float32
// rounding, not bit for bit.

#include <cuda_runtime.h>

#include "cull_box.cuh"

namespace {

constexpr int kTile = 32;
constexpr int kPixels = kTile * kTile;  // 1024
constexpr int kThreads = 128;           // a block: 4 warps, half a tile
constexpr int kHalves = 2;              // blocks per tile
constexpr int kMinBlocks = 6;           // resident blocks per SM
constexpr int kWarpW = 16;              // a warp's block: 16 x 8 px
constexpr int kWarpH = 8;
constexpr int kPerThread = 4;           // one pixel per 8 x 4 quadrant
constexpr int kFeat = 16;
constexpr int kBatch = kThreads;        // entry rows staged per round
constexpr int kGroup = 64;              // G: entries per group
static_assert(kBatch % kGroup == 0, "a batch holds whole groups");

// The warp stop: true once every lane's pixels are all dead.
__device__ __forceinline__ bool warp_stopped(bool mine_dead) {
  return __all_sync(0xffffffffu, mine_dead);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
blend_vec_fwd_kernel(const float* __restrict__ data,
                     const int* __restrict__ counts, int k_max, int tiles_x,
                     float* __restrict__ color, float* __restrict__ final_t,
                     int* __restrict__ n_contrib) {
  const float kAlphaMax = 0.99f;
  const float kAlphaMin = (float)(1.0 / 255.0);
  const float kTEps = 1e-4f;

  __shared__ float2 s_xy[kBatch];
  __shared__ float4 s_conic_o[kBatch];  // a, b, c, opacity
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

  // This thread's pixel in each of its warp's 16 x 8 block's four 8 x 4
  // quadrants: pixel j at (cx + 8 (j & 1), cy + 4 (j >> 1)).
  const int cx = (warp & 1) * kWarpW + (lane & 7);
  const int cy = (warp >> 1) * kWarpH + (lane >> 3);

  // Per pixel: T before the current group, the colour, n_contrib and
  // death; per pixel and group: the running product s, the product of the
  // applied om and the group's colour sums.
  float px[kPerThread], py[kPerThread];
  float T[kPerThread], cr[kPerThread], cg[kPerThread], cb[kPerThread];
  float s[kPerThread], applied[kPerThread];
  float sr[kPerThread], sg[kPerThread], sb[kPerThread];
  int last[kPerThread];
  bool dead[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    px[j] = ox + (float)(cx + (j & 1) * (kWarpW / 2));
    py[j] = oy + (float)(cy + (j >> 1) * (kWarpH / 2));
    T[j] = 1.0f;
    cr[j] = cg[j] = cb[j] = 0.0f;
    s[j] = applied[j] = 1.0f;
    sr[j] = sg[j] = sb[j] = 0.0f;
    last[j] = 0;
    dead[j] = false;
  }

  for (int base = 0; base < count; base += kBatch) {
    const bool mine_dead = dead[0] && dead[1] && dead[2] && dead[3];
    // The block leaves once every pixel is dead; this is also the barrier
    // before the batch below overwrites shared memory.
    if (__syncthreads_count(mine_dead) == kThreads) break;

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
      const float4 box = cull_box(r0.x, r0.y, r0.z, r0.w, r1.x, r1.y);
      // The rects of this block's warps, 16 x 8 px each, in image pixels.
      unsigned reach = 0;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) {
        const int tw = w + (kThreads / 32) * (blockIdx.x % kHalves);
        const float x0 = ox + (float)((tw & 1) * kWarpW);
        const float y0 = oy + (float)((tw >> 1) * kWarpH);
        reach |= (unsigned)!box_misses(box, x0, x0 + (float)(kWarpW - 1), y0,
                                       y0 + (float)(kWarpH - 1)) << w;
      }
      s_reach[tid] = (unsigned char)reach;
    }
    __syncthreads();
    // A stopped warp folded its last group when it stopped.
    if (warp_stopped(mine_dead)) continue;

    const int n = min(kBatch, count - base);
    for (int g0 = 0; g0 < n; g0 += kGroup) {
      bool stopped = false;
      for (int i = g0; i < min(g0 + kGroup, n); ++i) {
        // Warp-uniform: the entry reaches none of this warp's pixels.
        if (!((s_reach[i] >> (tid >> 5)) & 1u)) continue;
        const float2 xy = s_xy[i];
        const float4 co = s_conic_o[i];
        // The tests of the four pixels first, with no branch between them,
        // so their power and exp chains overlap.
        float alpha[kPerThread];
        bool contrib[kPerThread];
#pragma unroll
        for (int j = 0; j < kPerThread; ++j) {
          const float dx = __fsub_rn(xy.x, px[j]);
          const float dy = __fsub_rn(xy.y, py[j]);
          const float quad = __fadd_rn(__fmul_rn(__fmul_rn(co.x, dx), dx),
                                       __fmul_rn(__fmul_rn(co.z, dy), dy));
          const float power = __fsub_rn(__fmul_rn(-0.5f, quad),
                                        __fmul_rn(__fmul_rn(co.y, dx), dy));
          // min(0.99, .) that keeps a NaN, so a NaN entry fails the alpha
          // test exactly as in the plain version.
          const float a = __fmul_rn(co.w, expf(power));
          alpha[j] = a > kAlphaMax ? kAlphaMax : a;
          contrib[j] = !dead[j] && power <= 0.0f && alpha[j] >= kAlphaMin;
        }
        const float r = s_rgb[0][i], g = s_rgb[1][i], b = s_rgb[2][i];
#pragma unroll
        for (int j = 0; j < kPerThread; ++j) {
          if (!contrib[j]) continue;
          const float om = __fsub_rn(1.0f, alpha[j]);
          s[j] = __fmul_rn(s[j], om);
          const float S = __fmul_rn(T[j], s[j]);
          if (S >= kTEps) {
            const float w = __fmul_rn(alpha[j], __fdiv_rn(S, om));
            sr[j] = __fadd_rn(sr[j], __fmul_rn(r, w));
            sg[j] = __fadd_rn(sg[j], __fmul_rn(g, w));
            sb[j] = __fadd_rn(sb[j], __fmul_rn(b, w));
            applied[j] = __fmul_rn(applied[j], om);
            last[j] = base + i + 1;
          } else {
            dead[j] = true;  // no later entry of the group can be ok
          }
        }
        if (warp_stopped(dead[0] && dead[1] && dead[2] && dead[3])) {
          stopped = true;
          break;
        }
      }
      // The group's end: its colour sums and applied product fold into the
      // pixel, and the group state starts over.
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        cr[j] = __fadd_rn(cr[j], sr[j]);
        cg[j] = __fadd_rn(cg[j], sg[j]);
        cb[j] = __fadd_rn(cb[j], sb[j]);
        T[j] = __fmul_rn(T[j], applied[j]);
        s[j] = applied[j] = 1.0f;
        sr[j] = sg[j] = sb[j] = 0.0f;
      }
      if (stopped) break;
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
extern "C" int blend_vec_fwd_launch(const float* data, const int* counts,
                                    int num_tiles, int k_max, int tiles_x,
                                    float* color, float* final_t,
                                    int* n_contrib, void* stream) {
  if (num_tiles <= 0) return (int)cudaSuccess;
  blend_vec_fwd_kernel<<<kHalves * num_tiles, kThreads, 0,
                         (cudaStream_t)stream>>>(
      data, counts, k_max, tiles_x, color, final_t, n_contrib);
  return (int)cudaGetLastError();
}
