// Quadrant blend forward at 16x16 px for Hopper (sm_90a): the X4 forward.
//
// Replaces the TPU kernel tools/exp_blend16.py::_fwd_kernel16 (launched by
// blend16_call). The experiment bins at 16 px and packs four 16x16 tiles
// (the quadrants q = 0..3 of a 32x32 block) into one [8, 128] TPU tile:
// sublane band 2q..2q+1 holds quadrant q's 256 pixels, p = (row % 2) * 128
// + lane, at quadrant-local lx = p % 16, ly = p / 16. Entry k of quadrant q
// of block b is d16c[b, k, q, :] (the TPU kernel reads it from a slab that
// repeats it on sublanes 2q and 2q + 1; no copy is made here), with its
// mean already in quadrant-local pixels, and the quadrant's count is
// counts_q[4b + q]. Per
// pixel it is K1's function (csrc/blend_fwd.cu): front to back,
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy,  alpha = min(0.99, o e^power),
// skipped when power > 0 or alpha < 1/255, stopping before the entry whose
// T (1 - alpha) would fall below 1e-4. Outputs keep the TPU layout: color
// [B, 3, 8, 128], final T [B, 8, 128], n_contrib [B, 8, 128], quadrant q at
// flat offsets 256 q .. 256 q + 255 of each [8, 128] plane. Rows at index
// >= counts_q are never read.
//
// What bounds it on this card: arithmetic, as K1 (an exp and ~20
// separately rounded products and sums per entry-pixel pair it evaluates,
// not fused); the table rows are read once. The point of the experiment is
// fewer pairs: a Gaussian binned at 16 px pays for the pixels of the 16x16
// tiles it touches, not of a 32x32 tile.
//
// Where the earlier design lost its time (0.5002 ms on X4's table
// [836, 768, 4, 16], 24x its bound, against K1's 0.4071 on the 32 px
// tiles; NVIDIA H100 80GB HBM3 at 700 W): it was K1's first design at
// 16 px, one 64-thread block per quadrant:
//   * pixel p = threadIdx.x + 64 j, so each of a quadrant's two warps held
//     rows spread over all 16 of its rows and every entry touched both;
//   * no per-entry box: every pair paid the power, the exp and the tests;
//   * each pixel was tested behind branches, one after another;
//   * the only stop was the block's, once per batch of 64 rows.
// This design is K1's walk in X4b's quadrant frame (csrc/blend16_bwd.cu):
//   * a quadrant is two of K1's 16 x 8 px warp blocks: warp w of a quadrant
//     owns its rows 8 w to 8 w + 7, lane l = lx + 8 ly holds pixel
//     (lx + 8 (j & 1), 8 w + ly + 4 (j >> 1)) in slot j, one per 8 x 4
//     quadrant of the warp's block;
//   * one 256-thread block per 32 px block: its four quadrants each on
//     their own two warps, with their own staged rows (batches of 64) and
//     their own named barrier (bar.sync 1 + q, 64 threads), so a quadrant
//     never waits for another, and their table rows, adjacent in d16c, are
//     read together;
//   * the staging thread computes each row's box (cull_box.cuh, shared with
//     K1) from the row's quadrant-local mean, so the box is in the same
//     frame as dx, dy, and tests it against the rects of the quadrant's two
//     warps, keeping one bit per warp (s_reach). A warp skips an entry whose
//     bit is clear with no power, exp or test: power and alpha round as in
//     K1, so the box holds every pair at which a pixel's state changes;
//   * the four pixel tests run with no branch between them, then each
//     pixel is applied or stopped under its own predicate;
//   * a warp stops on its own once all 128 of its pixels have stopped
//     (__all_sync after each entry it evaluates). The quadrants run
//     different numbers of batches, so a block-wide barrier inside the walk
//     would make one wait on another: a quadrant leaves at a batch boundary
//     once both its warps have stopped, by a vote through shared memory
//     behind its own barrier.
// Predicted before the first timed run: 0.38-0.46 ms on X4's table.
// Measured by tools/time_blend.py --kernel x4f (four rounds in turns, one
// call, NVIDIA H100 80GB HBM3 at 700 W; PERF.md, section 6): 0.3889-0.4027
// ms against the earlier design's 0.4993-0.5012 (K1: 0.4085 on the 32 px
// tiles in one chip_smoke.py run); with every opacity at 0.99
// 0.2644-0.2661 against 0.3583-0.3585. The box skips 27.9 % of the (entry,
// warp) pairs; without it 0.4782-0.4922. Without the warp stop
// 0.3831-0.3877, and 0.2994-0.3087 at opacity 0.99; with one quadrant per
// 64-thread block 0.4606-0.4632 (0.3079-0.3105). 64 registers, no spills.
//
// Every product and sum is rounded on its own (__fmul_rn / __fadd_rn) in the
// order of the plain version (photo_slam_tpu_torch/tools/exp_blend16.py::
// blend16_fwd_plain), and expf is the full-precision exp.

#include <cuda_runtime.h>

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
constexpr int kBatch = kQuadThreads;       // rows staged per round

// The barrier of one quadrant's 64 threads (named barrier 1 + its slot in
// the block; barrier 0 is __syncthreads').
__device__ __forceinline__ void quad_sync(int slot) {
  asm volatile("bar.sync %0, %1;" ::"r"(slot + 1), "r"(kQuadThreads)
               : "memory");
}

// The warp stop: true once every lane's pixels have all stopped.
__device__ __forceinline__ bool warp_stopped(bool mine_done) {
  return __all_sync(0xffffffffu, mine_done);
}

// Whether every pixel of the quadrant has stopped: each warp's vote goes
// through shared memory behind the quadrant's barrier, which is also the
// barrier before the next batch overwrites the quadrant's staged rows. A
// warp writes its vote again only after the next barrier, which every
// thread of the quadrant reaches after reading this one.
__device__ __forceinline__ bool quad_done(bool mine_done, int slot, int warp,
                                          volatile int* s_vote) {
  const bool warp_done = __all_sync(0xffffffffu, mine_done);
  if ((threadIdx.x & 31) == 0) s_vote[warp] = warp_done;
  quad_sync(slot);
  bool all = true;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) all = all && s_vote[w];
  return all;
}

__global__ void __launch_bounds__(kThreads)
blend16_fwd_kernel(const float* __restrict__ d16c,
                   const int* __restrict__ counts_q, int k_max,
                   float* __restrict__ color, float* __restrict__ final_t,
                   int* __restrict__ n_contrib) {
  const float kAlphaMax = 0.99f;
  const float kAlphaMin = (float)(1.0 / 255.0);
  const float kTEps = 1e-4f;

  __shared__ float2 s_xy_[kQuadsPerBlock][kBatch];
  __shared__ float4 s_conic_o_[kQuadsPerBlock][kBatch];  // a, b, c, opacity
  __shared__ float s_rgb_[kQuadsPerBlock][3][kBatch];
  // Bit w: the row's box reaches warp w of the quadrant.
  __shared__ unsigned char s_reach_[kQuadsPerBlock][kBatch];
  __shared__ int s_vote_[kQuadsPerBlock][kWarps];

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

  const int count = min(max(counts_q[quad], 0), k_max);
  // Entry k of this quadrant: d16c[b, k, q, :], kQuads * kFeat floats apart.
  const float* rows = d16c + ((size_t)b * k_max * kQuads + q) * kFeat;
  const size_t stride = (size_t)kQuads * kFeat;

  // This thread's pixel in each of its warp's 16 x 8 block's four 8 x 4
  // quadrants (quadrant-local pixels): pixel j at (cx + 8 (j & 1),
  // cy + 4 (j >> 1)).
  const int cx = lane & 7;
  const int cy = warp * kWarpH + (lane >> 3);

  float px[kPerThread], py[kPerThread];
  float T[kPerThread], cr[kPerThread], cg[kPerThread], cb[kPerThread];
  int last[kPerThread];
  bool done[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    px[j] = (float)(cx + (j & 1) * (kWarpW / 2));
    py[j] = (float)(cy + (j >> 1) * (kWarpH / 2));
    T[j] = 1.0f;
    cr[j] = cg[j] = cb[j] = 0.0f;
    last[j] = 0;
    done[j] = false;
  }

  for (int base = 0; base < count; base += kBatch) {
    const bool mine_done = done[0] && done[1] && done[2] && done[3];
    if (quad_done(mine_done, slot, warp, s_vote_[slot])) break;

    const int k = base + tid;
    if (k < count) {
      const float* row = rows + (size_t)k * stride;
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
    if (warp_stopped(mine_done)) continue;

    const int n = min(kBatch, count - base);
    for (int i = 0; i < n; ++i) {
      // Warp-uniform: the entry reaches none of this warp's pixels.
      if (!((s_reach[i] >> warp) & 1u)) continue;
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
        const float quad_form = __fadd_rn(__fmul_rn(__fmul_rn(co.x, dx), dx),
                                          __fmul_rn(__fmul_rn(co.z, dy), dy));
        const float power = __fsub_rn(__fmul_rn(-0.5f, quad_form),
                                      __fmul_rn(__fmul_rn(co.y, dx), dy));
        // min(0.99, .) that keeps a NaN, as the plain version's clamp does.
        const float a = __fmul_rn(co.w, expf(power));
        alpha[j] = a > kAlphaMax ? kAlphaMax : a;
        ok[j] = !done[j] && power <= 0.0f && alpha[j] >= kAlphaMin;
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

  // Quadrant q's pixels sit at flat offsets 256 q + p of the [8, 128] plane.
  const size_t pix0 = (size_t)b * 4 * kPixels + (size_t)q * kPixels;
  float* col = color + (size_t)b * 3 * 4 * kPixels + (size_t)q * kPixels;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int p = (int)py[j] * kQuad + (int)px[j];
    col[p] = cr[j];
    col[4 * kPixels + p] = cg[j];
    col[8 * kPixels + p] = cb[j];
    final_t[pix0 + p] = T[j];
    n_contrib[pix0 + p] = last[j];
  }
}

}  // namespace

// d16c [B, K, 4, 16] f32 (16-byte aligned), counts_q [4 B] i32 (all
// contiguous, on the device); color [B, 3, 8, 128] f32, final_t [B, 8, 128]
// f32 and n_contrib [B, 8, 128] i32 are written in full. Returns the
// launch's cudaError_t.
extern "C" int blend16_fwd_launch(const float* d16c, const int* counts_q,
                                  int num_blocks, int k_max, float* color,
                                  float* final_t, int* n_contrib,
                                  void* stream) {
  if (num_blocks <= 0) return (int)cudaSuccess;
  static_assert(kQuads % kQuadsPerBlock == 0, "whole blocks of quadrants");
  blend16_fwd_kernel<<<kQuads / kQuadsPerBlock * num_blocks, kThreads, 0,
                       (cudaStream_t)stream>>>(
      d16c, counts_q, k_max, color, final_t, n_contrib);
  return (int)cudaGetLastError();
}
