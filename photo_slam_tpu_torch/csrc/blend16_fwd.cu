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
// flat offsets 256 q .. 256 q + 255 of each [8, 128] plane.
//
// What bounds it on this card: by the roofline, reading the table once
// (a little more time than its operations at the f32 peak); in practice the
// arithmetic, as K1 (an exp and ~20 separately rounded products and sums
// per entry-pixel pair, not fused), keeps it well above both. The point of the
// experiment is fewer pairs: a Gaussian binned at 16 px pays for the pixels
// of the 16x16 tiles it touches, not of a 32x32 tile. The TPU packed four
// quadrants into one vreg and ran them to the deepest quadrant's count with
// a mask; here each quadrant is its own block, so each stops at its own
// count and its own last live pixel, and the block count (4 per 32 px
// block) is four times K1's, which fills the card's SMs more evenly:
//   * 64 threads per quadrant, 4 pixels each (pixel p = threadIdx.x + 64 j),
//     the inner loop of K1 unchanged;
//   * the entry rows are staged through shared memory 64 at a time, one row
//     per thread, and read back as broadcasts;
//   * the block leaves once all 256 pixels have stopped (__syncthreads_count).
//     Rows at index >= counts_q are never read.
// Every product and sum is rounded on its own (__fmul_rn / __fadd_rn) in the
// order of the plain version (photo_slam_tpu_torch/tools/exp_blend16.py::
// blend16_fwd_plain), and expf is the full-precision exp.

#include <cuda_runtime.h>

namespace {

constexpr int kQuad = 16;
constexpr int kPixels = kQuad * kQuad;  // 256 per quadrant
constexpr int kThreads = 64;
constexpr int kPerThread = kPixels / kThreads;  // 4
constexpr int kFeat = 16;
constexpr int kQuads = 4;  // table rows per entry, one per quadrant
constexpr int kBatch = kThreads;

__global__ void __launch_bounds__(kThreads)
blend16_fwd_kernel(const float* __restrict__ d16c,
                   const int* __restrict__ counts_q, int k_max,
                   float* __restrict__ color, float* __restrict__ final_t,
                   int* __restrict__ n_contrib) {
  const float kAlphaMax = 0.99f;
  const float kAlphaMin = (float)(1.0 / 255.0);
  const float kTEps = 1e-4f;

  __shared__ float2 s_xy[kBatch];
  __shared__ float4 s_conic_o[kBatch];  // a, b, c, opacity
  __shared__ float s_rgb[3][kBatch];

  const int quad = blockIdx.x;  // 4 b + q
  const int b = quad >> 2;
  const int q = quad & 3;
  const int tid = threadIdx.x;
  const int count = min(max(counts_q[quad], 0), k_max);
  // Entry k of this quadrant: d16c[b, k, q, :], kQuads * kFeat floats apart.
  const float* rows = d16c + ((size_t)b * k_max * kQuads + q) * kFeat;
  const size_t stride = (size_t)kQuads * kFeat;

  float px[kPerThread], py[kPerThread];
  float T[kPerThread], cr[kPerThread], cg[kPerThread], cb[kPerThread];
  int last[kPerThread];
  bool done[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int p = tid + kThreads * j;
    px[j] = (float)(p % kQuad);
    py[j] = (float)(p / kQuad);
    T[j] = 1.0f;
    cr[j] = cg[j] = cb[j] = 0.0f;
    last[j] = 0;
    done[j] = false;
  }

  for (int base = 0; base < count; base += kBatch) {
    bool mine_done = true;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) mine_done = mine_done && done[j];
    if (__syncthreads_count(mine_done) == kThreads) break;

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
    }
    __syncthreads();

    const int n = min(kBatch, count - base);
    for (int i = 0; i < n; ++i) {
      const float2 xy = s_xy[i];
      const float4 co = s_conic_o[i];
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        if (done[j]) continue;
        const float dx = __fsub_rn(xy.x, px[j]);
        const float dy = __fsub_rn(xy.y, py[j]);
        const float quad_form = __fadd_rn(__fmul_rn(__fmul_rn(co.x, dx), dx),
                                          __fmul_rn(__fmul_rn(co.z, dy), dy));
        const float power = __fsub_rn(__fmul_rn(-0.5f, quad_form),
                                      __fmul_rn(__fmul_rn(co.y, dx), dy));
        if (power > 0.0f) continue;
        // min(0.99, .) that keeps a NaN, as the plain version's clamp does.
        float alpha = __fmul_rn(co.w, expf(power));
        alpha = alpha > kAlphaMax ? kAlphaMax : alpha;
        if (!(alpha >= kAlphaMin)) continue;
        const float test_t = __fmul_rn(T[j], __fsub_rn(1.0f, alpha));
        if (test_t < kTEps) {
          done[j] = true;
          continue;
        }
        const float w = __fmul_rn(alpha, T[j]);
        cr[j] = __fadd_rn(cr[j], __fmul_rn(w, s_rgb[0][i]));
        cg[j] = __fadd_rn(cg[j], __fmul_rn(w, s_rgb[1][i]));
        cb[j] = __fadd_rn(cb[j], __fmul_rn(w, s_rgb[2][i]));
        T[j] = test_t;
        last[j] = base + i + 1;
      }
    }
  }

  // Quadrant q's pixels sit at flat offsets 256 q + p of the [8, 128] plane.
  const size_t pix0 = (size_t)b * 4 * kPixels + (size_t)q * kPixels;
  float* col = color + (size_t)b * 3 * 4 * kPixels + (size_t)q * kPixels;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int p = tid + kThreads * j;
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
  blend16_fwd_kernel<<<4 * num_blocks, kThreads, 0, (cudaStream_t)stream>>>(
      d16c, counts_q, k_max, color, final_t, n_contrib);
  return (int)cudaGetLastError();
}
