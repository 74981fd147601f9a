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
// Rows at or past the quadrant's count and lanes 9-15 are exact zeros.
//
// What bounds it on this card: by the roofline, reading the table, the
// pixel planes and writing d_data once (more time than its operations at
// the f32 peak); in practice the arithmetic and the pixel reduction, as K2.
// The TPU kernel reduced the per-pixel dL/dpower, alpha T and dL/do into six
// spatial moments and the colour sums by MXU matmuls and formed d mean and
// d conic from the moments in closed form; here, as in K2, each thread
// carries its 4 pixels' state in registers and the sums of dx, dy, dx^2,
// dx dy, dy^2 terms are reduced directly, deterministically:
//   * one block of 64 threads per quadrant, 4 pixels each (K2's loop body);
//   * the walk starts at min(count, the quadrant's largest n_contrib): rows
//     above it have no valid pixel, so their gradient is zero and the TPU
//     kernel's walk over them (to the deepest of the four quadrants) is
//     skipped;
//   * entry rows are staged through shared memory 64 at a time, back to
//     front; each warp reduces its pixels by shuffles (skipped, with zero
//     partials, where no pixel of the warp takes part), lane 0 writes a
//     [warps][9] partial, and after the batch one thread per row sums the
//     two partials in warp order and writes the row. No atomics, so the
//     sums run in one fixed order.
// power and alpha are rounded exactly as in the forward (__fmul_rn /
// __fadd_rn, the full-precision expf), so both take the same entries.

#include <cuda_runtime.h>

namespace {

constexpr int kQuad = 16;
constexpr int kPixels = kQuad * kQuad;  // 256 per quadrant
constexpr int kThreads = 64;
constexpr int kPerThread = kPixels / kThreads;  // 4
constexpr int kWarps = kThreads / 32;           // 2
constexpr int kFeat = 16;
constexpr int kQuads = 4;  // table rows per entry, one per quadrant
constexpr int kGrad = 9;   // gradient lanes 0-8
constexpr int kBatch = 64;

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

  __shared__ float2 s_xy[kBatch];
  __shared__ float4 s_conic_o[kBatch];  // a, b, c, opacity
  __shared__ float s_rgb[3][kBatch];
  __shared__ float s_part[kBatch][kWarps][kGrad];
  __shared__ int s_warp_nc[kWarps];

  const int quad = blockIdx.x;  // 4 b + q
  const int b = quad >> 2;
  const int q = quad & 3;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // Row [b, k, q] of d16c and d_data: kQuads * kFeat floats apart in k.
  const size_t row0 = ((size_t)b * k_max * kQuads + q) * kFeat;
  const size_t rstride = (size_t)kQuads * kFeat;
  const float* rows = d16c + row0;
  const size_t pix0 = (size_t)b * 4 * kPixels + (size_t)q * kPixels;
  const size_t col0 = (size_t)b * 3 * 4 * kPixels + (size_t)q * kPixels;

  float px[kPerThread], py[kPerThread], T[kPerThread], Bc[kPerThread];
  float gr[kPerThread], gg[kPerThread], gb[kPerThread], gtt[kPerThread];
  int nc[kPerThread];
  int nc_max = 0;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int p = tid + kThreads * j;
    px[j] = (float)(p % kQuad);
    py[j] = (float)(p / kQuad);
    T[j] = final_t[pix0 + p];
    Bc[j] = 0.0f;
    gr[j] = g_color[col0 + p];
    gg[j] = g_color[col0 + 4 * kPixels + p];
    gb[j] = g_color[col0 + 8 * kPixels + p];
    gtt[j] = g_t[pix0 + p] * T[j];
    nc[j] = n_contrib[pix0 + p];
    nc_max = max(nc_max, nc[j]);
  }
  // The quadrant's largest n_contrib bounds the walk.
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    nc_max = max(nc_max, __shfl_down_sync(0xffffffffu, nc_max, off));
  if (lane == 0) s_warp_nc[warp] = nc_max;
  __syncthreads();
  int block_nc = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) block_nc = max(block_nc, s_warp_nc[w]);
  const int count = min(min(max(counts_q[quad], 0), k_max), block_nc);

  // Rows from the walk's start up: exact zeros.
  float4* out4 = reinterpret_cast<float4*>(d_data + row0);
  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int e = count * 4 + tid; e < k_max * 4; e += kThreads)
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
    }
    __syncthreads();

    for (int i = n - 1; i >= 0; --i) {
      const int k = lo + i;
      const float2 xy = s_xy[i];
      const float4 co = s_conic_o[i];
      const float cr = s_rgb[0][i], cg = s_rgb[1][i], cb = s_rgb[2][i];
      float acc[kGrad];
#pragma unroll
      for (int g = 0; g < kGrad; ++g) acc[g] = 0.0f;
      bool any = false;
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        if (k >= nc[j]) continue;
        const float dx = __fsub_rn(xy.x, px[j]);
        const float dy = __fsub_rn(xy.y, py[j]);
        const float quad_form = __fadd_rn(__fmul_rn(__fmul_rn(co.x, dx), dx),
                                          __fmul_rn(__fmul_rn(co.z, dy), dy));
        const float power = __fsub_rn(__fmul_rn(-0.5f, quad_form),
                                      __fmul_rn(__fmul_rn(co.y, dx), dy));
        if (power > 0.0f) continue;
        const float ex = expf(power);
        const float raw = __fmul_rn(co.w, ex);
        const float alpha = raw > kAlphaMax ? kAlphaMax : raw;
        if (!(alpha >= kAlphaMin)) continue;
        any = true;
        const float om = fmaxf(1.0f - alpha, 0.01f);
        T[j] = T[j] / om;
        const float aT = alpha * T[j];
        const float gc = gr[j] * cr + gg[j] * cg + gb[j] * cb;
        const float dl_dalpha =
            raw < kAlphaMax ? gc * T[j] - (Bc[j] + gtt[j]) / om : 0.0f;
        Bc[j] += aT * gc;
        const float dl_do = dl_dalpha * ex;
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
      if (__any_sync(0xffffffffu, any)) {
#pragma unroll
        for (int g = 0; g < kGrad; ++g) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            acc[g] += __shfl_down_sync(0xffffffffu, acc[g], off);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int g = 0; g < kGrad; ++g) s_part[i][warp][g] = acc[g];
      }
    }
    __syncthreads();

    if (tid < n) {
      float s[kGrad];
#pragma unroll
      for (int g = 0; g < kGrad; ++g) {
        float v = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) v += s_part[tid][w][g];
        s[g] = v;
      }
      // This row's conic a, b, c, staged by this thread above.
      const float4 co = s_conic_o[tid];
      const float ca = co.x, cb_ = co.y, cc = co.z;
      float4* row = out4 + (size_t)(lo + tid) * (rstride / 4);
      row[0] = make_float4(-(ca * s[0] + cb_ * s[1]),
                           -(cc * s[1] + cb_ * s[0]), -0.5f * s[2], -s[3]);
      row[1] = make_float4(-0.5f * s[4], s[5], s[6], s[7]);
      row[2] = make_float4(s[8], 0.0f, 0.0f, 0.0f);
      row[3] = zero4;
    }
    // The next round's staging overwrites what this round read.
    __syncthreads();
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
  blend16_bwd_kernel<<<4 * num_blocks, kThreads, 0, (cudaStream_t)stream>>>(
      d16c, counts_q, final_t, n_contrib, g_color, g_t, k_max, d_data);
  return (int)cudaGetLastError();
}
