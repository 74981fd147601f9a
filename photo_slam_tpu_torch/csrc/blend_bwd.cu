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
// What bounds it on this card: arithmetic and the pixel reduction. Each
// (entry, pixel) pair costs an exp, a division and ~45 FLOPs, and each entry
// then reduces nine sums over the tile's 1024 pixels. The entry rows are
// read once (64 B) and the gradient rows written once (64 B), a small share
// of the time. The TPU kernel's group-vectorized suffix-product ladders,
// T rebuilt by dividing suffix products and MXU moment matmuls worked around
// a machine without scalar threads; here, as in the CUDA original, each
// thread carries its 4 pixels' T, Bc, g and g_T final_T in registers and
// walks the entries sequentially:
//   * 256 threads per tile, 4 pixels each (pixel p = threadIdx.x + 256 j,
//     K1's layout, so both kernels index a tile alike);
//   * entry rows are staged through shared memory kBatch at a time, back to
//     front;
//   * the reduction is deterministic, with no atomics: each thread sums its
//     4 pixels, each warp reduces by shuffles (skipped, with zero partials,
//     when no pixel of the warp takes part in the entry), lane 0 writes a
//     [warps][9] partial to shared memory, and after the batch one thread
//     per row sums the partials in warp order and writes the row.
// power and alpha are rounded exactly as in K1 (__fmul_rn / __fadd_rn, the
// full-precision expf), so the two kernels take the same entries; the
// remaining products may contract into FMAs.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kPixels = kTile * kTile;  // 1024
constexpr int kThreads = 256;
constexpr int kPerThread = kPixels / kThreads;  // 4
constexpr int kWarps = kThreads / 32;           // 8
constexpr int kFeat = 16;
constexpr int kGrad = 9;    // gradient lanes 0-8
constexpr int kBatch = 64;  // entry rows staged and reduced per round

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
  __shared__ float s_part[kBatch][kWarps][kGrad];

  const int blk = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int count = min(max(counts[blk], 0), k_max);
  const int tile = tile_ids[blk];
  const float ox = (float)((tile % tiles_x) * kTile);
  const float oy = (float)((tile / tiles_x) * kTile);
  const float* rows = data + (size_t)blk * k_max * kFeat;
  float* out = d_data + (size_t)blk * k_max * kFeat;
  const size_t pix0 = (size_t)blk * kPixels;

  float px[kPerThread], py[kPerThread], T[kPerThread], Bc[kPerThread];
  float gr[kPerThread], gg[kPerThread], gb[kPerThread], gtt[kPerThread];
  int nc[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int p = tid + kThreads * j;
    px[j] = ox + (float)(p % kTile);
    py[j] = oy + (float)(p / kTile);
    T[j] = final_t[pix0 + p];
    Bc[j] = 0.0f;
    gr[j] = g_color[3 * pix0 + p];
    gg[j] = g_color[3 * pix0 + kPixels + p];
    gb[j] = g_color[3 * pix0 + 2 * kPixels + p];
    gtt[j] = g_t[pix0 + p] * T[j];
    nc[j] = n_contrib[pix0 + p];
  }

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
    }
    __syncthreads();

    for (int i = n - 1; i >= 0; --i) {
      const int k = lo + i;
      const float2 xy = s_xy[i];
      const float4 co = s_conic_o[i];
      const float cr = s_rgb[0][i], cg = s_rgb[1][i], cb = s_rgb[2][i];
      float acc[kGrad];
#pragma unroll
      for (int q = 0; q < kGrad; ++q) acc[q] = 0.0f;
      bool any = false;
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        if (k >= nc[j]) continue;
        const float dx = __fsub_rn(xy.x, px[j]);
        const float dy = __fsub_rn(xy.y, py[j]);
        const float quad = __fadd_rn(__fmul_rn(__fmul_rn(co.x, dx), dx),
                                     __fmul_rn(__fmul_rn(co.z, dy), dy));
        const float power = __fsub_rn(__fmul_rn(-0.5f, quad),
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
        for (int q = 0; q < kGrad; ++q) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            acc[q] += __shfl_down_sync(0xffffffffu, acc[q], off);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int q = 0; q < kGrad; ++q) s_part[i][warp][q] = acc[q];
      }
    }
    __syncthreads();

    if (tid < n) {
      float s[kGrad];
#pragma unroll
      for (int q = 0; q < kGrad; ++q) {
        float v = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) v += s_part[tid][w][q];
        s[q] = v;
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

// data [B, K, 16] f32, counts [B] i32 (counts_eff), tile_ids [B] i32,
// final_t [B, 1024] f32, n_contrib [B, 1024] i32, g_color [B, 3, 1024] f32,
// g_t [B, 1024] f32 (all contiguous, on the device, data 16-byte aligned);
// d_data [B, K, 16] f32 is written in full. Returns the launch's cudaError_t.
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
