// Tile blend forward for Hopper (sm_90a).
//
// Replaces the TPU kernel photo_slam_tpu/ops/pallas/blend.py::_fwd_kernel
// (launched by _blend_fwd_call, exposed as pallas_blend). Same contract:
// one block per 32x32-pixel tile (block b rasterizes image tile
// tile_ids[b]); the tile's depth-ordered [K, 16] entries are composited
// front to back; per entry
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy,  alpha = min(0.99, o e^power),
// skipped when power > 0 or alpha < 1/255; a pixel stops at the first entry
// whose T (1 - alpha) would fall below 1e-4, and that entry is not applied.
// Outputs color [B, 3, 1024], final T [B, 1024] and n_contrib [B, 1024]
// (index of the last applied entry + 1). No background.
//
// What bounds it on this card: arithmetic, not memory. Each (entry, pixel)
// pair costs an exp and about twenty separately rounded multiplies and adds
// (FP32 instruction throughput); the entry rows are read once per tile
// (64 B each) and are a small share of the time. One block per tile also
// means few blocks (836 at 1200x680, 1.6 waves of the card at 4 resident
// blocks per SM) of unequal depth, so the last wave runs partly empty. The
// TPU kernel's group vectorization, roll-ladder prefix products and MXU
// colour FMAs worked around a machine without scalar threads; here each
// thread composites its own pixels sequentially in registers, as the CUDA
// original does (cuda_rasterizer/forward.cu:261-374):
//   * 256 threads per tile, 4 pixels each (pixel p = threadIdx.x + 256 j,
//     so output stores are coalesced);
//   * the entry rows are staged through shared memory 256 at a time, one
//     row per thread, and read back as broadcasts;
//   * the block leaves once every pixel has stopped (__syncthreads_count),
//     which also serves as the barrier before the next batch overwrites
//     shared memory. Rows at index >= counts[b] are never read.
// Every product and sum is rounded on its own (__fmul_rn / __fadd_rn never
// contract into FMAs) in the order the plain PyTorch version
// (ops/blend.py::blend_fwd_plain) evaluates it, and expf is the full-
// precision libm exp, so the two agree to the last bit except where the two
// exp implementations differ.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kPixels = kTile * kTile;  // 1024
constexpr int kThreads = 256;
constexpr int kPerThread = kPixels / kThreads;  // 4
constexpr int kFeat = 16;
constexpr int kBatch = kThreads;  // entry rows staged per round

__global__ void __launch_bounds__(kThreads)
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

  const int blk = blockIdx.x;
  const int tid = threadIdx.x;
  const int count = min(counts[blk], k_max);
  const int tile = tile_ids[blk];
  const float ox = (float)((tile % tiles_x) * kTile);
  const float oy = (float)((tile / tiles_x) * kTile);
  const float* rows = data + (size_t)blk * k_max * kFeat;

  float px[kPerThread], py[kPerThread];
  float T[kPerThread], cr[kPerThread], cg[kPerThread], cb[kPerThread];
  int last[kPerThread];
  bool done[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int p = tid + kThreads * j;
    px[j] = ox + (float)(p % kTile);
    py[j] = oy + (float)(p / kTile);
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
      const float4* r = reinterpret_cast<const float4*>(rows + (size_t)k * kFeat);
      const float4 r0 = r[0];  // x, y, a, b
      const float4 r1 = r[1];  // c, opacity, r, g
      const float b2 = rows[(size_t)k * kFeat + 8];
      s_xy[tid] = make_float2(r0.x, r0.y);
      s_conic_o[tid] = make_float4(r0.z, r0.w, r1.x, r1.y);
      s_rgb[0][tid] = r1.z;
      s_rgb[1][tid] = r1.w;
      s_rgb[2][tid] = b2;
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
        const float quad = __fadd_rn(__fmul_rn(__fmul_rn(co.x, dx), dx),
                                     __fmul_rn(__fmul_rn(co.z, dy), dy));
        const float power = __fsub_rn(__fmul_rn(-0.5f, quad),
                                      __fmul_rn(__fmul_rn(co.y, dx), dy));
        if (power > 0.0f) continue;
        // min(0.99, .) that keeps a NaN (fminf would drop it), so a NaN
        // entry is skipped by the next test exactly as in the plain version.
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

  float* col = color + (size_t)blk * 3 * kPixels;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int p = tid + kThreads * j;
    col[p] = cr[j];
    col[kPixels + p] = cg[j];
    col[2 * kPixels + p] = cb[j];
    final_t[(size_t)blk * kPixels + p] = T[j];
    n_contrib[(size_t)blk * kPixels + p] = last[j];
  }
}

}  // namespace

// data [B, K, 16] f32, counts [B] i32, tile_ids [B] i32 (all contiguous, on
// the device); color [B, 3, 1024] f32, final_t [B, 1024] f32, n_contrib
// [B, 1024] i32 are written in full. Returns the launch's cudaError_t.
extern "C" int blend_fwd_launch(const float* data, const int* counts,
                                const int* tile_ids, int num_blocks, int k_max,
                                int tiles_x, float* color, float* final_t,
                                int* n_contrib, void* stream) {
  if (num_blocks <= 0) return (int)cudaSuccess;
  blend_fwd_kernel<<<num_blocks, kThreads, 0, (cudaStream_t)stream>>>(
      data, counts, tile_ids, k_max, tiles_x, color, final_t, n_contrib);
  return (int)cudaGetLastError();
}
