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
// computes two pixels, so the 11 operations of dx, dy and power and the
// alpha product run at up to twice K1's instruction rate; the exp (in f32)
// and the f32 tail do not. Design:
//   * 256 threads per tile, 4 pixels each, as K1; a thread holds its pixels
//     as two bf16x2 pairs, (p, p + 256) and (p + 512, p + 768), which share
//     lx and differ in ly by 8;
//   * the entry rows are staged through shared memory 256 at a time, already
//     rounded to bf16 (one conversion per entry, not per pixel);
//   * the block leaves once every pixel has stopped (__syncthreads_count).
// The bf16 operations are the explicitly rounded intrinsics (__hsub2_rn,
// __hmul2_rn, __hadd2_rn), which ptxas may not contract into fused
// multiply-adds, in the order of the plain version
// (photo_slam_tpu_torch/tools/exp_blend_bf16.py::call_bf16_plain); the f32
// tail rounds as K1 does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kPixels = kTile * kTile;  // 1024
constexpr int kThreads = 256;
constexpr int kPerThread = kPixels / kThreads;  // 4
constexpr int kPairs = kPerThread / 2;          // 2 bf16x2 pairs
constexpr int kFeat = 16;
constexpr int kBatch = kThreads;

__global__ void __launch_bounds__(kThreads)
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

  __shared__ __nv_bfloat162 s_m[kBatch];   // (mx, my)
  __shared__ __nv_bfloat162 s_ab[kBatch];  // (a, b)
  __shared__ __nv_bfloat162 s_co[kBatch];  // (c, o)
  __shared__ float s_rgb[3][kBatch];

  const int blk = blockIdx.x;
  const int tid = threadIdx.x;
  const int count = min(max(counts[blk], 0), k_max);
  const float ox = (float)((blk % tiles_x) * kTile);
  const float oy = (float)((blk / tiles_x) * kTile);
  const float* rows = data + (size_t)blk * k_max * kFeat;
  const __nv_bfloat162 neg_half = __float2bfloat162_rn(-0.5f);

  // Pair m holds pixels p0 = tid + 512 m and p0 + 256 (lanes .x and .y).
  __nv_bfloat162 lx[kPairs], ly[kPairs];
  float T[kPerThread], cr[kPerThread], cg[kPerThread], cb[kPerThread];
  int last[kPerThread];
  bool done[kPerThread];
#pragma unroll
  for (int m = 0; m < kPairs; ++m) {
    const int p0 = tid + 2 * kThreads * m;
    lx[m] = __float2bfloat162_rn((float)(p0 % kTile));
    ly[m] = __floats2bfloat162_rn((float)(p0 / kTile),
                                  (float)((p0 + kThreads) / kTile));
  }
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
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
      const float* row = rows + (size_t)k * kFeat;
      const float4 r0 = reinterpret_cast<const float4*>(row)[0];  // x, y, a, b
      const float4 r1 = reinterpret_cast<const float4*>(row)[1];  // c, o, r, g
      s_m[tid] = __floats2bfloat162_rn(__fsub_rn(r0.x, ox),
                                       __fsub_rn(r0.y, oy));
      s_ab[tid] = __floats2bfloat162_rn(r0.z, r0.w);
      s_co[tid] = __floats2bfloat162_rn(r1.x, r1.y);
      s_rgb[0][tid] = r1.z;
      s_rgb[1][tid] = r1.w;
      s_rgb[2][tid] = row[8];
    }
    __syncthreads();

    const int n = min(kBatch, count - base);
    for (int i = 0; i < n; ++i) {
      const __nv_bfloat162 mm = s_m[i], ab = s_ab[i], co = s_co[i];
      const __nv_bfloat162 mx = __low2bfloat162(mm), my = __high2bfloat162(mm);
      const __nv_bfloat162 a = __low2bfloat162(ab), b = __high2bfloat162(ab);
      const __nv_bfloat162 c = __low2bfloat162(co), o = __high2bfloat162(co);
#pragma unroll
      for (int m = 0; m < kPairs; ++m) {
        if (done[2 * m] && done[2 * m + 1]) continue;
        const __nv_bfloat162 dx = __hsub2_rn(mx, lx[m]);
        const __nv_bfloat162 dy = __hsub2_rn(my, ly[m]);
        const __nv_bfloat162 quad =
            __hadd2_rn(__hmul2_rn(__hmul2_rn(a, dx), dx),
                       __hmul2_rn(__hmul2_rn(c, dy), dy));
        const __nv_bfloat162 power =
            __hsub2_rn(__hmul2_rn(neg_half, quad),
                       __hmul2_rn(__hmul2_rn(b, dx), dy));
        const float2 pf = __bfloat1622float2(power);
        const __nv_bfloat162 e = __floats2bfloat162_rn(expf(pf.x), expf(pf.y));
        const float2 af = __bfloat1622float2(__hmul2_rn(o, e));
        const float pw[2] = {pf.x, pf.y};
        const float al[2] = {af.x, af.y};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = 2 * m + h;
          if (done[j] || pw[h] > 0.0f) continue;
          // min(bf16(0.99), .) that keeps a NaN, as the plain version's
          // clamp does (exact: both sides are bf16 values).
          const float alpha = al[h] > kAlphaMax ? kAlphaMax : al[h];
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
  }

  float* col = color + (size_t)blk * 3 * kPixels;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    // Pixel j of this thread: pair j / 2, lane j % 2.
    const int p = tid + 2 * kThreads * (j / 2) + kThreads * (j % 2);
    col[p] = cr[j];
    col[kPixels + p] = cg[j];
    col[2 * kPixels + p] = cb[j];
    final_t[(size_t)blk * kPixels + p] = T[j];
    n_contrib[(size_t)blk * kPixels + p] = last[j];
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
  blend_bf16_fwd_kernel<<<num_tiles, kThreads, 0, (cudaStream_t)stream>>>(
      data, counts, k_max, tiles_x, color, final_t, n_contrib);
  return (int)cudaGetLastError();
}
