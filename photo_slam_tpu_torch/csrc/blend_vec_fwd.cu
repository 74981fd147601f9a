// Group-vectorized tile blend forward for Hopper (sm_90a): the X3 forward.
//
// Replaces the TPU kernel tools/exp_blend_vec.py::_fwd_kernel_vec (launched
// by blend_vec). It is K1's function (csrc/blend_fwd.cu) on 32x32 tiles with
// identity tile ids (block b rasterizes image tile b), taken in groups of
// G = 64 entries with another rounding. Per group and pixel, over the
// group's entries k < count in order:
//   contrib_k = alive & power <= 0 & alpha >= 1/255,
//   om_k = 1 - alpha_k where contrib_k, else 1,
//   S_k = T * prod_{j <= k} om_j   (T = the pixel's transmittance before
//                                   the group),
//   ok_k = contrib_k & S_k >= 1e-4,  weight_k = alpha_k (S_k / om_k),
// colour += sum_k rgb_k weight_k, n_contrib = the last ok k + 1,
// T *= the product of the ok om_k; a pixel with a contributing entry whose
// S_k < 1e-4 dies, at the end of the group. The block stops before a group
// once every pixel has died.
//
// What bounds it on this card: arithmetic, as K1 (an exp, a division and
// ~20 rounded products and sums per entry-pixel pair). The TPU kernel built
// S with a log2(G) roll-ladder prefix product over [G, 1024] arrays and the
// colour sum as an MXU matmul, to avoid per-entry scalar work on a machine
// without scalar threads; here each thread walks the group for its 4 pixels
// with a running product, as K1 does, and keeps the group's colour sum
// apart until the group ends:
//   * 256 threads per tile, 4 pixels each (pixel p = threadIdx.x + 256 j);
//   * each group's 64 rows are staged through shared memory, one per
//     thread, and read back as broadcasts; rows >= count are never read;
//   * S only falls within a group, so a pixel leaves the group at its first
//     contributing entry with S_k < 1e-4 (no later entry can be ok), and
//     dies at the group's end.
// Every product, sum and the division are rounded on their own (__fmul_rn,
// __fadd_rn, __fdiv_rn) in the order of the plain version
// (photo_slam_tpu_torch/tools/exp_blend_vec.py::blend_vec_plain); expf is
// the full-precision exp.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kPixels = kTile * kTile;  // 1024
constexpr int kThreads = 256;
constexpr int kPerThread = kPixels / kThreads;  // 4
constexpr int kFeat = 16;
constexpr int kGroup = 64;

__global__ void __launch_bounds__(kThreads)
blend_vec_fwd_kernel(const float* __restrict__ data,
                     const int* __restrict__ counts, int k_max, int tiles_x,
                     float* __restrict__ color, float* __restrict__ final_t,
                     int* __restrict__ n_contrib) {
  const float kAlphaMax = 0.99f;
  const float kAlphaMin = (float)(1.0 / 255.0);
  const float kTEps = 1e-4f;

  __shared__ float2 s_xy[kGroup];
  __shared__ float4 s_conic_o[kGroup];  // a, b, c, opacity
  __shared__ float s_rgb[3][kGroup];

  const int blk = blockIdx.x;
  const int tid = threadIdx.x;
  const int count = min(max(counts[blk], 0), k_max);
  const float ox = (float)((blk % tiles_x) * kTile);
  const float oy = (float)((blk / tiles_x) * kTile);
  const float* rows = data + (size_t)blk * k_max * kFeat;

  float px[kPerThread], py[kPerThread];
  float T[kPerThread], cr[kPerThread], cg[kPerThread], cb[kPerThread];
  int last[kPerThread];
  bool alive[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int p = tid + kThreads * j;
    px[j] = ox + (float)(p % kTile);
    py[j] = oy + (float)(p / kTile);
    T[j] = 1.0f;
    cr[j] = cg[j] = cb[j] = 0.0f;
    last[j] = 0;
    alive[j] = true;
  }

  for (int base = 0; base < count; base += kGroup) {
    bool mine_dead = true;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) mine_dead = mine_dead && !alive[j];
    if (__syncthreads_count(mine_dead) == kThreads) break;

    const int n = min(kGroup, count - base);
    if (tid < n) {
      const float* row = rows + (size_t)(base + tid) * kFeat;
      const float4 r0 = reinterpret_cast<const float4*>(row)[0];  // x, y, a, b
      const float4 r1 = reinterpret_cast<const float4*>(row)[1];  // c, o, r, g
      s_xy[tid] = make_float2(r0.x, r0.y);
      s_conic_o[tid] = make_float4(r0.z, r0.w, r1.x, r1.y);
      s_rgb[0][tid] = r1.z;
      s_rgb[1][tid] = r1.w;
      s_rgb[2][tid] = row[8];
    }
    __syncthreads();

    // Group state per pixel: running product s, product of the applied om,
    // the group's colour sums, and whether the pixel leaves the group.
    float s[kPerThread], applied[kPerThread];
    float sr[kPerThread], sg[kPerThread], sb[kPerThread];
    bool out[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      s[j] = applied[j] = 1.0f;
      sr[j] = sg[j] = sb[j] = 0.0f;
      out[j] = !alive[j];
    }
    for (int i = 0; i < n; ++i) {
      const float2 xy = s_xy[i];
      const float4 co = s_conic_o[i];
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        if (out[j]) continue;
        const float dx = __fsub_rn(xy.x, px[j]);
        const float dy = __fsub_rn(xy.y, py[j]);
        const float quad = __fadd_rn(__fmul_rn(__fmul_rn(co.x, dx), dx),
                                     __fmul_rn(__fmul_rn(co.z, dy), dy));
        const float power = __fsub_rn(__fmul_rn(-0.5f, quad),
                                      __fmul_rn(__fmul_rn(co.y, dx), dy));
        if (power > 0.0f) continue;
        float alpha = __fmul_rn(co.w, expf(power));
        alpha = alpha > kAlphaMax ? kAlphaMax : alpha;
        if (!(alpha >= kAlphaMin)) continue;
        const float om = __fsub_rn(1.0f, alpha);
        s[j] = __fmul_rn(s[j], om);
        const float S = __fmul_rn(T[j], s[j]);
        if (!(S >= kTEps)) {
          out[j] = true;
          alive[j] = false;
          continue;
        }
        const float w = __fmul_rn(alpha, __fdiv_rn(S, om));
        sr[j] = __fadd_rn(sr[j], __fmul_rn(s_rgb[0][i], w));
        sg[j] = __fadd_rn(sg[j], __fmul_rn(s_rgb[1][i], w));
        sb[j] = __fadd_rn(sb[j], __fmul_rn(s_rgb[2][i], w));
        applied[j] = __fmul_rn(applied[j], om);
        last[j] = base + i + 1;
      }
    }
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      cr[j] = __fadd_rn(cr[j], sr[j]);
      cg[j] = __fadd_rn(cg[j], sg[j]);
      cb[j] = __fadd_rn(cb[j], sb[j]);
      T[j] = __fmul_rn(T[j], applied[j]);
    }
    // The next group's staging overwrites what this one read.
    __syncthreads();
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

// data [B, K, 16] f32 (16-byte aligned), counts [B] i32 (both contiguous,
// on the device); color [B, 3, 1024] f32, final_t [B, 1024] f32 and
// n_contrib [B, 1024] i32 are written in full. Returns the launch's
// cudaError_t.
extern "C" int blend_vec_fwd_launch(const float* data, const int* counts,
                                    int num_tiles, int k_max, int tiles_x,
                                    float* color, float* final_t,
                                    int* n_contrib, void* stream) {
  if (num_tiles <= 0) return (int)cudaSuccess;
  blend_vec_fwd_kernel<<<num_tiles, kThreads, 0, (cudaStream_t)stream>>>(
      data, counts, k_max, tiles_x, color, final_t, n_contrib);
  return (int)cudaGetLastError();
}
