// Semi-global matching path aggregation for Hopper (sm_90a).
//
// Not a TPU kernel: it takes the place of OpenCV's StereoSGBM
// (cv2.StereoSGBM_create(0, 128, 5), MODE_SGBM, in the JAX package's
// photo_slam_tpu/mapper/mapper.py:342), whose machine lacks OpenCV. The
// function, from the int16 cost volume C [H, W1, 128] (ops/stereo.py::
// cost_volume) to the int32 sum S [H, W1, 128] of five path costs:
//   L_r(p, d) = C(p, d) + min(L_r(p - r, d), L_r(p - r, d +- 1) + P1,
//                             min_k L_r(p - r, k) + P2) - min_k L_r(p - r, k)
// with P1 = 2, P2 = 5, L_r = 0 before a path enters the image and MAX_COST
// beyond d = -1 and d = 128, over r = left to right, right to left, top to
// bottom and the diagonals from the top left and the top right (OpenCV's
// single-pass set). Integer arithmetic, so it equals its plain version
// (ops/stereo.py::sgm_aggregate_plain) and OpenCV bit for bit.
//
// What bounds it on this card: the bytes. Each path step is ~10 integer
// operations per disparity, 5 steps per element, ~1.9 G operations on
// EuRoC's 752x480 (H 480, W1 624, 38.3 M elements), against a volume read
// once (int16, 76.7 MB) and a sum written once (int32, 153 MB): 0.069 ms
// at 3.35 TB/s, the operations 0.029 ms at 67 T/s. The recurrence is
// serial along a path and needs the minimum over all 128 disparities of
// the step before, so this first design is simple:
//   * one block of 128 threads per path line (a row, a column or a
//     diagonal), one thread per disparity, 4H + 3W1 - 2 blocks;
//   * the step before sits in shared memory for the d +- 1 neighbours,
//     its minimum comes from warp shuffles and four per-warp minima:
//     two barriers per step;
//   * each thread loads its next cost a step ahead, and adds its path cost
//     into S with an integer atomic (five paths meet in each element; the
//     sum does not depend on their order).
// No tensor cores, TMA or wgmma: a few-step-long dependency chain per
// element, not a matrix product.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;  // disparities: one thread each
constexpr int kP1 = 2;
constexpr int kP2 = 5;
constexpr int kMaxCost = 32767;

__global__ void __launch_bounds__(kD)
sgm_aggregate_kernel(const int16_t* __restrict__ cost, int h, int w1,
                     int* __restrict__ sum) {
  __shared__ int prev[kD + 2];
  __shared__ int warp_min[kD / 32];
  const int d = threadIdx.x, lane = d & 31, warp = d >> 5;
  // The block's path: its direction, first element and length.
  int b = blockIdx.x, x, y, sx, sy, len;
  if (b < h) {  // left to right
    x = 0; y = b; sx = 1; sy = 0; len = w1;
  } else if ((b -= h) < h) {  // right to left
    x = w1 - 1; y = b; sx = -1; sy = 0; len = w1;
  } else if ((b -= h) < w1) {  // top to bottom
    x = b; y = 0; sx = 0; sy = 1; len = h;
  } else if ((b -= w1) < w1 + h - 1) {  // from the top left
    if (b < w1) { x = b; y = 0; } else { x = 0; y = b - w1 + 1; }
    sx = 1; sy = 1; len = min(w1 - x, h - y);
  } else {  // from the top right
    b -= w1 + h - 1;
    if (b < w1) { x = b; y = 0; } else { x = w1 - 1; y = b - w1 + 1; }
    sx = -1; sy = 1; len = min(x + 1, h - y);
  }
  if (d == 0) {
    prev[0] = kMaxCost;
    prev[kD + 1] = kMaxCost;
  }
  const long long step = ((long long)sy * w1 + sx) * kD;
  long long idx = ((long long)y * w1 + x) * kD + d;
  int lp = 0, minp = 0;
  int c = cost[idx];
  for (int s = 0; s < len; ++s) {
    const int c_next = s + 1 < len ? cost[idx + step] : 0;
    prev[d + 1] = lp;
    __syncthreads();
    const int delta = kP2 + minp;
    const int l = c + min(min(lp, prev[d] + kP1),
                          min(prev[d + 2] + kP1, delta)) - delta;
    int m = l;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = min(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (lane == 0) warp_min[warp] = m;
    atomicAdd(sum + idx, l);
    __syncthreads();
    minp = min(min(warp_min[0], warp_min[1]), min(warp_min[2], warp_min[3]));
    lp = l;
    c = c_next;
    idx += step;
  }
}

}  // namespace

// cost [H, W1, 128] i16 and sum [H, W1, 128] i32 (zeroed by the caller),
// both contiguous on the device. Returns the launch's cudaError_t.
extern "C" int sgm_launch(const int16_t* cost, int h, int w1, int* sum,
                          void* stream) {
  if (h <= 0 || w1 <= 0) return (int)cudaSuccess;
  const int blocks = 4 * h + 3 * w1 - 2;
  sgm_aggregate_kernel<<<blocks, kD, 0, (cudaStream_t)stream>>>(cost, h, w1,
                                                                 sum);
  return (int)cudaGetLastError();
}
