// The warp sum of the blend backward kernels K2 (blend_bwd.cu) and X4b
// (blend16_bwd.cu): nine per-lane sums reduced over a warp's 32 lanes by a
// transpose butterfly, 12 shuffles in place of nine 5-step shuffle trees'
// 45, deterministic (a fixed order of adds).
#pragma once

#include <cuda_runtime.h>

constexpr int kButterflySums = 9;

// Lane-dependent half of a pair of sums: what a lane keeps and what it
// sends at one butterfly step.
__device__ __forceinline__ float exchange(float lo_v, float hi_v, bool upper,
                                          int offset) {
  const float keep = upper ? hi_v : lo_v;
  const float send = upper ? lo_v : hi_v;
  return keep + __shfl_xor_sync(0xffffffffu, send, offset);
}

// Sums v[0..8] over the warp's 32 lanes with a transpose butterfly: lanes
// 16 apart split the nine sums 5 / 4 (plus a zero), then 3 / 2, 2 / 1,
// 1 / 1, and the last step adds both halves of a lane pair. Sum q ends in
// lanes 2 c and 2 c + 1 with c = 8 b4 + 4 b3 + 2 b2 + b1, q = 5 b4 + 3 b3 +
// 2 b2 + b1 (butterfly9_sum gives each lane its q, or -1). Returns this
// lane's total.
__device__ __forceinline__ float butterfly9(
    const float (&v)[kButterflySums], int lane) {
  float w[5];
#pragma unroll
  for (int i = 0; i < 5; ++i)
    w[i] = exchange(v[i], i + 5 < kButterflySums ? v[i + 5] : 0.0f,
                    lane & 16, 16);
  float x[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    x[i] = exchange(w[i], i + 3 < 5 ? w[i + 3] : 0.0f, lane & 8, 8);
  float y[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    y[i] = exchange(x[i], i + 2 < 3 ? x[i + 2] : 0.0f, lane & 4, 4);
  float z = exchange(y[0], y[1], lane & 2, 2);
  return z + __shfl_xor_sync(0xffffffffu, z, 1);
}

// Which of the nine sums butterfly9 leaves in this lane for it to store, or
// -1 (odd lanes, and the slots that held the zeros).
__device__ __forceinline__ int butterfly9_sum(int lane) {
  const int b4 = (lane >> 4) & 1, b3 = (lane >> 3) & 1;
  const int b2 = (lane >> 2) & 1, b1 = (lane >> 1) & 1;
  const bool holds = !(lane & 1) && b1 < 2 - b2 && 2 * b2 + b1 < 3 - b3 &&
                     3 * b3 + 2 * b2 + b1 < 5 - b4;
  return holds ? 5 * b4 + 3 * b3 + 2 * b2 + b1 : -1;
}
