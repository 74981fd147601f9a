// Deterministic entry -> Gaussian sum for Hopper (sm_90a).
//
// Not a TPU kernel: it takes the place of the f32 index_add_ that summed the
// blend backward's [T, K, 16] gradient rows into their Gaussians
// (ops/tiled.py::entry_gather_transpose). On the card index_add_ sums with
// atomics, in a new order on every run, so two train steps from one state
// differed in their last bits. The JAX package routes the same rows through
// sorts (photo_slam_tpu/ops/tiled.py::_entry_gather_bwd), which sum in one
// order on every run; this kernel gives the port the same property.
//
// Contract: the table positions p of the rows g [P, D] are sorted by
// Gaussian with a stable sort (ops/tiled.py::entry_order, plain torch), so
// `order` [M] holds the positions of Gaussian i at order[bounds[i] ..
// bounds[i + 1]) in table order. Then
//   out[i, l] = sum over q in [bounds[i], bounds[i + 1]) of g[order[q], l]
// for l < 9 (the lanes that carry gradient), taken in that order from 0.0f
// with plain adds, and out[i, l] = 0 for 9 <= l < D. The plain version
// (ops/tiled.py::entry_sum_plain) adds in the same order, so the two are
// bit-equal, and the sum is the same on every run: no atomics.
//
// What bounds it on this card: device-memory bandwidth. Each valid row is
// read once (its 9 lanes lie in two 32-byte sectors of the 64-byte row),
// each sorted position and bound once, and the [n, D] output is written
// once; at the train step's shapes ([836, 1024, 16] rows, 300,000
// Gaussians) that is ~50 MB, ~0.015 ms at 3.35 TB/s. The design:
//   * one thread per (Gaussian, lane): D = 16 threads a Gaussian, two
//     Gaussians a warp. A Gaussian's threads read the same position (a
//     broadcast) and then 9 consecutive floats of one row, so a warp's loads
//     touch two rows' sectors and nothing else;
//   * a segment holds at most k_dup positions when the ids of a table are
//     unique (the main path), so a thread's loop is short and the threads
//     of a warp end together;
//   * the lanes 9-15 threads write the zeros themselves: no memset, no pad.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGradLanes = 9;  // ops/tiled.py GRAD_LANES

__global__ void __launch_bounds__(kThreads)
entry_sum_kernel(const float* __restrict__ g, const int* __restrict__ order,
                 const int* __restrict__ bounds, int n, int d,
                 float* __restrict__ out) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (long long)n * d) return;
  const int i = (int)(t / d);
  const int l = (int)(t - (long long)i * d);
  float acc = 0.0f;
  if (l < kGradLanes) {
    const int end = __ldg(bounds + i + 1);
    for (int q = __ldg(bounds + i); q < end; ++q)
      acc = __fadd_rn(acc, __ldg(g + (size_t)__ldg(order + q) * d + l));
  }
  out[t] = acc;
}

}  // namespace

// g [P, D] f32 rows, order [M] i32 table positions sorted by Gaussian,
// bounds [n + 1] i32 segment bounds into order, out [n, D] f32; all
// contiguous on the device, D >= 9 and n * D < 2^62. Returns the launch's
// cudaError_t.
extern "C" int entry_sum_launch(const float* g, const int* order,
                                const int* bounds, int n, int d, float* out,
                                void* stream) {
  if (n <= 0 || d <= 0) return (int)cudaSuccess;
  const long long threads = (long long)n * d;
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  entry_sum_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      g, order, bounds, n, d, out);
  return (int)cudaGetLastError();
}
