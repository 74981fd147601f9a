// Per-tile window gather for Hopper (sm_90a).
//
// Replaces the TPU kernel photo_slam_tpu/ops/binning.py::_window_gather_pallas:
//   out[t, j] = sorted_entries[clamp(starts[t] + j, 0, E - 1)],  j < K,
// the [T, K] table of each tile's contiguous window of the depth-sorted
// entry stream, and with `counts` [T] also the callers' mask:
//   out[t, j] = -1 where j >= counts[t].
// The index is clamped like the XLA twin (_window_gather_xla), so every
// element, not only the in-range ones, matches it and the plain version
// (ops/binning.py::window_gather_plain).
//
// What bounds it on this card: device-memory bandwidth and nothing to
// compute: a 4-byte write of the table per output element, and a 4-byte
// read of the stream per element below its tile's count (all of them
// without `counts`). On the masked pass-1 windows ([836, 1024], 446,476
// words below the counts) that is 5.2 MB, 1.56 us at 3.35 TB/s. The
// earlier design was a grid-stride copy of one int32
// per thread over a (4, T) grid, behind a wrapper whose host work (checks,
// a device guard, a stream object) took longer than the copy. This design:
//   * one block per tile; each thread writes 4 consecutive outputs with one
//     16-byte store (K % 4 == 0 on every path; a scalar loop otherwise);
//   * the loads stay scalar: starts[t] has any alignment, so a 16-byte load
//     would need a funnel of two. Four scalar loads of consecutive words by
//     each thread touch the same 128-byte lines as the warp's neighbours, so
//     L1 serves three of the four and each stream word still crosses L2 once;
//   * the mask is one compare per element (j < count) and a masked element
//     loads nothing; the clamp is one integer clamp per element, on an offset
//     that the tile first clamps to [-K, E] so that it fits 32 bits;
//   * the callers' mask (arange, compare, where: three launches) moves in.
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W: 2.33-2.37
// us per launch on the device (a torch.profiler trace) on those windows,
// 1.5x the bound; the library gather sorted_entries[idx] (unmasked) 6.0 us.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;

__device__ __forceinline__ int load_or_pad(const int* __restrict__ se, int s,
                                           int last, int j, int count) {
  return j < count ? __ldg(se + min(max(s + j, 0), last)) : -1;
}

__global__ void __launch_bounds__(kMaxThreads)
window_gather_kernel(const int* __restrict__ sorted_entries, int e_total,
                     const int* __restrict__ starts,
                     const int* __restrict__ counts, int k,
                     int* __restrict__ out) {
  const int t = blockIdx.x;
  // clamp(start + j, 0, E-1) == clamp(clamp(start, -K, E) + j, 0, E-1) for
  // 0 <= j < K, and the inner clamp keeps start + j inside int32.
  const int s = (int)min(max((long long)starts[t], (long long)-k),
                         (long long)e_total);
  const int last = e_total - 1;
  const int count = counts == nullptr ? k : counts[t];
  int* row = out + (size_t)t * k;
  if ((k & 3) == 0) {
    for (int j = 4 * threadIdx.x; j < k; j += 4 * blockDim.x) {
      int4 v;
      v.x = load_or_pad(sorted_entries, s, last, j, count);
      v.y = load_or_pad(sorted_entries, s, last, j + 1, count);
      v.z = load_or_pad(sorted_entries, s, last, j + 2, count);
      v.w = load_or_pad(sorted_entries, s, last, j + 3, count);
      *reinterpret_cast<int4*>(row + j) = v;
    }
  } else {
    for (int j = threadIdx.x; j < k; j += blockDim.x)
      row[j] = load_or_pad(sorted_entries, s, last, j, count);
  }
}

}  // namespace

// sorted_entries [E] i32 (1 <= E, E + K < 2^31), starts [T] i32, counts [T]
// i32 or null (no mask), out [T, K] i32 (16-byte aligned); all contiguous on
// the device. Returns the launch's cudaError_t.
extern "C" int window_gather_launch(const int* sorted_entries, int e_total,
                                    const int* starts, const int* counts,
                                    int num_tiles, int k, int* out,
                                    void* stream) {
  if (num_tiles <= 0 || k <= 0) return (int)cudaSuccess;
  // Enough threads for one 16-byte store each, in whole warps.
  const int per_thread = (k & 3) == 0 ? 4 : 1;
  const int want = ((k / per_thread + 31) / 32) * 32;
  const int threads = want < kMaxThreads ? want : kMaxThreads;
  window_gather_kernel<<<num_tiles, threads, 0, (cudaStream_t)stream>>>(
      sorted_entries, e_total, starts, counts, k, out);
  return (int)cudaGetLastError();
}
