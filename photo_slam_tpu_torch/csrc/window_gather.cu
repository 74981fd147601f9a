// Per-tile window gather for Hopper (sm_90a).
//
// Replaces the TPU kernel photo_slam_tpu/ops/binning.py::_window_gather_pallas:
//   out[t, j] = sorted_entries[min(starts[t] + j, E - 1)],  j < K,
// the [T, K] table of each tile's contiguous window of the depth-sorted
// entry stream. The index is clamped to E - 1 like the XLA twin
// (_window_gather_xla), so every element, not only the in-range ones,
// matches it and the plain version (ops/binning.py::window_gather_plain).
//
// What bounds it on this card: device-memory bandwidth, 8 bytes moved per
// output element (one read, one write) and nothing to compute. The TPU
// kernel needed aligned DMAs plus a funnel shift because its DMA offsets had
// to be 1024-aligned; here a warp reads 32 consecutive int32 words at any
// offset, which the L1/L2 sector logic serves in at most two extra
// transactions, so a plain grid-stride copy per tile is already coalesced.
// One block row per tile (gridDim.y), with the window split over gridDim.x
// blocks so a 1024-wide window still spreads over several SMs.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
window_gather_kernel(const int* __restrict__ sorted_entries, long long e_total,
                     const int* __restrict__ starts, int k,
                     int* __restrict__ out) {
  const int t = blockIdx.y;
  const long long start = starts[t];
  int* row = out + (size_t)t * k;
  for (int j = blockIdx.x * kThreads + threadIdx.x; j < k;
       j += gridDim.x * kThreads) {
    long long idx = start + j;
    idx = idx < 0 ? 0 : (idx > e_total - 1 ? e_total - 1 : idx);
    row[j] = sorted_entries[idx];
  }
}

}  // namespace

// sorted_entries [E] i32 (E >= 1), starts [T] i32, out [T, K] i32; all
// contiguous on the device. Returns the launch's cudaError_t.
extern "C" int window_gather_launch(const int* sorted_entries,
                                    long long e_total, const int* starts,
                                    int num_tiles, int k, int* out,
                                    void* stream) {
  if (num_tiles <= 0 || k <= 0) return (int)cudaSuccess;
  const int x_blocks = (k + kThreads - 1) / kThreads;
  dim3 grid(x_blocks < 4 ? x_blocks : 4, num_tiles);
  window_gather_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      sorted_entries, e_total, starts, k, out);
  return (int)cudaGetLastError();
}
