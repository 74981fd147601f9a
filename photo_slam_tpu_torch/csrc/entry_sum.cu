// Deterministic entry -> Gaussian sum for Hopper (sm_90a): the whole entry
// transpose in pointer form.
//
// Not a TPU kernel: it takes the place of the f32 index_add_ that summed the
// blend backward's [T, K, 16] gradient rows into their Gaussians
// (ops/tiled.py::entry_gather_transpose). On the card index_add_ sums with
// atomics, in a new order on every run, so two train steps from one state
// differed in their last bits. The JAX package routes the same rows back to
// entry order by a pointer ptr[e] = table position of entry id e and then
// reduces each Gaussian's k_dup slots (photo_slam_tpu/ops/tiled.py::
// _entry_gather_bwd, fallback_route); this kernel builds the same pointer on
// the card and sums in one order on every run.
//
// Contract: lists [P] holds the table's entry ids (gaussian * k_dup + slot,
// -1 invalid), each valid id at most once and below n * k_dup, and g [P, D]
// the gradient rows in table order. With ptr [n * k_dup] the table position
// of each entry id (-1 where the table holds none),
//   out[i, l] = sum over j = 0 .. k_dup-1 with ptr[i k_dup + j] >= 0 of
//               g[ptr[i k_dup + j], l]
// for l < 9 (the lanes that carry gradient), taken in slot order from 0.0f
// with plain adds, and out[i, l] = 0 for 9 <= l < D. The plain version
// (ops/tiled.py::entry_sum_plain) adds in the same order, so the two are
// bit-equal, and the sum is the same on every run. For a table in tile order
// (the pass-1 table, the full-route continuation windows) slot order is
// table order: slot j of a Gaussian lies at a tile id that rises with j
// (ops/binning.py), so the sums equal a table-order segmented sum bit for
// bit.
//
// One launcher issues three steps on the stream:
//   (a) ptr filled with -1 (cudaMemsetAsync 0xFF);
//   (b) entry_scatter_kernel, one thread per table slot: ptr[id] = p by an
//       atomicCAS from -1, so that a repeated id is seen; a repeated or
//       out-of-range id adds one to the device counter `repeats` (the
//       wrapper's, never read back by it) and writes nothing;
//   (c) entry_sum_kernel, 4 threads per Gaussian, thread q owning lanes
//       4q .. 4q+3, so a warp covers 8 Gaussians and stores 512 contiguous
//       bytes as float4s. A thread reads its Gaussian's pointers in chunks
//       of 8 (int2 pairs for an even k_dup; all loads of a chunk issued
//       together), then issues every row load of the chunk as a float4
//       (lanes 0-8 lie in the row's first two 32-byte sectors; thread 2
//       keeps only lane 8) before its first add. Thread 3 loads nothing and
//       writes lanes 12-15 as zeros.
//
// What bounds it on this card: device-memory bandwidth. The function needs
// the table's ids (836 x 1024 x 4 B at the train step's shapes), each valid
// row's two sectors (446,476 x 64 B) and the [300000, 16] output (19.2 MB):
// ~51 MB, ~0.015 ms at 3.35 TB/s. The design adds the pointer: 4 n k_dup
// bytes filled and read back, and one 4-byte atomic a valid row.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGradLanes = 9;  // ops/tiled.py GRAD_LANES
constexpr int kChunk = 8;      // slots whose loads are in flight together

__global__ void __launch_bounds__(kThreads)
entry_scatter_kernel(const int* __restrict__ lists, long long p_total,
                     long long m, int* __restrict__ ptr,
                     int* __restrict__ repeats) {
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= p_total) return;
  const int id = __ldg(lists + p);
  if (id < 0) return;
  if (id >= m || atomicCAS(ptr + id, -1, (int)p) != -1) atomicAdd(repeats, 1);
}

__global__ void __launch_bounds__(kThreads)
entry_sum_kernel(const float* __restrict__ g, const int* __restrict__ ptr,
                 int n, int k_dup, int d, float* __restrict__ out) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long i = t >> 2;  // Gaussian
  const int q = (int)(t & 3);  // lanes 4q .. 4q+3
  if (i >= n) return;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (4 * q < kGradLanes) {
    const int* p = ptr + i * k_dup;
    for (int j0 = 0; j0 < k_dup; j0 += kChunk) {
      int pos[kChunk];
      if ((k_dup & 1) == 0) {
        // An even k_dup keeps every pair of pointers 8-byte aligned.
#pragma unroll
        for (int j = 0; j < kChunk; j += 2) {
          const int2 v = j0 + j < k_dup
              ? __ldg(reinterpret_cast<const int2*>(p + j0 + j))
              : make_int2(-1, -1);
          pos[j] = v.x;
          pos[j + 1] = v.y;
        }
      } else {
#pragma unroll
        for (int j = 0; j < kChunk; ++j)
          pos[j] = j0 + j < k_dup ? __ldg(p + j0 + j) : -1;
      }
      float4 row[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        row[j] = pos[j] >= 0
            ? __ldg(reinterpret_cast<const float4*>(g + (size_t)pos[j] * d)
                    + q)
            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      // Slot order, plain round-to-nearest adds (no contraction).
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (pos[j] < 0) continue;
        acc.x = __fadd_rn(acc.x, row[j].x);
        acc.y = __fadd_rn(acc.y, row[j].y);
        acc.z = __fadd_rn(acc.z, row[j].z);
        acc.w = __fadd_rn(acc.w, row[j].w);
      }
    }
    if (4 * q + 1 >= kGradLanes) acc.y = 0.0f;
    if (4 * q + 2 >= kGradLanes) acc.z = 0.0f;
    if (4 * q + 3 >= kGradLanes) acc.w = 0.0f;
  }
  float4* o = reinterpret_cast<float4*>(out + i * d);
  o[q] = acc;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int c = q + 4; c < d / 4; c += 4) o[c] = zero;
}

}  // namespace

// g [P, D] f32 rows, lists [P] i32 entry ids, ptr [n * k_dup] i32 scratch,
// repeats [1] i32 counter, out [n, D] f32; all contiguous on the device, g
// and out 16-byte aligned, D a multiple of 4 and >= 12, P and n * k_dup
// below 2^31. Returns the first cudaError_t of the three steps.
extern "C" int entry_sum_launch(const float* g, const int* lists,
                                long long p_total, int n, int k_dup, int d,
                                int* ptr, int* repeats, float* out,
                                void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const long long m = (long long)n * k_dup;
  cudaError_t err = cudaMemsetAsync(ptr, 0xFF, (size_t)m * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  if (p_total > 0) {
    entry_scatter_kernel<<<(unsigned)((p_total + kThreads - 1) / kThreads),
                           kThreads, 0, s>>>(lists, p_total, m, ptr, repeats);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long long threads = 4LL * n;
  entry_sum_kernel<<<(unsigned)((threads + kThreads - 1) / kThreads),
                     kThreads, 0, s>>>(g, ptr, n, k_dup, d, out);
  return (int)cudaGetLastError();
}
