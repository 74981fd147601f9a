// Elementwise-chain throughput probe, float32 against bf16, for Hopper
// (sm_90a): the X2a kernel.
//
// Replaces the TPU kernel tools/exp_vpu_dtype.py::make_kernel (launched by
// run). Per element x, in the element type (float, or bf16 taken two
// elements at a time as __nv_bfloat162), with one = 1.000001 and half = 0.5
// rounded to that type:
//   a = x;  b = a half + one;
//   repeat `inner` times:  a = a b + one;  b = max(b half, a - b);
//   out = a + b.
// max propagates a NaN (max.NaN.f32, __hmax2_nan), as the plain version's
// torch.maximum does. The
// chain overflows after a few iterations (a reaches inf, then a - b is
// NaN), so at the experiment's 256 iterations only the time means anything.
//
// What bounds it on this card: the arithmetic pipe, by design. Each thread
// keeps its element (or element pair) in registers through the whole chain:
// one load and one store per element against 5 dependent operations per
// iteration (the experiment counts 4). The loop count is a run-time
// argument and every iteration feeds the output, so the compiler can drop
// none of it. The probe measures the instruction path the blend kernels use:
// each float operation is rounded on its own (__fmul_rn, __fadd_rn,
// __fsub_rn never contract into FMAs), and each bf16 pair operation is the
// explicitly rounded packed intrinsic (__hmul2_rn, __hadd2_rn, __hsub2_rn,
// __hmax2_nan), so the kernel and the plain version
// (photo_slam_tpu_torch/tools/exp_vpu_dtype.py::chain_plain) agree bit for
// bit. The bf16 form issues half as many instructions per element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// One instruction, as __hmax2_nan is for a bf16 pair (a compare and a
// select would cost the f32 chain two more per iteration).
__device__ __forceinline__ float max_nan(float x, float y) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(x), "f"(y));
  return r;
}

__global__ void __launch_bounds__(kThreads)
chain_f32_kernel(const float* __restrict__ x, float* __restrict__ out,
                 long long n, int inner) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float one = 1.000001f, half = 0.5f;
  float a = x[i];
  float b = __fadd_rn(__fmul_rn(a, half), one);
  for (int it = 0; it < inner; ++it) {
    a = __fadd_rn(__fmul_rn(a, b), one);
    b = max_nan(__fmul_rn(b, half), __fsub_rn(a, b));
  }
  out[i] = __fadd_rn(a, b);
}

__global__ void __launch_bounds__(kThreads)
chain_bf16_kernel(const __nv_bfloat162* __restrict__ x,
                  __nv_bfloat162* __restrict__ out, long long n2, int inner) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n2) return;
  const __nv_bfloat162 one = __float2bfloat162_rn(1.000001f);
  const __nv_bfloat162 half = __float2bfloat162_rn(0.5f);
  __nv_bfloat162 a = x[i];
  __nv_bfloat162 b = __hadd2_rn(__hmul2_rn(a, half), one);
  for (int it = 0; it < inner; ++it) {
    a = __hadd2_rn(__hmul2_rn(a, b), one);
    b = __hmax2_nan(__hmul2_rn(b, half), __hsub2_rn(a, b));
  }
  out[i] = __hadd2_rn(a, b);
}

}  // namespace

// x and out: n contiguous elements on the device, float32 (bf16 == 0) or
// bf16 (bf16 == 1; n even, 4-byte aligned). Returns the launch's
// cudaError_t.
extern "C" int vpu_dtype_launch(const void* x, void* out, long long n,
                                int inner, int bf16, void* stream) {
  const long long items = bf16 ? n / 2 : n;
  if (items <= 0) return (int)cudaSuccess;
  const long long blocks = (items + kThreads - 1) / kThreads;
  if (bf16)
    chain_bf16_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat162*)x, (__nv_bfloat162*)out, items, inner);
  else
    chain_f32_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)x, (float*)out, items, inner);
  return (int)cudaGetLastError();
}
