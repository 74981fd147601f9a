// Exp-chain throughput probe, float32 against bf16, for Hopper (sm_90a):
// the X2b kernel.
//
// Replaces the TPU kernel inside tools/exp_vpu_dtype.py::run_exp (its
// inline `kernel`, launched there by pl.pallas_call). Per element x, in the
// element type (float, or bf16 taken two elements at a time), with
// c = 0.01 and r = 1.01 rounded to that type:
//   a = x;  acc = a;
//   repeat `steps` times:  acc = acc + exp(-a) c;  a = a r;
//   out = acc.
// exp is the full-precision expf of the element's float value, rounded to
// bf16 in the bf16 form (the blend's transcendental is an f32 expf in every
// blend kernel of this port; h2exp's approximation is left for later work).
//
// What bounds it on this card: the exp. expf is a range reduction, the
// special-function unit's ex2 and a few corrections per element; the three
// other operations of a step are plain arithmetic. Each thread keeps its
// element (or pair) in registers through the chain, one load and one store
// per element; the step count is a run-time argument and every step feeds
// the output. Products and sums are rounded on their own (__fmul_rn,
// __fadd_rn; __hmul2_rn, __hadd2_rn for bf16 pairs) in the order of the
// plain version (photo_slam_tpu_torch/tools/exp_vpu_dtype.py::
// exp_chain_plain).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
exp_f32_kernel(const float* __restrict__ x, float* __restrict__ out,
               long long n, int steps) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float c = 0.01f, r = 1.01f;
  float a = x[i];
  float acc = a;
  for (int s = 0; s < steps; ++s) {
    acc = __fadd_rn(acc, __fmul_rn(expf(-a), c));
    a = __fmul_rn(a, r);
  }
  out[i] = acc;
}

__global__ void __launch_bounds__(kThreads)
exp_bf16_kernel(const __nv_bfloat162* __restrict__ x,
                __nv_bfloat162* __restrict__ out, long long n2, int steps) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n2) return;
  const __nv_bfloat162 c = __float2bfloat162_rn(0.01f);
  const __nv_bfloat162 r = __float2bfloat162_rn(1.01f);
  __nv_bfloat162 a = x[i];
  __nv_bfloat162 acc = a;
  for (int s = 0; s < steps; ++s) {
    const float2 af = __bfloat1622float2(a);
    const __nv_bfloat162 e = __floats2bfloat162_rn(expf(-af.x), expf(-af.y));
    acc = __hadd2_rn(acc, __hmul2_rn(e, c));
    a = __hmul2_rn(a, r);
  }
  out[i] = acc;
}

}  // namespace

// x and out: n contiguous elements on the device, float32 (bf16 == 0) or
// bf16 (bf16 == 1; n even, 4-byte aligned). Returns the launch's
// cudaError_t.
extern "C" int vpu_dtype_exp_launch(const void* x, void* out, long long n,
                                    int steps, int bf16, void* stream) {
  const long long items = bf16 ? n / 2 : n;
  if (items <= 0) return (int)cudaSuccess;
  const long long blocks = (items + kThreads - 1) / kThreads;
  if (bf16)
    exp_bf16_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat162*)x, (__nv_bfloat162*)out, items, steps);
  else
    exp_f32_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)x, (float*)out, items, steps);
  return (int)cudaGetLastError();
}
