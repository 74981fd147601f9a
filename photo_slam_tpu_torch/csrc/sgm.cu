// Semi-global matching path aggregation for Hopper (sm_90a).
//
// Not a TPU kernel: it takes the place of OpenCV's StereoSGBM
// (cv2.StereoSGBM_create(0, 128, 5), MODE_SGBM, in the JAX package's
// photo_slam_tpu/mapper/mapper.py:342), whose machine lacks OpenCV. The
// function, from the int16 cost volume C [H, W1, 128] (ops/stereo.py::
// cost_volume) to the int16 sum S [H, W1, 128] of five path costs:
//   L_r(p, d) = C(p, d) + min(L_r(p - r, d), L_r(p - r, d +- 1) + P1,
//                             min_k L_r(p - r, k) + P2) - min_k L_r(p - r, k)
// with P1 = 2, P2 = 5, L_r = 0 before a path enters the image and a
// sentinel beyond d = -1 and d = 128, over r = left to right, right to
// left, top to bottom and the diagonals from the top left and the top right
// (OpenCV's single-pass set). OpenCV subtracts minp + P2, so L can be
// negative. Integer arithmetic, so it equals its plain
// version (ops/stereo.py::sgm_aggregate_plain) and OpenCV bit for bit.
//
// Ranges. A cost is at most 25 x (30 + 63) = 2,325 (stereo.py), so
// C - P2 <= L <= C, -25 <= S <= 5 x 2,325 = 11,625: every value fits
// int16, OpenCV's own CostType. The sentinel 16,383 can neither overflow
// (16,383 + P1 < 32,767) nor win (16,385 > 2,330, the largest minp + P2).
//
// What bounds it on this card: the bytes. The function reads the volume
// once and writes the sum once, (2 + 2) B an element, 153.4 MB on EuRoC's
// 752x480 (H 480, W1 624, 38.3 M elements): 0.0458 ms at 3.35 TB/s; its
// ~10 integer operations per path step and element come to 0.029 ms at
// 67 T/s. The recurrence is serial along a path and each step needs the
// minimum over all 128 disparities of the step before. The design:
//   * a warp per path line: lane l holds d = 4l .. 4l + 3 as two packed
//     s16x2 words; the d +- 1 neighbours come by one __shfl_up_sync and
//     one __shfl_down_sync, the candidates from Hopper's DPX min-add
//     (__viaddmin_s16x2) and packed minima, the minimum over d from one
//     __reduce_min_sync: no shared memory and no barrier inside a step;
//   * each warp keeps kRing steps of cost (and of the sum) in flight in a
//     register ring, each slot reloaded right after its last use so that
//     the load lands in the slot's own registers; a step reads 256
//     contiguous bytes;
//   * four launches in stream order, each writing every element of S once
//     with a plain store, so no atomics and no zeroing pass:
//       1. rows: both horizontal paths of a row in one block of two warps.
//          Each walks its first half of the row keeping its L in S itself,
//          one barrier, then each walks the other half adding the other
//          path's L and writing S. A block holds no shared memory, so all
//          480 rows run at once (half rows in 156 KB of shared memory a
//          block, one block per SM and four waves, were slower on EuRoC:
//          PERF.md).
//       2-4. from the top: straight down, then each diagonal; a warp per
//          line loads S, adds its L and stores S.
//   Device-memory bytes of the design, int16 elements n: pass 1 reads C
//   (each row's second read hits L2) and writes S; its half rows add up
//   to 2n more where L2 (50 MB) does not hold them until they are read
//   back; passes 2-4 each read C and S and write S: 11n x 2 B = 843.4 MB on
//   EuRoC (0.2518 ms at 3.35 TB/s), at most 13n x 2 B = 996.8 MB, against
//   the first design's ~2.07 GB (int32 atomics into a zeroed sum).
// No tensor cores, TMA or wgmma: a dependency chain of a few packed
// integer operations per step, not a matrix product.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kP1 = 2;
constexpr int kP2 = 5;
constexpr int kSentinel = 16383;
constexpr int kRing = 16;          // steps of loads in flight per warp
constexpr int kWarpsDown = 2;      // warps (path lines) per block, passes 2-4
constexpr unsigned kFull = 0xffffffffu;

// Packed s16x2 arithmetic in Hopper's DPX instructions alone: min(a + b,
// c) (__viaddmin_s16x2) and the minimum of three (__vimin3_s16x2). With c
// at the int16 maximum the min-add is an add (no sum here comes near it).
constexpr unsigned kBig = 0x7fff7fffu;

__device__ __forceinline__ unsigned add16x2(unsigned a, unsigned b) {
  return __viaddmin_s16x2(a, b, kBig);
}

__device__ __forceinline__ unsigned min16x2(unsigned a, unsigned b) {
  return __vimin3_s16x2(a, b, b);
}

__device__ __forceinline__ unsigned pair16(int v) {
  return (unsigned)(v & 0xffff) * 0x10001u;
}

// The path state of one lane: L at d = 4 lane .. 4 lane + 3 as two s16x2
// words (the lower d in the lower half), and the minimum over all d.
struct Path {
  unsigned l0, l1;
  int minp;
};

// One step of the recurrence on this element's costs (c.x: d = 4 lane,
// 4 lane + 1; c.y: 4 lane + 2, 4 lane + 3); leaves the new L in p. The
// shuffles and the warp's minimum are the step's two latency chains.
__device__ __forceinline__ void path_step(Path& p, uint2 c, int lane) {
  unsigned up = __shfl_up_sync(kFull, p.l1, 1);    // (L[4l - 2], L[4l - 1])
  unsigned dn = __shfl_down_sync(kFull, p.l0, 1);  // (L[4l + 4], L[4l + 5])
  if (lane == 0) up = pair16(kSentinel);
  if (lane == 31) dn = pair16(kSentinel);
  // minp + P2 >= 0 (L >= -P2), and its negation.
  const unsigned delta = (unsigned)(p.minp + kP2) * 0x10001u;
  const unsigned ndelta = pair16(-p.minp - kP2);
  // Independent of the shuffles: min(L[d], minp + P2), C - minp - P2.
  const unsigned own0 = min16x2(p.l0, delta), own1 = min16x2(p.l1, delta);
  const unsigned cm0 = add16x2(c.x, ndelta), cm1 = add16x2(c.y, ndelta);
  const unsigned lo0 = __byte_perm(up, p.l0, 0x5432);    // L[4l-1], L[4l]
  const unsigned mid = __byte_perm(p.l0, p.l1, 0x5432);  // L[4l+1], L[4l+2]
  const unsigned hi1 = __byte_perm(p.l1, dn, 0x5432);    // L[4l+3], L[4l+4]
  const unsigned p1 = pair16(kP1);
  // min(L[d - 1], L[d + 1]) + P1 against min(L[d], minp + P2).
  const unsigned m0 = __viaddmin_s16x2(min16x2(lo0, mid), p1, own0);
  const unsigned m1 = __viaddmin_s16x2(min16x2(mid, hi1), p1, own1);
  p.l0 = add16x2(m0, cm0);
  p.l1 = add16x2(m1, cm1);
  // The lane's minimum of its four (signed) L in both halves, then the
  // warp's.
  unsigned v = min16x2(p.l0, p.l1);
  v = min16x2(v, __byte_perm(v, v, 0x1032));
  p.minp = __reduce_min_sync(kFull, (int)(short)(v & 0xffffu));
}

__device__ __forceinline__ uint2 add2(uint2 a, uint2 b) {
  return make_uint2(add16x2(a.x, b.x), add16x2(a.y, b.y));
}

// Steps [t0, t1) of a row, warp 0 at x = t, warp 1 at x = W1 - 1 - t: keep
// L in S, or (kAdd) add the other path's L kept there and write S.
// Loads past the range re-read its last element into slots that are never
// used: an unconditional load goes straight into its slot's registers (a
// predicated one would be copied in, waiting for it to land).
template <bool kAdd>
__device__ __forceinline__ void walk_row(Path& p, const uint2* c, uint2* s,
                                         int t0, int t1, int w1,
                                         bool rtl, int lane) {
  if (t0 >= t1) return;
  auto at = [&](int t) { return (size_t)(rtl ? w1 - 1 - t : t) * 32; };
  const int last = t1 - 1;
  uint2 cring[kRing], hring[kRing];
#pragma unroll
  for (int k = 0; k < kRing; ++k) {
    cring[k] = __ldg(c + at(min(t0 + k, last)));
    if (kAdd) hring[k] = s[at(min(t0 + k, last))];
  }
  for (int u0 = t0; u0 < t1; u0 += kRing) {
#pragma unroll
    for (int k = 0; k < kRing; ++k) {
      const int t = u0 + k;
      if (t >= t1) break;
      path_step(p, cring[k], lane);
      const uint2 l = make_uint2(p.l0, p.l1);
      s[at(t)] = kAdd ? add2(l, hring[k]) : l;
      // The slot's next load only after its last use: it then lands in the
      // slot's own registers (else in others, copied over once it lands).
      const int tn = min(t + kRing, last);
      cring[k] = __ldg(c + at(tn));
      if (kAdd) hring[k] = s[at(tn)];
    }
  }
}

// Pass 1: block y walks row y, warp 0 left to right, warp 1 right to left.
// Before step W1 / 2 each keeps its L in S; after one barrier each adds the
// other's L and writes S.
// For an odd W1 both reach the middle at step W1 / 2: warp 0 keeps its L,
// warp 1 holds its own in registers and adds after a second barrier.
__global__ void __launch_bounds__(64)
sgm_rows_kernel(const int16_t* __restrict__ cost, int w1,
                int16_t* __restrict__ sum) {
  const int lane = threadIdx.x & 31;
  const bool rtl = threadIdx.x >= 32;
  const size_t row = (size_t)blockIdx.x * w1 * 32;
  const uint2* c = reinterpret_cast<const uint2*>(cost) + row + lane;
  uint2* s = reinterpret_cast<uint2*>(sum) + row + lane;
  const int mid = w1 / 2;
  const bool odd = w1 & 1;
  Path p{0u, 0u, 0};
  walk_row<false>(p, c, s, 0, mid, w1, rtl, lane);
  __syncthreads();
  uint2 keep = make_uint2(0u, 0u);
  if (odd) {
    path_step(p, __ldg(c + (size_t)mid * 32), lane);
    const uint2 l = make_uint2(p.l0, p.l1);
    if (rtl) keep = l; else s[(size_t)mid * 32] = l;
  }
  walk_row<true>(p, c, s, mid + odd, w1, w1, rtl, lane);
  if (odd) {
    __syncthreads();
    if (rtl) s[(size_t)mid * 32] = add2(keep, s[(size_t)mid * 32]);
  }
}

// Passes 2-4: a warp per path line from the top, DX = 0 straight down,
// +1 from the top left, -1 from the top right; it adds its L into S.
template <int DX>
__global__ void __launch_bounds__(32 * kWarpsDown)
sgm_down_kernel(const int16_t* __restrict__ cost, int h, int w1,
                int16_t* __restrict__ sum) {
  const int lane = threadIdx.x & 31;
  const int line = blockIdx.x * kWarpsDown + (threadIdx.x >> 5);
  int x, y, len;
  if (DX == 0) {
    if (line >= w1) return;
    x = line; y = 0; len = h;
  } else {
    if (line >= w1 + h - 1) return;
    if (line < w1) {
      x = line; y = 0;
    } else {
      x = DX > 0 ? 0 : w1 - 1; y = line - w1 + 1;
    }
    len = DX > 0 ? min(w1 - x, h - y) : min(x + 1, h - y);
  }
  const size_t first = ((size_t)y * w1 + x) * 32 + lane;
  const long long step = ((long long)w1 + DX) * 32;
  const uint2* c = reinterpret_cast<const uint2*>(cost) + first;
  uint2* s = reinterpret_cast<uint2*>(sum) + first;
  uint2 cring[kRing], sring[kRing];
  // As in pass 1, unconditional loads (past the end, of the last element).
#pragma unroll
  for (int k = 0; k < kRing; ++k) {
    cring[k] = __ldg(c + min(k, len - 1) * step);
    sring[k] = s[min(k, len - 1) * step];
  }
  Path p{0u, 0u, 0};
  for (int t0 = 0; t0 < len; t0 += kRing) {
#pragma unroll
    for (int k = 0; k < kRing; ++k) {
      const int t = t0 + k;
      if (t >= len) break;
      path_step(p, cring[k], lane);
      s[t * step] = add2(make_uint2(p.l0, p.l1), sring[k]);
      const int tn = min(t + kRing, len - 1);
      cring[k] = __ldg(c + tn * step);
      sring[k] = s[tn * step];
    }
  }
}

}  // namespace

// cost [H, W1, 128] i16 and sum [H, W1, 128] i16, both contiguous on the
// device; every element of sum is written. Returns the launches'
// cudaError_t.
extern "C" int sgm_launch(const int16_t* cost, int h, int w1, int16_t* sum,
                          void* stream) {
  if (h <= 0 || w1 <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  sgm_rows_kernel<<<h, 64, 0, st>>>(cost, w1, sum);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // Passes 2-4.
  const int diag = (w1 + h - 1 + kWarpsDown - 1) / kWarpsDown;
  sgm_down_kernel<0><<<(w1 + kWarpsDown - 1) / kWarpsDown, 32 * kWarpsDown,
                       0, st>>>(cost, h, w1, sum);
  sgm_down_kernel<1><<<diag, 32 * kWarpsDown, 0, st>>>(cost, h, w1, sum);
  sgm_down_kernel<-1><<<diag, 32 * kWarpsDown, 0, st>>>(cost, h, w1, sum);
  return (int)cudaGetLastError();
}
