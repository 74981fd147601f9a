"""Semi-global matching (SGM) stereo disparity on the device.

The JAX package computes stereo depth with OpenCV's CPU StereoSGBM,
`cv2.StereoSGBM_create(minDisparity=0, numDisparities=128, blockSize=5)`
on 8-bit gray images, output / 16 (photo_slam_tpu/mapper/mapper.py:
325-346; the reference ran cv::cuda::StereoSGM). The machine with the card
has no OpenCV, so the port computes the same function itself, in integers
as OpenCV does, so that the card, the CPU and OpenCV agree bit for bit
(tests/test_torch_stereo.py holds the CPU version to cv2). With the
parameters the JAX call leaves at 0, StereoSGBM (MODE_SGBM) uses:

  * P1 2, P2 max(5, P1 + 1) = 5, preFilterCap 15, disp12MaxDiff 1,
    uniquenessRatio 0 (no rejection), no speckle filter;
  * the matching cost: Birchfield-Tomasi on the x-Sobel image clipped to
    [-15, 15] (+ 15), plus Birchfield-Tomasi on the image >> 2, both with
    the first and last column set to 15; summed over the 5 x 5 block with
    edge-replicated sums; only x >= 128 (all 128 disparities in view) is
    matched, the rest stays invalid;
  * five aggregation paths, left to right, right to left, top to bottom
    and the two diagonals from the top, each starting at 0 outside the
    image: L(p, d) = C(p, d) + min(L(p-r, d), L(p-r, d +- 1) + P1,
    min_k L(p-r, k) + P2) - min_k L(p-r, k);
  * winner-takes-all over the sum S (the first minimum), a parabola fit
    in 1/16 px with C's truncating division, a left-right check against
    the right image's winners (ties to the rightmost pixel), and a 3 x 3
    median of the fixed-point result (edges replicated);
  * -16 (fixed point), -1 px after / 16, where invalid.

Path aggregation, a recurrence of 480-752 steps per line, is the kernel
csrc/sgm.cu (`sgm_aggregate`); the cost volume, the winner, the sub-pixel
fit, the check and the median are a few dozen torch launches on the
tensors' device. `sgm_disparity_plain` is the plain version of the whole
function (the aggregation a loop of torch steps), for CPU tensors and the
comparisons on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from photo_slam_tpu_torch import kernels

NUM_DISP = 128      # numDisparities (minDisparity 0)
BLOCK_RADIUS = 2    # blockSize 5
P1 = 2
P2 = 5
PREFILTER_CAP = 15
DISP12_MAX_DIFF = 1
DISP_SHIFT = 4      # fixed-point disparity: 1/16 px
INVALID = -(1 << DISP_SHIFT)
# A cost is at most 25 x (30 + 63) = 2,325; a path cost L lies in
# [C - P2, C] (OpenCV subtracts minp + P2), so the five-path sum lies in
# [-5 P2, 5 x 2,325] = [-25, 11,625], inside int16, OpenCV's CostType.
MAX_COST = 25 * (2 * PREFILTER_CAP + 63)
MAX_PATH_SUM = 5 * MAX_COST
# The sentinel beyond d = -1 and d = D. OpenCV's (32,767) would wrap in
# int16 once P1 is added; any s with s + P1 > MAX_COST + P2 (the largest
# minp + P2) never wins, and 16,383 + P1 cannot overflow.
SENTINEL = 16383


def _prefilter(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The two matching channels of an [H, W] uint8 image, int16: the
    x-Sobel response clipped to the cap (+ cap) and the image itself, each
    with its first and last column set to the cap."""
    g = img.to(torch.int16)
    up = torch.cat([g[:1], g[:-1]])
    down = torch.cat([g[1:], g[-1:]])

    def dx(a):
        return a[:, 2:] - a[:, :-2]

    sobel = torch.full_like(g, PREFILTER_CAP)
    sobel[:, 1:-1] = (2 * dx(g) + dx(up) + dx(down)).clamp(
        -PREFILTER_CAP, PREFILTER_CAP) + PREFILTER_CAP
    raw = torch.full_like(g, PREFILTER_CAP)
    raw[:, 1:-1] = g[:, 1:-1]
    return sobel, raw


def _half_range(ch: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Birchfield-Tomasi's min and max of each value and its averages with
    the left and right neighbours (one sided at the edges)."""
    left = torch.cat([ch[:, :1], (ch[:, 1:] + ch[:, :-1]) // 2], 1)
    right = torch.cat([(ch[:, :-1] + ch[:, 1:]) // 2, ch[:, -1:]], 1)
    return (torch.minimum(torch.minimum(left, right), ch),
            torch.maximum(torch.maximum(left, right), ch))


def cost_volume(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """[H, W - 128, 128] int16 matching cost of each pixel x >= 128 of the
    left image against x - d of the right, summed over the 5 x 5 block."""
    h, w = left.shape
    dev = left.device
    xs = torch.arange(NUM_DISP, w, device=dev)
    xr = xs[:, None] - torch.arange(NUM_DISP, device=dev)[None, :]
    zero = torch.zeros((), dtype=torch.int16, device=dev)
    pix = None
    for c1, c2, shift in zip(_prefilter(left), _prefilter(right), (0, 2)):
        u0, u1 = _half_range(c1)
        v0, v1 = _half_range(c2)
        u, u0, u1 = (a[:, NUM_DISP:, None] for a in (c1, u0, u1))
        v, v0, v1 = c2[:, xr], v0[:, xr], v1[:, xr]
        c0 = torch.maximum(torch.maximum(u - v1, v0 - u), zero)
        c1_ = torch.maximum(torch.maximum(v - u1, u0 - v), zero)
        c = torch.minimum(c0, c1_) >> shift
        pix = c if pix is None else pix + c
    w1 = w - NUM_DISP
    ix = torch.arange(w1, device=dev)
    rows = sum(pix[:, (ix + k).clamp(0, w1 - 1)]
               for k in range(-BLOCK_RADIUS, BLOCK_RADIUS + 1))
    iy = torch.arange(h, device=dev)
    return sum(rows[(iy + k).clamp(0, h - 1)]
               for k in range(-BLOCK_RADIUS, BLOCK_RADIUS + 1))


def _path_step(c, lp, minp, sentinel):
    """One step of every path in a batch: lp [..., D], minp [...]."""
    delta = (P2 + minp)[..., None]
    big = torch.full_like(lp[..., :1], sentinel)
    lower = torch.cat([big, lp[..., :-1]], -1) + P1
    upper = torch.cat([lp[..., 1:], big], -1) + P1
    lnew = c + torch.minimum(torch.minimum(lp, lower),
                             torch.minimum(upper, delta)) - delta
    return lnew, lnew.amin(-1)


def path_sums(cost: torch.Tensor, sentinel: int = SENTINEL) -> torch.Tensor:
    """[H, W1, D] int32 sum over the five paths of the path costs of the
    int16 cost volume, in torch steps with `sentinel` beyond d = -1 and
    d = D. The two horizontal paths step together, as do the three from
    the top."""
    h, w1, d = cost.shape
    c = cost.to(torch.int32)
    total = torch.zeros_like(c)
    lp = c.new_zeros((2, h, d))
    minp = c.new_zeros((2, h))
    for s in range(w1):
        lp, minp = _path_step(torch.stack([c[:, s], c[:, w1 - 1 - s]]), lp,
                              minp, sentinel)
        total[:, s] += lp[0]
        total[:, w1 - 1 - s] += lp[1]
    lp = c.new_zeros((3, w1, d))
    minp = c.new_zeros((3, w1))
    zl, zm = lp.new_zeros((1, d)), minp.new_zeros(1)
    for y in range(h):
        # Predecessors (x - 1, y - 1), (x, y - 1), (x + 1, y - 1); a path
        # entering from outside the image starts at 0.
        lp = torch.stack([torch.cat([zl, lp[0, :-1]]), lp[1],
                          torch.cat([lp[2, 1:], zl])])
        minp = torch.stack([torch.cat([zm, minp[0, :-1]]), minp[1],
                            torch.cat([minp[2, 1:], zm])])
        lp, minp = _path_step(c[y][None], lp, minp, sentinel)
        total[y] += lp.sum(0)
    return total


def sgm_aggregate_plain(cost: torch.Tensor) -> torch.Tensor:
    """[H, W1, D] int16 five-path sum of the int16 cost volume: the plain
    version of the sgm kernel (path_sums, whose values never exceed
    MAX_PATH_SUM, in the kernel's dtype)."""
    return path_sums(cost).to(torch.int16)


def sgm_aggregate(cost: torch.Tensor) -> torch.Tensor:
    """The five-path sum of path costs, [H, W1, D] int16, of an int16
    [H, W1, 128] cost volume.

    On a CUDA tensor it launches csrc/sgm.cu (or raises); on a CPU tensor
    it runs sgm_aggregate_plain. `sgm_aggregate.launches` counts kernel
    launches."""
    dev = cost.device
    if dev.type == "cpu":
        return sgm_aggregate_plain(cost)
    if dev.type != "cuda":
        raise ValueError(f"sgm_aggregate: unsupported device {dev}")
    if (cost.dtype != torch.int16 or cost.dim() != 3
            or cost.shape[2] != NUM_DISP or not cost.is_contiguous()):
        raise ValueError(f"sgm_aggregate: cost must be a contiguous int16 "
                         f"[H, W1, {NUM_DISP}] tensor, got {cost.dtype} "
                         f"{tuple(cost.shape)}")
    h, w1, _ = cost.shape
    # Every element is written by the kernel's first pass.
    total = torch.empty(cost.shape, dtype=torch.int16, device=dev)
    kernels.launch("sgm", dev, cost.data_ptr(), h, w1, total.data_ptr())
    sgm_aggregate.launches += 1
    return total


sgm_aggregate.launches = 0


def _winners(total: torch.Tensor, width: int) -> torch.Tensor:
    """Fixed-point disparity [H, W] int32 from the path-cost sum (int16 or
    int32): the first minimum, the parabola fit, the left-right check."""
    h, w1, d = total.shape
    dev = total.device
    ds = torch.arange(d, device=dev)
    min_s = total.amin(-1)
    best = torch.where(total == min_s[..., None], ds, d).amin(-1)
    # The right image's winners: for each right pixel x - d the smallest
    # cost, ties to the largest left x (OpenCV walks x downwards with a
    # strict compare).
    x = torch.arange(w1, device=dev)
    target = x[None, :] + NUM_DISP - best
    key = min_s.to(torch.int64) * (1 << 20) + (w1 - 1 - x)[None, :]
    none = torch.iinfo(torch.int64).max
    won = torch.full((h, width), none, dtype=torch.int64, device=dev)
    won.scatter_reduce_(1, target, key, "amin")
    winner_x = (w1 - 1) - won % (1 << 20)
    disp2 = torch.where(won != none,
                        torch.gather(best, 1, winner_x.clamp(0, w1 - 1)),
                        INVALID)
    # In int32: (s_lo - s_hi) * 16 and denom2 * 2 overflow int16.
    s_lo, s_hi = (torch.gather(total, 2, (best + k).clamp(0, d - 1)[
        ..., None])[..., 0].to(torch.int32) for k in (-1, 1))
    min_s = min_s.to(torch.int32)
    denom2 = (s_lo + s_hi - 2 * min_s).clamp(min=1)
    sub = best * 16 + torch.div((s_lo - s_hi) * 16 + denom2, denom2 * 2,
                                rounding_mode="trunc")
    fixed = torch.where((best > 0) & (best < d - 1), sub, best * 16)
    # Left-right check with the disparity rounded both ways.
    xx = torch.arange(NUM_DISP, width, device=dev)[None, :]

    def inconsistent(dd):
        xq = xx - dd
        other = torch.gather(disp2, 1, xq.clamp(0, width - 1))
        return ((xq >= 0) & (xq < width) & (other >= 0)
                & ((other - dd).abs() > DISP12_MAX_DIFF))

    fixed = torch.where(inconsistent(fixed >> DISP_SHIFT)
                        & inconsistent((fixed + 15) >> DISP_SHIFT),
                        INVALID, fixed)
    out = torch.full((h, width), INVALID, dtype=torch.int32, device=dev)
    out[:, NUM_DISP:] = fixed
    return out


def _median3(disp: torch.Tensor) -> torch.Tensor:
    """3 x 3 median with replicated edges (cv2.medianBlur, ksize 3)."""
    h, w = disp.shape
    p = torch.nn.functional.pad(disp[None, None].float(), (1, 1, 1, 1),
                                mode="replicate")[0, 0]
    window = torch.stack([p[i:i + h, j:j + w] for i in range(3)
                          for j in range(3)])
    return window.sort(0).values[4]


def _sgm(left, right, aggregate) -> torch.Tensor:
    for name, img in (("left", left), ("right", right)):
        if img.dtype != torch.uint8 or img.dim() != 2:
            raise ValueError(f"sgm_disparity: {name} must be an [H, W] "
                             f"uint8 tensor, got {img.dtype} "
                             f"{tuple(img.shape)}")
    if left.shape != right.shape or left.device != right.device:
        raise ValueError("sgm_disparity: left and right differ in shape or "
                         "device")
    h, w = left.shape
    if w <= NUM_DISP:
        return torch.full((h, w), INVALID / 16.0, device=left.device)
    total = aggregate(cost_volume(left, right).contiguous())
    return _median3(_winners(total, w)) / 16.0


def sgm_disparity_plain(left: torch.Tensor,
                        right: torch.Tensor) -> torch.Tensor:
    """[H, W] float32 disparity in pixels (-1 where invalid) of two
    rectified [H, W] uint8 gray images: the plain version of
    sgm_disparity, with the aggregation in torch steps."""
    return _sgm(left, right, sgm_aggregate_plain)


def sgm_disparity(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """[H, W] float32 disparity in pixels (-1 where invalid) of two
    rectified [H, W] uint8 gray images on their device: the function of
    cv2.StereoSGBM_create(0, 128, 5).compute(left, right) / 16. A CUDA
    tensor goes through the sgm kernel (or raises), a CPU tensor through
    sgm_disparity_plain."""
    if left.device.type == "cpu":
        return sgm_disparity_plain(left, right)
    return _sgm(left, right, sgm_aggregate)


# ---------------------------------------------------------------------------
# Host entry points of the frontend and the mapper
# ---------------------------------------------------------------------------

def gray_u8(img: np.ndarray) -> np.ndarray:
    """[H, W] uint8 gray of a [3, H, W] RGB or [H, W] float image in [0, 1],
    as the JAX mapper's to_gray makes it (OpenCV's fixed-point weights)."""
    from photo_slam_tpu_torch.tracking.vision import rgb_to_gray

    if img.ndim == 3:
        return rgb_to_gray((np.clip(np.transpose(img, (1, 2, 0)), 0, 1)
                            * 255).astype(np.uint8))
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def disparity_u8(left: np.ndarray, right: np.ndarray, device) -> np.ndarray:
    """[H, W] float32 disparity of two [H, W] uint8 gray images, computed
    on `device` (the one function a test swaps OpenCV's SGBM in for)."""
    dev = torch.device(device)
    return sgm_disparity(torch.from_numpy(np.ascontiguousarray(left)).to(dev),
                         torch.from_numpy(np.ascontiguousarray(right)).to(
                             dev)).cpu().numpy()


def disparity(left_chw: np.ndarray, right_chw: np.ndarray,
              device) -> np.ndarray:
    """[H, W] float32 disparity (-1 invalid) of two rectified float images
    ([3, H, W] RGB or [H, W] gray in [0, 1]): the JAX package's
    GaussianMapper._stereo_disparity, on `device`."""
    return disparity_u8(gray_u8(left_chw), gray_u8(right_chw), device)
