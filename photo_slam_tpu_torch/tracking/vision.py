"""The vision functions of the SLAM frontend and the EuRoC loader, owned
by the port.

The JAX package calls OpenCV for these (photo_slam_tpu/tracking/
frontend.py:161, :289-299, :430-438, :508-521, :827; photo_slam_tpu/io/
datasets.py:341-343, 349-350, 379-382). The card's machine
has no OpenCV, so the port implements them here with the same semantics,
and the frontend reaches them only through this module (a test swaps in
OpenCV's versions):

  * rgb_to_gray: OpenCV's fixed-point RGB->gray, bit for bit;
  * rodrigues / rodrigues_inverse: rotation vector <-> matrix, as
    cv2.Rodrigues computes them, bit for bit;
  * solve_pnp_ransac: cv2.solvePnPRansac with SOLVEPNP_ITERATIVE, bit for
    bit on the CPU: OpenCV's RANSAC registrator (its own cv::RNG) over
    EPnP on five-point samples, the winner's inliers refined by OpenCV's
    Levenberg-Marquardt from the caller's guess (or the winning model),
    every sum in OpenCV's order (see "OpenCV's own numerics");
  * find_essential_mat / recover_pose / triangulate_points:
    cv2.findEssentialMat(..., RANSAC), cv2.recoverPose and
    cv2.triangulatePoints, bit for bit on the CPU: the same RANSAC
    registrator over OpenCV's five-point kernel (its full Jacobi SVD,
    getCoeffMat's formulas in five_point_terms, an LU solve, cv::solvePoly's
    sweeps, SVD::solveZ per real root) scored by the float32 Sampson
    distance; recoverPose's four decompositions and cheirality test on
    the same triangulation, each point's null vector from OpenCV's Jacobi
    SVD;
  * orb_detect_and_compute: cv2.ORB_create(nfeatures).detectAndCompute,
    in plain torch on a given device, with OpenCV's learned test pairs;
  * stereo_rectify, init_undistort_rectify_map, remap_linear: the EuRoC
    loader's rectification (cv2.stereoRectify with CALIB_ZERO_DISPARITY
    and alpha 0, initUndistortRectifyMap, remap with INTER_LINEAR), with
    undistort_points (cv2.undistortPoints' five fixed-point iterations).

find_essential_mat and solve_pnp_ransac draw their samples from OpenCV's
cv::RNG(-1), as OpenCV's registrator does, so a run repeats exactly.

ORB returns what OpenCV's does: the same keypoints (level and float32
point), float32 responses and angles, and descriptors bit for bit, in
OpenCV's order, which matching and RANSAC's samples follow downstream.
That order is what KeyPointsFilter::retainBest's std::nth_element and
std::partition leave, so the port takes it from the same libstdc++
algorithms (retain_best, a host C++ shim built by native.py; its Python
twin retain_best_plain is for tests and chip_smoke.py). It computes in
integers wherever OpenCV does (the pyramid's fixed-point bilinear, FAST,
the Harris sums, the intensity centroid) and elsewhere follows OpenCV's
float32 arithmetic op by op: the float scale factor 1.2f and its powers,
the Harris response, fastAtan2's polynomial, the level blur's separable
float filter with the fused multiply-adds of OpenCV's vector build
(emulated exactly in float64), and the steering of the 256 learned tests.
Each of those is a chain of single elementwise torch ops, each rounded
once as IEEE prescribes, with no op that could contract a multiply and an
add (nor a convolution, whose summation order a library picks), so the
card and the CPU agree bit for bit.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from photo_slam_tpu_torch import native


# ---------------------------------------------------------------------------
# Colour and rotations
# ---------------------------------------------------------------------------

# OpenCV's RGB->gray for 8-bit images: 15-bit fixed-point weights
# (0.299, 0.587, 0.114), rounded.
_GRAY_SHIFT = 15
_GRAY_WEIGHTS = (9798, 19235, 3735)


def rgb_to_gray(u8_hwc: np.ndarray) -> np.ndarray:
    """[H, W, 3] uint8 RGB -> [H, W] uint8 gray, as cv2.cvtColor(...,
    COLOR_RGB2GRAY)."""
    x = np.asarray(u8_hwc).astype(np.int32)
    r, g, b = _GRAY_WEIGHTS
    y = (x[..., 0] * r + x[..., 1] * g + x[..., 2] * b
         + (1 << (_GRAY_SHIFT - 1))) >> _GRAY_SHIFT
    return y.astype(np.uint8)


def rodrigues(rvec) -> np.ndarray:
    """Rotation vector -> 3x3 rotation matrix, as cv2.Rodrigues computes it,
    bit for bit (_rodrigues)."""
    return _rodrigues(np.asarray(rvec, np.float64).reshape(1, 3))[0][0]


def rodrigues_inverse(R) -> np.ndarray:
    """3x3 rotation matrix -> rotation vector [3, 1], as cv2.Rodrigues
    computes it, bit for bit (_rodrigues_inverse)."""
    return _rodrigues_inverse(
        np.asarray(R, np.float64).reshape(1, 3, 3))[0].reshape(3, 1)


# ---------------------------------------------------------------------------
# OpenCV's own numerics, op for op
# ---------------------------------------------------------------------------
# The PnP below equals cv2.solvePnPRansac only if every number on its way
# rounds as OpenCV's does: its minimal solver is ill-conditioned on five
# points, and its Levenberg-Marquardt takes a finite-difference second
# derivative with a step of 1e-4, which turns a rounding difference into
# one of ~1e-8 in the pose. So these follow OpenCV's C++ (and the OpenBLAS
# it links for large products) in the order of every sum, each fused
# multiply-add emulated exactly (fma). Sums that C code accumulates left to
# right go through np.cumsum, which adds in that order.

_DBL_MIN = float(np.finfo(np.float64).tiny)
_DBL_EPS = float(np.finfo(np.float64).eps)
_RNG_COEFF = 4164903690


class CvRNG:
    """cv::RNG: a 64-bit multiply-with-carry generator."""

    def __init__(self, state: int):
        self.state = state & 0xFFFFFFFFFFFFFFFF or 0xFFFFFFFF

    def next(self) -> int:
        s = self.state
        self.state = ((s & 0xFFFFFFFF) * _RNG_COEFF
                      + (s >> 32)) & 0xFFFFFFFFFFFFFFFF
        return self.state & 0xFFFFFFFF

    def uniform(self, a: int, b: int) -> int:
        """An int in [a, b), as RNG::uniform(int, int) draws it."""
        return a if a == b else self.next() % (b - a) + a


_SPLIT = 134217729.0  # 2^27 + 1, Veltkamp's split


def _two_product(a, b):
    """a * b as an unevaluated sum p + e, exactly (Dekker's product with
    Veltkamp's split, no FMA needed)."""
    p = a * b
    ca, cb = _SPLIT * a, _SPLIT * b
    a_hi, b_hi = ca - (ca - a), cb - (cb - b)
    a_lo, b_lo = a - a_hi, b - b_hi
    return p, ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo


def _two_sum(a, b):
    """a + b as an unevaluated sum s + e, exactly (Knuth)."""
    s = a + b
    z = s - a
    return s, (a - (s - z)) + (b - z)


def fma(a, b, c):
    """a * b + c rounded once, as an FMA instruction rounds it: the
    product split exactly (_two_product), the three parts summed exactly
    (_two_sum) and rounded at the end."""
    p, e = _two_product(np.asarray(a, np.float64), np.asarray(b, np.float64))
    s, t = _two_sum(p, np.asarray(c, np.float64))
    v, w = _two_sum(t, e)
    z, y = _two_sum(s, v)
    return z + (y + w)


def _seqdot(a, b):
    """Sum of a * b over the last axis, added left to right from 0."""
    return np.cumsum(a * b, axis=-1)[..., -1] + 0.0


def norm_l2sqr(v) -> float:
    """cv::norm(v, NORM_L2SQR) of a double vector as OpenCV's AVX2 build
    sums it: four fused accumulators of four lanes over blocks of 16, added
    in order, the lanes pairwise. The tail under 16 is added in order here,
    which can differ from OpenCV's in the last bit; _levmarq only compares
    these energies."""
    v = np.asarray(v, np.float64).ravel()
    m = len(v) // 16 * 16
    acc = np.zeros((4, 4))
    for blk in v[:m].reshape(-1, 4, 4):
        acc = fma(blk, blk, acc)
    s = ((acc[0] + acc[1]) + acc[2]) + acc[3]
    r = (s[0] + s[1]) + (s[2] + s[3])
    for x in v[m:]:
        r = r + x * x
    return float(r)


def gemm_at_b(A, b) -> np.ndarray:
    """cv::gemm(A, b, 1, noArray(), 0, dst, GEMM_1_T), A [K, 6], b [K]. Under
    100 rows OpenCV's own loop: four running sums over the rows, the rest
    into the first. From 100 rows OpenBLAS's dgemm: the rows in its K blocks
    (128 at most; a remainder over 128 and under 256 halved, rounded up
    to 4), each block summed in order for the first four columns and in
    four lanes (eight rows a step, the rest into the first lane) for the
    last two, the blocks added in order."""
    P = np.asarray(A, np.float64) * np.asarray(b, np.float64)[:, None]
    n = len(P)
    if n < 100:
        m = n // 4 * 4
        acc = np.zeros((4, P.shape[1]))
        if m:
            acc = np.cumsum(P[:m].reshape(-1, 4, P.shape[1]), axis=0)[-1] + 0.0
        for k in range(m, n):
            acc[0] = acc[0] + P[k]
        return ((acc[0] + acc[1]) + acc[2]) + acc[3]
    out = np.zeros(P.shape[1])
    lo = 0
    while lo < n:
        size = n - lo
        if size >= 256:
            size = 128
        elif size > 128:
            size = (size // 2 + 3) // 4 * 4
        blk = P[lo:lo + size]
        head = np.cumsum(blk[:, :4], axis=0)[-1] + 0.0
        m = size // 8 * 8
        lanes = np.cumsum(blk[:m, 4:].reshape(-1, 4, P.shape[1] - 4),
                          axis=0)[-1] + 0.0
        for k in range(m, size):
            lanes[0] = lanes[0] + blk[k, 4:]
        out = out + np.concatenate(
            [head, (lanes[0] + lanes[1]) + (lanes[2] + lanes[3])])
        lo += size
    return out


def mul_transposed(A) -> np.ndarray:
    """cv::mulTransposed(A, dst, true) of a small double matrix: each entry
    of A^T A summed over the rows in order."""
    A = np.asarray(A, np.float64)
    return np.cumsum(A[..., :, :, None] * A[..., :, None, :],
                     axis=-3)[..., -1, :, :] + 0.0


@functools.lru_cache(maxsize=None)
def _jacobi_waves(n: int):
    """The cyclic sweep's pairs (0, 1), (0, 2), ..., (n - 2, n - 1) in waves
    of disjoint pairs: a pair runs one wave after the last earlier pair that
    shares a row with it, so each row meets its rotations in the cyclic
    order and a wave at a time gives the sequential sweep bit for bit."""
    last = [-1] * n
    waves = []
    for i in range(n - 1):
        for j in range(i + 1, n):
            w = max(last[i], last[j]) + 1
            last[i] = last[j] = w
            if w == len(waves):
                waves.append(([], []))
            waves[w][0].append(i)
            waves[w][1].append(j)
    return tuple((np.array(i), np.array(j)) for i, j in waves)


def jacobi_svd(At, null_vectors: bool = True, urows: int | None = None):
    """lapack.cpp's JacobiSVDImpl_ on a batch, step for step: At [B, n, m]
    holds A^T (the n columns of an m x n matrix A, m >= n; cv::SVD runs it
    under 25 rows, OpenCV 5.0 calls LAPACK from there). One-sided Jacobi
    rotations with its hypot and formulas until a sweep changes nothing,
    the descending selection sort, and for a zero singular value a random
    sign vector from cv::RNG(0x12345678) made orthogonal to the earlier
    left singular vectors (skipped without null_vectors, for callers that
    never read those rows). With urows (up to m) U^T has that many rows,
    those past n drawn the same way, as SVD::FULL_UV asks for them.
    -> (W [B, n], U^T [B, urows or n, m], V^T [B, n, n]), A = U diag(W)
    V^T, with OpenCV's signs."""
    At = np.asarray(At, np.float64)
    B, n, m = At.shape
    eps = 10.0 * _DBL_EPS
    # Each row of A^T carries its row of V^T: one rotation turns both.
    AV = np.concatenate([At, np.broadcast_to(np.eye(n), (B, n, n))], 2)
    W = _seqdot(At, At)
    live = np.ones(B, bool)
    with np.errstate(all="ignore"):
        for _ in range(max(m, 30)):
            changed = np.zeros(B, bool)
            for I, J in _jacobi_waves(n):
                Ri, Rj = AV[:, I], AV[:, J]
                a, b = W[:, I], W[:, J]
                p = _seqdot(Ri[..., :m], Rj[..., :m])
                rot = ~(np.abs(p) <= eps * np.sqrt(a * b)) & live[:, None]
                if not rot.any():
                    continue
                p = p * 2.0
                beta = a - b
                # OpenCV's hypot: the larger times sqrt(1 + ratio^2).
                big = np.maximum(np.abs(p), np.abs(beta))
                ratio = np.minimum(np.abs(p), np.abs(beta)) / big
                gamma = np.where(big > 0, big * np.sqrt(1.0 + ratio * ratio),
                                 0.0)
                neg = beta < 0
                r = np.sqrt(np.where(neg, (gamma - beta) * 0.5 / gamma,
                                     (gamma + beta) / (gamma * 2.0)))
                o = p / (gamma * r * 2.0)
                c = np.where(neg, o, r)[..., None]
                s = np.where(neg, r, o)[..., None]
                t0, t1 = c * Ri + s * Rj, -s * Ri + c * Rj
                w0 = _seqdot(t0[..., :m], t0[..., :m])
                w1 = _seqdot(t1[..., :m], t1[..., :m])
                if not rot.all():
                    keep = rot[..., None]
                    t0, t1 = np.where(keep, t0, Ri), np.where(keep, t1, Rj)
                    w0, w1 = np.where(rot, w0, a), np.where(rot, w1, b)
                AV[:, I], AV[:, J], W[:, I], W[:, J] = t0, t1, w0, w1
                changed |= rot.any(1)
            live &= changed
            if not live.any():
                break
    At, Vt = AV[..., :m].copy(), AV[..., m:].copy()
    W = np.sqrt(_seqdot(At, At))
    rows = np.arange(B)
    for i in range(n - 1):
        j = np.full(B, i)
        for k in range(i + 1, n):
            j = np.where(W[rows, j] < W[:, k], k, j)
        sw = rows[j != i]
        if len(sw):
            jj = j[sw]
            W[sw, i], W[sw, jj] = W[sw, jj], W[sw, i].copy()
            At[sw, i], At[sw, jj] = At[sw, jj], At[sw, i].copy()
            Vt[sw, i], Vt[sw, jj] = Vt[sw, jj], Vt[sw, i].copy()
    with np.errstate(divide="ignore"):
        At = At * np.where(W > _DBL_MIN, 1.0 / W, 0.0)[..., None]
    n1 = n if urows is None else urows
    if n1 > n:
        At = np.concatenate([At, np.zeros((B, n1 - n, m))], 1)
        slow = (W <= _DBL_MIN).any(1) | ~_extra_rows(At, n, eps)
    else:
        slow = (W <= _DBL_MIN).any(1) & null_vectors
    zero = np.concatenate([W <= _DBL_MIN, np.ones((B, n1 - n), bool)], 1)
    for b in np.nonzero(slow)[0]:
        # Zero singular values (sorted last) and the rows past n: each left
        # singular vector is a random sign vector made orthogonal to the
        # earlier ones, drawn from one generator per decomposition.
        rng = CvRNG(0x12345678)
        for i in np.nonzero(zero[b])[0]:
            At[b, i] = _null_vector(At[b], i, m, eps, rng)
    return W, At, Vt


def _extra_rows(Ut, n, eps) -> np.ndarray:
    """jacobi_svd's rows n.. of U^T [B, urows, m] (in place) for a batch
    whose first n singular values are all nonzero: every decomposition
    draws the same sign vectors from its own cv::RNG(0x12345678), so they
    are drawn once and made orthogonal to each decomposition's rows
    together, as _null_vector does one at a time. -> whether a
    decomposition's vectors came out nonzero at the first draw (where one
    did not, OpenCV draws again, and the caller takes that one alone)."""
    B, n1, m = Ut.shape
    rng = CvRNG(0x12345678)
    ok = np.ones(B, bool)
    for i in range(n, n1):
        row = np.broadcast_to(
            np.array([1.0 / m if rng.next() & 256 else -1.0 / m
                      for _ in range(m)]), (B, m))
        for _ in range(2):
            for j in range(i):
                row = row - _seqdot(row, Ut[:, j])[:, None] * Ut[:, j]
                asum = np.cumsum(np.abs(row), 1)[:, -1]
                with np.errstate(divide="ignore"):
                    row = row * np.where(asum > eps * 100, 1.0 / asum,
                                         0.0)[:, None]
        sd = np.sqrt(_seqdot(row, row))
        ok &= sd > _DBL_MIN
        with np.errstate(divide="ignore"):
            Ut[:, i] = row * np.where(sd > _DBL_MIN, 1.0 / sd, 0.0)[:, None]
    return ok


def _null_vector(Ut, i, m, eps, rng):
    """JacobiSVDImpl_'s left singular vector for a zero singular value at
    row i, the rows Ut[:i] already normalized."""
    sd, row, tries = 0.0, Ut[i], 0
    while tries < 100 and sd <= _DBL_MIN:
        row = np.array([1.0 / m if rng.next() & 256 else -1.0 / m
                        for _ in range(m)])
        for _ in range(2):
            for j in range(i):
                row = row - _seqdot(row, Ut[j]) * Ut[j]
                asum = np.cumsum(np.abs(row))[-1]
                row = row * (1.0 / asum if asum > eps * 100 else 0.0)
        sd = float(np.sqrt(_seqdot(row, row)))
        tries += 1
    return row * (1.0 / sd if sd > _DBL_MIN else 0.0)


def _svd3(A):
    """(U, W, Vt) of a 3x3 matrix as cv::SVD::compute gives them (the
    Jacobi SVD of jacobi_svd on A^T, so that the columns' signs, and with
    them which decomposition of an essential matrix is called R1 and which
    t, are OpenCV's; LAPACK's SVD picks other signs, and recoverPose's tie
    order would differ)."""
    W, Ut, Vt = jacobi_svd(np.asarray(A, np.float64).T[None])
    return Ut[0].T, W[0], Vt[0]


def _back_substitute(W, Ut, Vt, b):
    """SVBkSb for one right-hand side on a batch: x = V diag(1 / W) U^T b,
    singular values at most 2 eps sum(W) skipped, sums in OpenCV's
    order. W [B, n], U^T [B, n, m], V^T [B, n, n], b [B, m] -> x [B, n]."""
    thr = np.cumsum(W, axis=1)[:, -1] * (2.0 * _DBL_EPS)
    x = np.zeros(W.shape)
    with np.errstate(divide="ignore", invalid="ignore"):
        for i in range(W.shape[1]):
            s = _seqdot(Ut[:, i], b) * (1.0 / W[:, i])
            x = np.where((np.abs(W[:, i]) <= thr)[:, None], x,
                         x + s[:, None] * Vt[:, i])
    return x


def svd_solve(A, b) -> np.ndarray:
    """cv::solve(A, b, x, DECOMP_SVD) on a batch, A [B, m, n] (m >= n),
    b [B, m] -> x [B, n]. Zero columns of A (padding) change nothing
    else: their rows of A^T never rotate and their singular values are
    skipped."""
    return _back_substitute(*jacobi_svd(np.swapaxes(A, 1, 2), False),
                            np.asarray(b, np.float64))


def svd_invert(A) -> np.ndarray:
    """cv::invert(A, DECOMP_SVD) of a batch of square matrices [B, n, n]:
    OpenCV's SVBkSb without a right-hand side takes each column of the
    identity in turn, as _back_substitute does."""
    B, n, _ = A.shape
    svd = jacobi_svd(np.swapaxes(A, 1, 2), False)
    eye = np.broadcast_to(np.eye(n), (B, n, n))
    return np.stack([_back_substitute(*svd, eye[:, c]) for c in range(n)],
                    -1)


_EYE9 = np.eye(3).ravel()
# d[r]_x / dr_i, row i of the 3x9 derivative of the cross-product matrix.
_D_CROSS = np.array([[0, 0, 0, 0, 0, -1, 0, 1, 0], [0, 0, 1, 0, 0, 0, -1, 0, 0],
                     [0, -1, 0, 1, 0, 0, 0, 0, 0]], np.float64)


def _rodrigues(r):
    """cvRodrigues2 from rotation vectors r [B, 3]: (R [B, 3, 3], the
    derivative dR/dr [B, 3, 9] of the row-major R)."""
    r = np.asarray(r, np.float64).reshape(-1, 3)
    B = len(r)
    theta = np.sqrt((r[:, 0] * r[:, 0] + r[:, 1] * r[:, 1]) + r[:, 2] * r[:, 2])
    c = np.array([math.cos(v) for v in theta])
    s = np.array([math.sin(v) for v in theta])
    c1 = 1.0 - c
    with np.errstate(divide="ignore"):
        ith = np.where(theta != 0, 1.0 / theta, 0.0)
    x, y, z = r[:, 0] * ith, r[:, 1] * ith, r[:, 2] * ith
    zero = np.zeros(B)
    rrt = np.stack([x * x, x * y, x * z, x * y, y * y, y * z, x * z, y * z,
                    z * z], 1)
    r_x = np.stack([zero, -z, y, z, zero, -x, -y, x, zero], 1)
    R = (c[:, None] * _EYE9 + c1[:, None] * rrt) + s[:, None] * r_x
    drrt = np.stack([np.stack([x + x, y, z, y, zero, zero, z, zero, zero], 1),
                     np.stack([zero, x, zero, x, y + y, z, zero, z, zero], 1),
                     np.stack([zero, zero, x, zero, zero, y, x, y, z + z], 1)],
                    1)
    J = np.zeros((B, 3, 9))
    for i, ri in enumerate((x, y, z)):
        a0, a1 = -s * ri, (s - 2 * c1 * ith) * ri
        a2, a3, a4 = c1 * ith, (c - s * ith) * ri, s * ith
        J[:, i] = ((((a0[:, None] * _EYE9 + a1[:, None] * rrt)
                     + a2[:, None] * drrt[:, i]) + a3[:, None] * r_x)
                   + a4[:, None] * _D_CROSS[i])
    small = theta < _DBL_EPS
    R[small] = _EYE9
    J[small] = 0.0
    J[small, 0, 5] = J[small, 1, 6] = J[small, 2, 1] = -1.0
    J[small, 0, 7] = J[small, 1, 2] = J[small, 2, 3] = 1.0
    return R.reshape(B, 3, 3), J


def _rodrigues_inverse(R):
    """cvRodrigues2 from rotation matrices R [B, 3, 3] -> rotation vectors
    [B, 3]: R projected onto SO(3) through jacobi_svd, then the angle by
    acos and the axis from the skew part (or, near pi, the diagonal)."""
    R = np.asarray(R, np.float64).reshape(-1, 3, 3)
    _, Ut, Vt = jacobi_svd(np.swapaxes(R, 1, 2))
    P = np.cumsum(Ut[:, :, :, None] * Vt[:, :, None, :], axis=1)[:, -1] + 0.0
    out = np.zeros((len(R), 3))
    for b, M in enumerate(P):
        if not (np.isfinite(R[b]).all() and np.abs(R[b]).max() <= 100):
            continue
        rx, ry, rz = M[2, 1] - M[1, 2], M[0, 2] - M[2, 0], M[1, 0] - M[0, 1]
        s = math.sqrt((rx * rx + ry * ry + rz * rz) * 0.25)
        c = min(max((M[0, 0] + M[1, 1] + M[2, 2] - 1) * 0.5, -1.0), 1.0)
        theta = math.acos(c)
        if s < 1e-5:
            if c > 0:
                rx = ry = rz = 0.0
            else:
                rx = math.sqrt(max((M[0, 0] + 1) * 0.5, 0.0))
                ry = (math.sqrt(max((M[1, 1] + 1) * 0.5, 0.0))
                      * (-1.0 if M[0, 1] < 0 else 1.0))
                rz = (math.sqrt(max((M[2, 2] + 1) * 0.5, 0.0))
                      * (-1.0 if M[0, 2] < 0 else 1.0))
                if (abs(rx) < abs(ry) and abs(rx) < abs(rz)
                        and (M[1, 2] > 0) != (ry * rz > 0)):
                    rz = -rz
                theta /= math.sqrt(rx * rx + ry * ry + rz * rz)
                rx, ry, rz = rx * theta, ry * theta, rz * theta
        else:
            vth = 1 / (2 * s) * theta
            rx, ry, rz = rx * vth, ry * vth, rz * vth
        out[b] = rx, ry, rz
    return out


def _project(X, R, t, K, dRdr=None):
    """cvProjectPoints2 without distortion on a batch of poses: points
    X [N, 3] (or [B, N, 3]) by R [B, 3, 3], t [B, 3] -> pixels [B, N, 2]
    and, given dR/dr, the derivative [B, N, 2, 6] by (rvec, tvec)."""
    X = np.asarray(X, np.float64)
    Rf, t = R.reshape(-1, 1, 9), t[:, None, :]
    Xx, Xy, Xz = X[..., 0], X[..., 1], X[..., 2]
    x = ((Rf[..., 0] * Xx + Rf[..., 1] * Xy) + Rf[..., 2] * Xz) + t[..., 0]
    y = ((Rf[..., 3] * Xx + Rf[..., 4] * Xy) + Rf[..., 5] * Xz) + t[..., 1]
    z = ((Rf[..., 6] * Xx + Rf[..., 7] * Xy) + Rf[..., 8] * Xz) + t[..., 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        z = np.where(z != 0, 1.0 / z, 1.0)
    x, y = x * z, y * z
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    uv = np.stack([x * fx + cx, y * fy + cy], -1)
    if dRdr is None:
        return uv
    d = dRdr[:, None]
    J = np.zeros(uv.shape + (6,))
    for j in range(3):
        dx0 = (Xx * d[..., j, 0] + Xy * d[..., j, 1]) + Xz * d[..., j, 2]
        dy0 = (Xx * d[..., j, 3] + Xy * d[..., j, 4]) + Xz * d[..., j, 5]
        dz0 = (Xx * d[..., j, 6] + Xy * d[..., j, 7]) + Xz * d[..., j, 8]
        J[..., 0, j] = fx * (z * (dx0 - x * dz0))
        J[..., 1, j] = fy * (z * (dy0 - y * dz0))
    J[..., 0, 3] = fx * z
    J[..., 1, 4] = fy * z
    J[..., 0, 5] = fx * (-x * z)
    J[..., 1, 5] = fy * (-y * z)
    return uv, J


# ---------------------------------------------------------------------------
# Two-view geometry: cv2.findEssentialMat(..., RANSAC), cv2.recoverPose and
# cv2.triangulatePoints, OpenCV 5.0
# ---------------------------------------------------------------------------
# findEssentialMat normalizes the pixels, scales the threshold by the mean
# focal length and runs the RANSAC registrator (ransac, below) over
# five-point samples. Its kernel, EMEstimatorCallback::runKernel, takes
# the null space of the 5 x 9 epipolar system from a full Jacobi SVD (the
# four vectors past the rank are jacobi_svd's random sign vectors, drawn
# from cv::RNG(0x12345678) and made orthogonal), builds the 10 x 20
# matrix of cubic constraints (getCoeffMat), eliminates with an LU solve
# (lu_solve), forms the degree-10 polynomial in z and finds its roots with
# cv::solvePoly (solve_poly: OpenCV 5.0's start on a circle and its 300
# Weierstrass sweeps, which never stop early on these polynomials), then
# for each real root takes x and y from the last right singular vector of
# a 3 x 3 system (SVD::solveZ) and forms E through addWeighted, scaleAdd
# and add (fused multiply-adds in OpenCV's vector build, emulated by fma),
# divided by its norm. The two big formulas are five_point_terms' text,
# evaluated in the compiled code's order (SumsOfProducts). Models are
# scored by the Sampson distance in double stored as float32
# (_sampson_errors). Every step was held to the opencv-python 5.0.0 wheel,
# step by step where OpenCV exposes it (cv2.solvePoly, cv2.solve,
# cv2.SVDecomp, cv2.addWeighted, cv2.scaleAdd, cv2.norm, cv2.gemm,
# cv2.decomposeEssentialMat) and through cv2.findEssentialMat's stacked
# roots on exactly five correspondences elsewhere.

ESSENTIAL_SAMPLE = 5         # correspondences a five-point sample takes
# Subsets solved at once, first and later: solve_poly's sweeps cost about
# the same for 64 samples as for 16, so the first batch is PnP's four times.
ESSENTIAL_BATCHES = (64, 256)
POLY_ITERS = 300             # cv::solvePoly's default, as runKernel calls it
_ROOT_IMAG = 1e-10           # runKernel's bound on a real root's imaginary part
# decomposeEssentialMat's W: R = U W V^T or U W^T V^T, t = U's last column.
_W90 = np.array([[0.0, 1.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])


def _normalized(px, K) -> np.ndarray:
    """Pixels [N, 2] -> normalized image coordinates [N, 2], as
    findEssentialMat and recoverPose compute them: (x - cx) / fx becomes
    convertTo's x * (1 / fx) + (-cx) * (1 / fx), one fused multiply-add."""
    px = np.asarray(px, np.float64).reshape(-1, 2)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    return np.stack([fma(px[:, 0], 1.0 / fx, -cx * (1.0 / fx)),
                     fma(px[:, 1], 1.0 / fy, -cy * (1.0 / fy))], 1)


def triangulate_points(P0, P1, p0, p1) -> np.ndarray:
    """cv2.triangulatePoints, bit for bit: P0, P1 [3, 4] projection
    matrices, p0, p1 [2, N] points -> [4, N] homogeneous points. Each
    point's 4x4 system has the rows x0 P0[2] - P0[0], y0 P0[2] - P0[1],
    x1 P1[2] - P1[0], y1 P1[2] - P1[1]; its solution is the last row of
    V^T from OpenCV's Jacobi SVD (jacobi_svd, batched over the points), with
    OpenCV's sign. Computed in double; float32 points give float32 output,
    as OpenCV's do."""
    dtype = np.float32 if np.asarray(p0).dtype == np.float32 else np.float64
    P0 = np.asarray(P0, np.float64)
    P1 = np.asarray(P1, np.float64)
    p0 = np.asarray(p0, np.float64).reshape(2, -1)
    p1 = np.asarray(p1, np.float64).reshape(2, -1)
    A = np.stack([p0[0][:, None] * P0[2] - P0[0],
                  p0[1][:, None] * P0[2] - P0[1],
                  p1[0][:, None] * P1[2] - P1[0],
                  p1[1][:, None] * P1[2] - P1[1]], 1)      # [N, 4, 4]
    if len(A) == 0:
        return np.zeros((4, 0), dtype)
    _, _, Vt = jacobi_svd(np.swapaxes(A, 1, 2), False)
    return Vt[:, 3].T.astype(dtype)


class SumsOfProducts:
    """Formulas written as sums of products (five_point_terms' layout:
    "<label>: t0 + t1 - t2 ..." with continuation lines), evaluated on a
    batch so that every entry rounds as written: each product left to
    right, each sum left to right from its first term. Variables are
    <letter><k> and, with powers, <letter>2_<k> (the square) and
    <letter>3_<k> (the square times the variable); constants are positive
    literals. All terms are evaluated at once (padded with 1.0, an exact
    factor) and summed a column at a time (padded with -0.0, an exact
    addend)."""

    def __init__(self, text: str, nvars: int, powers: int = 1):
        entries = []
        for line in text.strip().splitlines():
            if line.startswith(" "):
                entries[-1] += " " + line.strip()
            else:
                entries.append(line.split(":", 1)[1].strip())
        consts, terms, rows = {}, [], []

        def index(tok):
            name, _, power = tok.partition("_")
            if name[0].isalpha():
                k = int(power) if power else int(name[1:])
                p = int(name[1:]) if power else 1
                return (p - 1) * nvars + k
            return nvars * powers + consts.setdefault(float(tok), len(consts))

        for entry in entries:
            toks = entry.split()
            if toks[0].startswith("-"):
                toks[0:1] = ["-", toks[0][1:]]
            else:
                toks.insert(0, "+")
            row = []
            for sign, term in zip(toks[0::2], toks[1::2]):
                row.append(len(terms))
                terms.append((-1.0 if sign == "-" else 1.0,
                              [index(f) for f in term.split("*")]))
            rows.append(row)
        one = nvars * powers + len(consts)
        width = max(len(f) for _, f in terms)
        self.factors = np.full((len(terms), width), one, np.int64)
        for t, (_, f) in enumerate(terms):
            self.factors[t, :len(f)] = f
        self.signs = np.array([s for s, _ in terms])[:, None]
        self.consts = np.array(list(consts) + [1.0])
        self.order = np.full((len(rows), max(map(len, rows))), len(terms),
                             np.int64)
        for r, row in enumerate(rows):
            self.order[r, :len(row)] = row
        self.powers = powers

    def __call__(self, x) -> np.ndarray:
        """x [B, nvars] -> [B, entries]."""
        x = np.asarray(x, np.float64)
        cols = [x]
        for _ in range(self.powers - 1):
            cols.append(cols[-1] * x)
        cols.append(np.broadcast_to(self.consts, (len(x), len(self.consts))))
        values = np.concatenate(cols, 1).T                      # [V, B]
        prod = values[self.factors[:, 0]]
        for j in range(1, self.factors.shape[1]):
            prod = prod * values[self.factors[:, j]]
        prod = np.concatenate([prod * self.signs,
                               np.full((1, len(x)), -0.0)])
        acc = np.full((len(self.order), len(x)), -0.0)
        for j in range(self.order.shape[1]):
            acc = acc + prod[self.order[:, j]]
        return acc.T


@functools.lru_cache(maxsize=None)
def _five_point_formulas():
    from photo_slam_tpu_torch.tracking import five_point_terms

    return (SumsOfProducts(five_point_terms.COEFFS, 36, 3),
            SumsOfProducts(five_point_terms.POLY, 39))


def lu_solve(A, b):
    """cv::solve(A, b, x, DECOMP_LU) on a batch, A [B, m, m], b [B, m, k]:
    OpenCV's LUImpl (partial pivoting on the first largest |pivot|, row
    operations a_jk += alpha a_ik, back substitution summed in order).
    A pivot under 100 DBL_EPSILON fails the solve, and x is 0 there, as
    OpenCV's is. -> x [B, m, k]."""
    A = np.array(A, np.float64)
    b = np.array(b, np.float64)
    B, m, _ = A.shape
    rows = np.arange(B)
    ok = np.ones(B, bool)
    with np.errstate(all="ignore"):
        for i in range(m):
            k = i + np.argmax(np.abs(A[:, i:, i]), 1)
            ok &= ~(np.abs(A[rows, k, i]) < _DBL_EPS * 100)
            swap = rows[k != i]
            if len(swap):
                kk = k[swap]
                A[swap, i], A[swap, kk] = A[swap, kk], A[swap, i].copy()
                b[swap, i], b[swap, kk] = b[swap, kk], b[swap, i].copy()
            alpha = A[:, i + 1:, i] * (-1.0 / A[:, i, i])[:, None]
            A[:, i + 1:, i + 1:] += alpha[..., None] * A[:, i, None, i + 1:]
            b[:, i + 1:] += alpha[..., None] * b[:, i, None]
        for i in range(m - 1, -1, -1):
            s = b[:, i]
            for k in range(i + 1, m):
                s = s - A[:, i, k, None] * b[:, k]
            b[:, i] = s / A[:, i, i, None]
    return np.where(ok[:, None, None], b, 0.0)


def _sum_in_fours(v) -> np.ndarray:
    """cv::sum of doubles over the last axis: blocks of four, each summed
    left to right, added in order from 0."""
    n = v.shape[-1]
    acc = np.zeros(v.shape[:-1])
    for i in range(0, n - n % 4, 4):
        acc = acc + (((v[..., i] + v[..., i + 1]) + v[..., i + 2])
                     + v[..., i + 3])
    for i in range(n - n % 4, n):
        acc = acc + v[..., i]
    return acc


def _poly_start(c, n):
    """cv::solvePoly's starting roots for real coefficients c [B, n + 1]
    (c_k multiplies z^k): n points R (cos, sin)^k on a circle, the radius
    R the mean of the bounds 2 (|c_k| / |c_n|)^(1 / (n - k)) and
    0.5 (|c_0| / |c_k|)^(1 / k) over the coefficients above DBL_EPSILON,
    the largest upper and the smallest lower bound left out and the sum
    divided by twice their count less two; 1 where there are too few."""
    B = len(c)
    a = np.sqrt(c * c)
    upper, lower = np.zeros((B, n)), np.zeros((B, n))
    count = np.zeros(B, np.int64)
    for b in range(B):
        if a[b, 0] > _DBL_EPS:
            upper[b, 0] = math.pow(a[b, 0] / a[b, n], 1.0 / n) * 2.0
            count[b] = 1
        for k in range(1, n + 1):
            if a[b, k] > _DBL_EPS:
                if k != n:
                    upper[b, k] = math.pow(a[b, k] / a[b, n],
                                           1.0 / (n - k)) * 2.0
                lower[b, k - 1] = math.pow(a[b, 0] / a[b, k], 1.0 / k) * 0.5
                count[b] += 1
    rows = np.arange(B)
    upper[rows, np.argmax(upper, 1)] = 0.0
    lower[rows, np.argmin(lower, 1)] = 0.0
    with np.errstate(all="ignore"):
        radius = np.where(count > 2, (_sum_in_fours(upper)
                                      + _sum_in_fours(lower))
                          / (2.0 * count - 2.0), 1.0)
    theta = 6.283185307179586 / n
    sin, cos = math.sin(theta), math.cos(theta)
    re, im = [radius], [np.zeros(B)]
    for _ in range(n - 1):
        re, im = re + [re[-1] * cos - im[-1] * sin], \
            im + [re[-1] * sin + im[-1] * cos]
    return re, im


def solve_poly(c, max_iters: int = POLY_ITERS):
    """cv::solvePoly(c, roots, max_iters) of OpenCV 5.0 for real
    coefficients c [B, n0 + 1] (c_k multiplies z^k), batched: the degree
    cut while the leading |c_n| is at most DBL_EPSILON, the start of
    _poly_start, then Weierstrass (Durand-Kerner) sweeps in place (each
    root updated by P(p) / (c_n prod_j (p - r_j)) over the others' current
    values, Horner and the product in OpenCV's complex arithmetic) until
    the largest step is 0 or after max_iters; imaginary parts under 1e-100
    set to 0; roots past the cut degree 0. -> (re [B, n0], im [B, n0]).
    OpenCV skips the factor of a root that coincides exactly with the one
    being updated and then corrects the step; from its distinct start,
    within its sweeps, roots meet only in the limit, so that route is not
    reproduced."""
    c = np.asarray(c, np.float64)
    B, n0 = c.shape[0], c.shape[1] - 1
    re, im = np.zeros((B, n0)), np.zeros((B, n0))
    deg = np.full(B, n0)
    for b in range(B):
        while deg[b] > 1 and not abs(c[b, deg[b]]) > _DBL_EPS:
            deg[b] -= 1
    for n in np.unique(deg):
        rows = np.nonzero(deg == n)[0]
        re[rows, :n], im[rows, :n] = _weierstrass(c[rows, :n + 1], int(n),
                                                  max_iters)
    return re, np.where(np.abs(im) < 1e-100, 0.0, im)


def _weierstrass(c, n, max_iters):
    """solve_poly's sweeps on a batch of one degree n. A root's own value
    changes only at its update, so every root's P(p) is taken at the
    sweep's start in one batch; the denominators follow the roots as they
    move."""
    B = len(c)
    rr, ri = _poly_start(c, n)
    lead, zero = c[:, n].copy(), np.zeros(B)
    coef = [c[:, k].copy() for k in range(n + 1)]
    out_r, out_i = np.zeros((B, n)), np.zeros((B, n))
    live = np.ones(B, bool)
    with np.errstate(all="ignore"):
        for _ in range(max_iters if max_iters > 0 else 1000):
            R, I = np.array(rr), np.array(ri)
            nr, ni = np.broadcast_to(lead, (n, B)), zero
            for j in range(n):
                tr = nr * R - ni * I
                ti = ni * R + nr * I
                nr, ni = coef[n - j - 1] + tr, ti + 0.0
            step = zero
            for i in range(n):
                pr, pi = rr[i], ri[i]
                dr = pr - np.array(rr)
                di = pi - np.array(ri)
                er, ei = lead, zero
                for j in range(n):
                    if j != i:
                        er, ei = er * dr[j] - ei * di[j], di[j] * er + dr[j] * ei
                t = 1.0 / (er * er + ei * ei)
                qi = (er * ni[i] - nr[i] * ei) * t
                qr = (er * nr[i] + ei * ni[i]) * t
                rr[i], ri[i] = pr - qr, pi - qi
                step = np.fmax(step, np.sqrt(qi * qi + qr * qr))
            done = live & ~(step > 0)
            if done.any():
                out_r[done] = np.array(rr).T[done]
                out_i[done] = np.array(ri).T[done]
                live &= ~done
                if not live.any():
                    break
    out_r[live] = np.array(rr).T[live]
    out_i[live] = np.array(ri).T[live]
    return out_r, out_i


def _norm9(v) -> np.ndarray:
    """cv::norm(v, NORM_L2) of short double vectors (last axis under 16):
    the squares added in order, whole blocks of four plainly and the rest
    fused (fma), then the root."""
    n = v.shape[-1]
    s = np.zeros(v.shape[:-1])
    for k in range(n):
        s = (s + v[..., k] * v[..., k] if k < n - n % 4
             else fma(v[..., k], v[..., k], s))
    return np.sqrt(s)


def _essential_polys(x1, x2):
    """runKernel up to its polynomial, for normalized points x1 (first
    view), x2 (second) [B, 5, 2]: the null-space vectors EE [B, 4, 9] of
    the 5 x 9 epipolar system (the last four rows of its full SVD's V^T),
    getCoeffMat's 10 x 20 matrix reduced by the LU solve to the 3 x 13
    matrix B [B, 3, 13], and the degree-10 polynomial c [B, 11] in z."""
    B = len(x1)
    coeffs, poly = _five_point_formulas()
    X1, Y1, X2, Y2 = x1[..., 0], x1[..., 1], x2[..., 0], x2[..., 1]
    Q = np.stack([X1 * X2, Y1 * X2, X2, X1 * Y2, Y1 * Y2, Y2, X1, Y1,
                  np.ones_like(X1)], -1)                         # [B, 5, 9]
    EE = jacobi_svd(Q, urows=9)[1][:, 5:]
    A = coeffs(EE.reshape(B, 36)).reshape(B, 10, 20)
    G = lu_solve(A[:, :, :10], A[:, :, 10:])
    Bm = np.zeros((B, 3, 13))
    for i in range(3):
        r1, r2 = G[:, 2 * i + 4], G[:, 2 * i + 5]
        row1, row2 = np.zeros((B, 13)), np.zeros((B, 13))
        row1[:, 1:4], row1[:, 5:8], row1[:, 9:13] = (r1[:, :3], r1[:, 3:6],
                                                     r1[:, 6:])
        row2[:, 0:3], row2[:, 4:7], row2[:, 8:12] = (r2[:, :3], r2[:, 3:6],
                                                     r2[:, 6:])
        Bm[:, i] = row1 - row2
    return EE, Bm, poly(Bm.reshape(B, 39))


def _em_kernel(x1, x2):
    """EMEstimatorCallback::runKernel on a batch of five-point samples,
    normalized points x1 (first view), x2 (second) [B, 5, 2] -> (models
    [M, 3, 3] with x2^T E x1 = 0, the sample each came from [M]), each
    sample's models in root order."""
    EE, Bm, c = _essential_polys(x1, x2)
    re, im = solve_poly(c)
    s, k = np.nonzero(~(np.abs(im) > _ROOT_IMAG))      # (sample, root) order
    z1 = re[s, k]
    z2 = z1 * z1
    z3 = z2 * z1
    z4 = z1 * z3
    br = Bm[s]                                                   # [R, 3, 13]
    bz = np.stack([
        ((br[..., 0] * z3[:, None] + br[..., 1] * z2[:, None])
         + br[..., 2] * z1[:, None]) + br[..., 3],
        ((br[..., 4] * z3[:, None] + br[..., 5] * z2[:, None])
         + br[..., 6] * z1[:, None]) + br[..., 7],
        (((br[..., 8] * z4[:, None] + br[..., 9] * z3[:, None])
          + br[..., 10] * z2[:, None]) + br[..., 11] * z1[:, None])
        + br[..., 12]], -1)                                      # [R, 3, 3]
    if not len(bz):
        return np.zeros((0, 3, 3)), np.zeros(0, np.int64)
    xy1 = jacobi_svd(np.swapaxes(bz, 1, 2), False)[2][:, 2]      # solveZ
    keep = ~(np.abs(xy1[:, 2]) < 1e-10)
    s, z1, xy1 = s[keep], z1[keep], xy1[keep]
    with np.errstate(all="ignore"):
        x, y = xy1[:, 0] / xy1[:, 2], xy1[:, 1] / xy1[:, 2]
        e = EE[s]
        E = fma(e[:, 0], x[:, None], fma(e[:, 1], y[:, None], 0.0))
        E = fma(e[:, 2], z1[:, None], E) + e[:, 3]
        E = E * (1.0 / _norm9(E))[:, None]
    return E.reshape(-1, 3, 3), s


def _sampson_errors(E, x1, x2) -> np.ndarray:
    """EMEstimatorCallback::computeError for models E [M, 3, 3] on
    normalized points x1, x2 [N, 2]: the squared Sampson distance in
    double, each product sum from 0 in OpenCV's order, stored as float32
    -> [M, N]."""
    e = E.reshape(-1, 9, 1)
    p0, p1, q0, q1 = x1[:, 0], x1[:, 1], x2[:, 0], x2[:, 1]
    ex0 = ((0.0 + e[:, 0] * p0) + e[:, 1] * p1) + e[:, 2]
    ex1 = ((0.0 + e[:, 3] * p0) + e[:, 4] * p1) + e[:, 5]
    ex2 = ((0.0 + e[:, 6] * p0) + e[:, 7] * p1) + e[:, 8]
    et0 = ((0.0 + e[:, 0] * q0) + e[:, 3] * q1) + e[:, 6]
    et1 = ((0.0 + e[:, 1] * q0) + e[:, 4] * q1) + e[:, 7]
    d = ((0.0 + q0 * ex0) + q1 * ex1) + ex2
    with np.errstate(all="ignore"):
        return (d * d / (((ex0 * ex0 + ex1 * ex1) + et0 * et0)
                         + et1 * et1)).astype(np.float32)


def find_essential_mat(p0, p1, K, prob: float = 0.999,
                       threshold: float = 1.0, max_iters: int = 1000):
    """The essential matrix of correspondences p0, p1 [N, 2] (pixels of
    cameras with intrinsics K), as cv2.findEssentialMat(p0, p1, K,
    cv2.RANSAC, prob, threshold, max_iters) computes it in OpenCV 5.0, bit
    for bit: the points normalized (_normalized), the threshold divided
    by (fx + fy) / 2, and OpenCV's RANSAC (ransac) over _em_kernel with
    _sampson_errors. Returns (E [3, 3] with x1^T E x0 = 0 for normalized
    homogeneous points, mask [N, 1] uint8 of 0 and 1); on exactly five
    correspondences every root's E stacked [3k, 3] and a mask of ones, as
    OpenCV returns them; (None, None) under five or where RANSAC finds no
    model."""
    K = np.asarray(K, np.float64)
    x1, x2 = _normalized(p0, K), _normalized(p1, K)

    def kernel(subsets):
        return _em_kernel(x1[subsets], x2[subsets])

    model, mask = ransac(len(x1), ESSENTIAL_SAMPLE, kernel,
                         lambda E: _sampson_errors(E, x1, x2),
                         threshold / ((K[0, 0] + K[1, 1]) / 2), prob,
                         max_iters, ESSENTIAL_BATCHES)
    if model is None:
        return None, None
    return model.reshape(-1, 3), mask.astype(np.uint8).reshape(-1, 1)


def _matmul3(A, B) -> np.ndarray:
    """A 3x3 product as cv::gemm sums it: each entry over k in order."""
    return ((A[:, 0, None] * B[0] + A[:, 1, None] * B[1])
            + A[:, 2, None] * B[2])


def _det3(M) -> float:
    """cv::determinant of a 3x3 matrix (its cofactor formula)."""
    return (M[0, 0] * (M[1, 1] * M[2, 2] - M[1, 2] * M[2, 1])
            - M[0, 1] * (M[1, 0] * M[2, 2] - M[1, 2] * M[2, 0])
            + M[0, 2] * (M[1, 0] * M[2, 1] - M[1, 1] * M[2, 0]))


def decompose_essential_mat(E):
    """cv2.decomposeEssentialMat, bit for bit: E's SVD through _svd3, U
    and V^T negated where their determinant is negative, R1 = U W V^T,
    R2 = U W^T V^T and t = U's last column, each product in cv::gemm's
    order. -> (R1, R2, t [3])."""
    U, _, Vt = _svd3(np.asarray(E, np.float64).reshape(3, 3))
    if _det3(U) < 0:
        U = U * -1.0
    if _det3(Vt) < 0:
        Vt = Vt * -1.0
    return (_matmul3(_matmul3(U, _W90), Vt),
            _matmul3(_matmul3(U, _W90.T), Vt), U[:, 2] * 1.0)


def recover_pose(E, p0, p1, K, mask=None, distance_thresh: float = 50.0):
    """Relative pose from an essential matrix, as cv2.recoverPose(E, p0,
    p1, K, mask=mask) computes it, bit for bit: the four decompositions of
    E (decompose_essential_mat) in OpenCV's order [R1|t], [R2|t], [R1|-t],
    [R2|-t], each held to the cheirality test on the normalized points
    (triangulate_points from [I|0]; Q2 Q3 > 0, the dehomogenized depth
    under distance_thresh, and in the second camera, P Q summed as cv::gemm
    sums it, in front and under distance_thresh) and to the input mask;
    the first decomposition with the most points wins. Returns (count,
    R [3, 3], t [3, 1], mask [N, 1] uint8) with X1 = R X0 + t; the mask
    holds the input mask's value at each point that passed (255 without
    an input mask), as OpenCV's does."""
    K = np.asarray(K, np.float64)
    x0, x1 = _normalized(p0, K), _normalized(p1, K)
    m_in = (np.full(len(x0), 255, np.uint8) if mask is None
            else np.asarray(mask).reshape(-1).astype(np.uint8))
    R1, R2, t = decompose_essential_mat(E)
    P0 = np.eye(4)[:3]
    best = None
    for R, tt in ((R1, t), (R2, t), (R1, -t), (R2, -t)):
        P1 = np.concatenate([R, tt[:, None]], 1)
        Q = triangulate_points(P0, P1, x0.T, x1.T)
        ok = Q[2] * Q[3] > 0
        with np.errstate(divide="ignore", invalid="ignore"):
            Q = Q / Q[3]
        ok &= Q[2] < distance_thresh
        z = ((P1[2, 0] * Q[0] + P1[2, 1] * Q[1]) + P1[2, 2] * Q[2]) \
            + P1[2, 3] * Q[3]
        ok &= (z > 0) & (z < distance_thresh) & (m_in > 0)
        good = int(ok.sum())
        if best is None or good > best[0]:
            best = (good, R, tt.reshape(3, 1), ok)
    good, R, tt, ok = best
    return good, R, tt, np.where(ok, m_in, 0).astype(np.uint8).reshape(-1, 1)


# ---------------------------------------------------------------------------
# PnP: cv2.solvePnPRansac(..., flags=SOLVEPNP_ITERATIVE), OpenCV 5.0
# ---------------------------------------------------------------------------
# solvePnPRansac rounds the points to float32 and runs its RANSAC
# registrator over five-point samples solved by EPnP (_epnp), scored by
# projectPoints' float32 squared pixel errors. The winner's inliers, back
# in double, are refined by solvePnP's Levenberg-Marquardt (_levmarq) from
# the caller's guess, or without one from the winning model. Five points
# go to EPnP alone. OpenCV's RANSAC draws from cv::RNG(-1), its own
# generator: cv::setRNGSeed changes nothing.

PNP_CONFIDENCE = 0.99  # solvePnPRansac's default
PNP_SAMPLE = 5         # points a RANSAC sample takes (EPnP's)


def ransac_update_num_iters(p, ep, model_points, max_iters) -> int:
    """RANSACUpdateNumIters: iterations that draw an all-inlier sample with
    probability p at outlier ratio ep, at most max_iters."""
    p, ep = min(max(p, 0.0), 1.0), min(max(ep, 0.0), 1.0)
    num = max(1.0 - p, _DBL_MIN)
    denom = 1.0 - math.pow(1.0 - ep, model_points)
    if denom < _DBL_MIN:
        return 0
    num, denom = math.log(num), math.log(denom)
    if denom >= 0 or -num >= max_iters * -denom:
        return max_iters
    return round(num / denom)          # cvRound: halves to even


def _ransac_subsets(count, k, n) -> np.ndarray:
    """RANSACPointSetRegistrator's first n samples of k distinct indices
    (getSubset: each index drawn again while it repeats one already taken)
    from its cv::RNG(-1) -> [n, k]."""
    rng = CvRNG(0xFFFFFFFFFFFFFFFF)
    out = []
    for _ in range(n):
        row = []
        for _ in range(k):
            j = rng.uniform(0, count)
            while j in row:
                j = rng.uniform(0, count)
            row.append(j)
        out.append(row)
    return np.array(out, np.int64).reshape(n, k)


def ransac(count, model_points, kernel, errors, threshold, confidence,
           max_iters, batches=(16, 64)):
    """cv::RANSACPointSetRegistrator::run over `count` correspondences,
    generic over its kernel: kernel(subsets [b, k]) -> (models [b', ...],
    subset [b'] each model came from, in order); errors(models) -> float32
    squared errors [b', count], inliers where at most
    float32(threshold * threshold) (the threshold in double). A model wins
    with strictly more inliers than the best so far (and than
    model_points - 1), the iterations cut by ransac_update_num_iters.
    Subsets do not depend on the models, so the kernel runs on batches of
    them (batches[0], then up to batches[1] a call) and the models are
    visited in OpenCV's order. Exactly model_points correspondences go to
    the kernel once and every model it returns is returned, stacked.
    -> (best model, inlier mask [count]) or (None, None)."""
    if count < model_points:
        return None, None
    t = np.float32(threshold * threshold)
    if count == model_points:
        models, _ = kernel(np.arange(count)[None])
        if len(models) == 0:
            return None, None
        return models, np.ones(count, bool)
    niters = max(max_iters, 1)
    subsets = _ransac_subsets(count, model_points, niters)
    best, best_mask, best_good = None, None, 0
    it, batch = 0, batches[0]
    while it < niters:
        b = min(batch, niters - it)
        models, owner = kernel(subsets[it:it + b])
        masks = errors(models) <= t
        goods = masks.sum(1)
        started = it - 1
        for j in range(len(models)):
            if it + owner[j] != started:
                if it + owner[j] >= niters:   # the loop ended before it
                    break
                started = it + owner[j]
            if goods[j] > max(best_good, model_points - 1):
                best, best_mask, best_good = models[j], masks[j], int(goods[j])
                niters = ransac_update_num_iters(
                    confidence, (count - best_good) / count, model_points,
                    niters)
        it += b
        batch = batches[1]
    return best, best_mask


def _qr_solve(A, b, X):
    """epnp::qr_solve on a batch, A [B, 6, 4] and b [B, 6] -> x [B, 4]:
    Householder QR as OpenCV writes it (its column maximum skips the last
    row, a pointer that trails by one); where A has a zero column OpenCV
    returns early and x keeps its earlier value X."""
    A, b = A.copy(), b.copy()
    B, nr, nc = A.shape
    A1, A2 = np.zeros((B, nc)), np.zeros((B, nc))
    ok = np.ones(B, bool)
    with np.errstate(divide="ignore", invalid="ignore"):
        for k in range(nc):
            eta = np.abs(A[:, k, k])
            for i in range(k, nr - 1):
                elt = np.abs(A[:, i, k])
                eta = np.where(eta < elt, elt, eta)
            ok &= eta != 0
            A[:, k:, k] = A[:, k:, k] * (1.0 / eta)[:, None]
            sigma = np.sqrt(_seqdot(A[:, k:, k], A[:, k:, k]))
            sigma = np.where(A[:, k, k] < 0, -sigma, sigma)
            A[:, k, k] = A[:, k, k] + sigma
            A1[:, k] = sigma * A[:, k, k]
            A2[:, k] = -eta * sigma
            for j in range(k + 1, nc):
                tau = _seqdot(A[:, k:, k], A[:, k:, j]) / A1[:, k]
                A[:, k:, j] = A[:, k:, j] - tau[:, None] * A[:, k:, k]
        for j in range(nc):
            tau = _seqdot(A[:, j:, j], b[:, j:]) / A1[:, j]
            b[:, j:] = b[:, j:] - tau[:, None] * A[:, j:, j]
        x = np.zeros((B, nc))
        x[:, nc - 1] = b[:, nc - 1] / A2[:, nc - 1]
        for i in range(nc - 2, -1, -1):
            x[:, i] = (b[:, i] - _seqdot(A[:, i, i + 1:], x[:, i + 1:])) / A2[:, i]
    return np.where(ok[:, None], x, X)


def _dot3(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


_EPNP_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))
# The columns of L_6x10 each beta approximation solves for.
_EPNP_APPROX = ((0, 1, 3, 6), (0, 1, 2), (0, 1, 2, 3, 4))


def _epnp(pws, us, K):
    """OpenCV's epnp::compute_pose on a batch, op for op: world points
    pws [B, n, 3], pixels us [B, n, 2] -> (R [B, 3, 3], t [B, 3]). Control
    points by PCA, barycentric coordinates, the null space of M^T M, three
    approximations of the betas each polished by five Gauss-Newton steps,
    and the pose of least mean reprojection error."""
    fu, fv, uc, vc = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    B, n, _ = pws.shape
    with np.errstate(all="ignore"):
        c0 = (np.cumsum(pws, axis=1)[:, -1] + 0.0) / n
        dc, uct, _ = jacobi_svd(np.swapaxes(mul_transposed(pws - c0[:, None]),
                                            1, 2))
        cws = np.concatenate(
            [c0[:, None], c0[:, None] + np.sqrt(dc / n)[..., None] * uct], 1)
        ci = svd_invert(np.swapaxes(cws[:, 1:] - cws[:, :1], 1, 2))
        d = pws - cws[:, None, 0]
        al = np.zeros((B, n, 4))
        for j in range(3):
            al[..., 1 + j] = _dot3(ci[:, None, j], d)
        al[..., 0] = ((1.0 - al[..., 1]) - al[..., 2]) - al[..., 3]
        M = np.zeros((B, n, 2, 12))
        M[..., 0, 0::3] = al * fu
        M[..., 0, 2::3] = al * (uc - us[..., 0, None])
        M[..., 1, 1::3] = al * fv
        M[..., 1, 2::3] = al * (vc - us[..., 1, None])
        _, ut, _ = jacobi_svd(np.swapaxes(mul_transposed(M.reshape(B, -1, 12)),
                                          1, 2))
        v = ut[:, 11:7:-1].reshape(B, 4, 4, 3)       # rows 11, 10, 9, 8
        dv = np.stack([v[:, :, a] - v[:, :, b] for a, b in _EPNP_PAIRS], 2)
        L = np.zeros((B, 6, 10))
        for col, (i, j) in enumerate(((0, 0), (0, 1), (1, 1), (0, 2), (1, 2),
                                      (2, 2), (0, 3), (1, 3), (2, 3), (3, 3))):
            L[..., col] = _dot3(dv[:, i], dv[:, j]) * (1.0 if i == j else 2.0)
        rho = np.stack([_dot3(cws[:, a] - cws[:, b], cws[:, a] - cws[:, b])
                        for a, b in _EPNP_PAIRS], 1)
        # The three systems at once, each zero-padded to five columns.
        Ls = np.zeros((3, B, 6, 5))
        for k, cols in enumerate(_EPNP_APPROX):
            Ls[k, ..., :len(cols)] = L[:, :, cols]
        sols = svd_solve(Ls.reshape(3 * B, 6, 5),
                         np.tile(rho, (3, 1))).reshape(3, B, 5)
        betas = np.zeros((3, B, 4))
        for k, bb in enumerate(sols):
            neg = bb[:, 0] < 0
            b0 = np.sqrt(np.where(neg, -bb[:, 0], bb[:, 0]))
            if k == 0:
                betas[k, :, 0] = b0
                for q in (1, 2, 3):
                    betas[k, :, q] = np.where(neg, -bb[:, q], bb[:, q]) / b0
                continue
            b2 = np.sqrt(np.where(neg, -bb[:, 2], bb[:, 2]))
            betas[k, :, 1] = np.where(np.where(neg, bb[:, 2] < 0, bb[:, 2] > 0),
                                      b2, 0.0)
            b0 = np.where(bb[:, 1] < 0, -b0, b0)
            betas[k, :, 0] = b0
            if k == 2:
                betas[k, :, 2] = bb[:, 3] / b0
        # gauss_newton, the three approximations at once.
        betas = betas.reshape(3 * B, 4)
        L3, rho3 = np.tile(L, (3, 1, 1)), np.tile(rho, (3, 1))
        x = np.zeros((3 * B, 4))
        for _ in range(5):
            x = _qr_solve(*_gauss_newton_system(L3, rho3, betas), x)
            betas = betas + x
        R, t, err = _epnp_pose(np.tile(ut, (3, 1, 1)), betas,
                               np.tile(al, (3, 1, 1)), np.tile(pws, (3, 1, 1)),
                               np.tile(us, (3, 1, 1)), K)
    R, t, err = R.reshape(3, B, 3, 3), t.reshape(3, B, 3), err.reshape(3, B)
    best = np.where(err[1] < err[0], 1, 0)
    best = np.where(err[2] < err[best, np.arange(B)], 2, best)
    return R[best, np.arange(B)], t[best, np.arange(B)]


def _gauss_newton_system(L, rho, be):
    """epnp::compute_A_and_b_gauss_newton: the Jacobian A [B, 6, 4] and the
    residual b [B, 6] of rho = L (products of the betas)."""
    b0, b1, b2, b3 = (be[:, None, q] for q in range(4))
    l = [L[..., q] for q in range(10)]
    A = np.stack([((2 * l[0] * b0 + l[1] * b1) + l[3] * b2) + l[6] * b3,
                  ((l[1] * b0 + 2 * l[2] * b1) + l[4] * b2) + l[7] * b3,
                  ((l[3] * b0 + l[4] * b1) + 2 * l[5] * b2) + l[8] * b3,
                  ((l[6] * b0 + l[7] * b1) + l[8] * b2) + 2 * l[9] * b3], -1)
    terms = (l[0] * b0 * b0, l[1] * b0 * b1, l[2] * b1 * b1, l[3] * b0 * b2,
             l[4] * b1 * b2, l[5] * b2 * b2, l[6] * b0 * b3, l[7] * b1 * b3,
             l[8] * b2 * b3, l[9] * b3 * b3)
    acc = terms[0]
    for term in terms[1:]:
        acc = acc + term
    return A, rho - acc


def _epnp_pose(ut, betas, al, pws, us, K):
    """epnp::compute_R_and_t: control points in the camera from the betas,
    the sign that puts the first point in front, the absolute orientation
    through jacobi_svd, and the mean reprojection error."""
    fu, fv, uc, vc = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    B, n, _ = pws.shape
    ccs = np.zeros((B, 4, 3))
    for i in range(4):
        ccs = ccs + betas[:, i, None, None] * ut[:, 11 - i].reshape(B, 4, 3)
    pcs = (((al[..., 0, None] * ccs[:, None, 0] + al[..., 1, None] * ccs[:, None, 1])
            + al[..., 2, None] * ccs[:, None, 2]) + al[..., 3, None] * ccs[:, None, 3])
    pcs = np.where((pcs[:, 0, 2] < 0)[:, None, None], -pcs, pcs)
    pc0 = (np.cumsum(pcs, axis=1)[:, -1] + 0.0) / n
    pw0 = (np.cumsum(pws, axis=1)[:, -1] + 0.0) / n
    abt = np.cumsum((pcs - pc0[:, None])[..., :, None]
                    * (pws - pw0[:, None])[..., None, :], axis=1)[:, -1] + 0.0
    _, Ut, Vt = jacobi_svd(np.swapaxes(abt, 1, 2))
    R = (Ut[:, 0, :, None] * Vt[:, 0, None, :] + Ut[:, 1, :, None] * Vt[:, 1, None, :]
         + Ut[:, 2, :, None] * Vt[:, 2, None, :])
    det = (R[:, 0, 0] * R[:, 1, 1] * R[:, 2, 2] + R[:, 0, 1] * R[:, 1, 2] * R[:, 2, 0]
           + R[:, 0, 2] * R[:, 1, 0] * R[:, 2, 1] - R[:, 0, 2] * R[:, 1, 1] * R[:, 2, 0]
           - R[:, 0, 1] * R[:, 1, 0] * R[:, 2, 2] - R[:, 0, 0] * R[:, 1, 2] * R[:, 2, 1])
    R[:, 2] = np.where((det < 0)[:, None], -R[:, 2], R[:, 2])
    t = pc0 - _dot3(R, pw0[:, None, :])
    Xc = _dot3(R[:, None, 0], pws) + t[:, None, 0]
    Yc = _dot3(R[:, None, 1], pws) + t[:, None, 1]
    inv_z = 1.0 / (_dot3(R[:, None, 2], pws) + t[:, None, 2])
    du = us[..., 0] - (uc + fu * Xc * inv_z)
    dv = us[..., 1] - (vc + fv * Yc * inv_z)
    err = (np.cumsum(np.sqrt(du * du + dv * dv), axis=1)[:, -1] + 0.0) / n
    return R, t, err


def _epnp_models(obj32, img32, K):
    """solvePnP(..., SOLVEPNP_EPNP) on float32 points [B, k, 3], [B, k, 2]:
    the pixels undistorted to float32 normalized coordinates, which EPnP
    maps back through K. -> (rvecs [B, 3], tvecs [B, 3])."""
    px = img32.astype(np.float64)
    xn = ((px[..., 0] - K[0, 2]) * (1.0 / K[0, 0])).astype(np.float32)
    yn = ((px[..., 1] - K[1, 2]) * (1.0 / K[1, 1])).astype(np.float32)
    us = np.stack([xn.astype(np.float64) * K[0, 0] + K[0, 2],
                   yn.astype(np.float64) * K[1, 1] + K[1, 2]], -1)
    R, t = _epnp(obj32.astype(np.float64), us, K)
    return _rodrigues_inverse(R), t


def _pnp_errors(obj, img32, rvecs, tvecs, K):
    """PnPRansacCallback::computeError for a batch of models: each point
    projected to float32, its squared distance to the float32 pixel summed
    in float32 -> [B, N]."""
    R, _ = _rodrigues(rvecs)
    with np.errstate(all="ignore"):
        d = img32[None] - _project(obj, R, tvecs, K).astype(np.float32)
        return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]


def _pnp_residual(obj, img, K, x, jacobian):
    """findExtrinsicCameraParams2's callback: projections minus pixels
    [2N] at x = (rvec, tvec), and their derivative [2N, 6]."""
    R, dRdr = _rodrigues(x[None, :3])
    out = _project(obj, R, x[None, 3:], K, dRdr if jacobian else None)
    if not jacobian:
        return (out[0] - img).reshape(-1), None
    return (out[0][0] - img).reshape(-1), out[1][0].reshape(-1, 6)


LM_MAX_ITERS = 20      # findExtrinsicCameraParams2's
LM_GEO_STEP = 1e-4     # cv::LevMarq::Settings' defaults from here on
LM_GEO_SCALE = 0.5
LM_TOLERANCE = 1e-6    # step norm^2, relative energy change, gradient
LM_LAMBDA = 1e-4
LM_UP, LM_DOWN = 2.0, 3.0
LM_DIAG_CLAMP = (1e-6, 1e32)


def _levmarq(obj, img, K, rvec, tvec):
    """solvePnP(..., useExtrinsicGuess=true, SOLVEPNP_ITERATIVE): OpenCV
    5.0's cv::LevMarq on (rvec, tvec) from the guess, as
    findExtrinsicCameraParams2 sets it up (20 iterations, geodesic
    acceleration) over points obj [N, 3] and pixels img [N, 2], energy the
    squared pixel error. Each iteration solves (J^T J + D) x = -J^T e by
    SVD, D its diagonal times lambda clamped to [1e-6, 1e32]; adds half the
    geodesic correction, the second derivative along x by a difference
    with step 1e-4 (when it is shorter than x); keeps the step if the
    energy did not grow, then scaling lambda by max(1/3, 1 - (2 q - 1)^3)
    for the step's quality q, else multiplying it by a factor that doubles
    each time. It stops after 20 iterations, at lambda 1e32, or when the
    step's squared norm, the gradient or the relative energy change falls
    under 1e-6. -> (rvec [3], tvec [3])."""
    h = LM_GEO_STEP
    x = np.concatenate([np.ravel(rvec), np.ravel(tvec)]).astype(np.float64)
    err, J = _pnp_residual(obj, img, K, x, True)
    energy = norm_l2sqr(err)
    up, lam = LM_UP, LM_LAMBDA
    fresh = True
    for _ in range(LM_MAX_ITERS):
        if fresh:
            jtj, jtb = mul_transposed(J), gemm_at_b(J, err)
            diag, max_grad = np.diag(jtj).copy(), np.abs(jtb).max()
            fresh = False
        lm_diag = np.minimum(np.maximum(lam * diag, LM_DIAG_CLAMP[0]),
                             LM_DIAG_CLAMP[1])
        A = jtj.copy()
        A[np.diag_indices(6)] = diag + lm_diag
        # cv::solve decomposes A again for the second system: the same SVD.
        svd = jacobi_svd(A.T[None], False)
        step = _back_substitute(*svd, -jtb[None])[0]
        predicted = _seqdot(step, jtb - lm_diag * step)
        step_norm = norm_l2sqr(step)
        # Geodesic acceleration, with OpenCV's own terms and rounding.
        geo_err, _ = _pnp_residual(obj, img, K, x + step * h, False)
        inner = fma(jtb, h - 1.0, gemm_at_b(J, geo_err))
        scale = 1.0 / (h * h)
        rhs = fma(inner, scale, (h * lm_diag) * step * scale)
        geo = _back_substitute(*svd, -rhs[None])[0]
        with np.errstate(divide="ignore", invalid="ignore"):
            if np.sqrt(np.dot(geo, geo) / np.dot(step, step)) < 1.0:
                step = step + geo * LM_GEO_SCALE
        probe = x + step
        new_err, _ = _pnp_residual(obj, img, K, probe, False)
        new_energy = norm_l2sqr(new_err)
        if not new_energy >= 0:       # OpenCV gives up on a bad energy
            break
        delta = energy - new_energy
        if delta < 0:
            lam *= up
            up *= 2.0
            if not lam < LM_DIAG_CLAMP[1]:
                break
            continue
        with np.errstate(divide="ignore", invalid="ignore"):
            quality = np.float64(delta) / (-0.5 * predicted)
            rel = np.float64(delta) / new_energy
        shrink = 1.0 - math.pow(2.0 * quality - 1.0, 3.0)
        lam *= shrink if shrink > 1.0 / LM_DOWN else 1.0 / LM_DOWN
        up = LM_UP
        x, energy = probe, new_energy
        if (not lam < LM_DIAG_CLAMP[1] or max_grad < LM_TOLERANCE
                or step_norm < LM_TOLERANCE or rel < LM_TOLERANCE):
            break
        err, J = _pnp_residual(obj, img, K, x, True)
        fresh = True
    return x[:3], x[3:]


def solve_pnp_ransac(obj, img, K, rvec0=None, tvec0=None,
                     use_guess: bool = False, reproj_err: float = 8.0,
                     iters: int = 100):
    """Camera pose from 3D-2D correspondences with outliers, as
    cv2.solvePnPRansac(obj, img, K, None, [rvec0, tvec0, use_guess],
    reprojectionError=reproj_err, iterationsCount=iters,
    flags=SOLVEPNP_ITERATIVE) computes it in OpenCV 5.0, bit for bit on
    the CPU: RANSAC over EPnP on five-point samples (ransac, _epnp), the
    winner's inliers refined by _levmarq from the guess (with use_guess)
    or from the winning model; the guess seeds nothing else. Five points
    go to EPnP alone; fewer (OpenCV solves four by P3P) fail here. Returns
    (ok, rvec [3, 1], tvec [3, 1], inliers [M, 1] int32 or None); where it
    fails, the guess (or zeros) and None."""
    obj32 = np.asarray(obj, np.float64).reshape(-1, 3).astype(np.float32)
    img32 = np.asarray(img, np.float64).reshape(-1, 2).astype(np.float32)
    K = np.asarray(K, np.float64)
    n = len(obj32)
    guess = use_guess and rvec0 is not None and tvec0 is not None
    r0 = np.asarray(rvec0, np.float64).reshape(3) if guess else np.zeros(3)
    t0 = np.asarray(tvec0, np.float64).reshape(3) if guess else np.zeros(3)
    fail = (False, r0.reshape(3, 1).copy(), t0.reshape(3, 1).copy(), None)
    if n < PNP_SAMPLE:
        return fail
    if n == PNP_SAMPLE:
        rv, tv = _epnp_models(obj32[None], img32[None], K)
        return (True, rv[0].reshape(3, 1), tv[0].reshape(3, 1),
                np.arange(n, dtype=np.int32).reshape(-1, 1))
    obj64 = obj32.astype(np.float64)

    def kernel(subsets):
        rv, tv = _epnp_models(obj32[subsets], img32[subsets], K)
        return np.concatenate([rv, tv], 1), np.arange(len(subsets))

    def errors(models):
        return _pnp_errors(obj64, img32, models[:, :3], models[:, 3:], K)

    model, mask = ransac(n, PNP_SAMPLE, kernel, errors,
                         float(np.float32(reproj_err)), PNP_CONFIDENCE, iters)
    if model is None:
        return fail
    start = (r0, t0) if guess else (model[:3], model[3:])
    r, t = _levmarq(obj64[mask], img32[mask].astype(np.float64), K, *start)
    return (True, r.reshape(3, 1), t.reshape(3, 1),
            np.nonzero(mask)[0].astype(np.int32).reshape(-1, 1))


# ---------------------------------------------------------------------------
# Stereo rectification (cv2.stereoRectify, initUndistortRectifyMap, remap)
# ---------------------------------------------------------------------------

def _brown_conrady(dist) -> "Camera":
    """A pinhole camera holding radial-tangential coefficients (k1 k2 p1
    p2 [k3]), for its _distort_normalized."""
    from photo_slam_tpu_torch.models.camera import PINHOLE, Camera

    d = np.zeros(5)
    coeffs = np.asarray(dist, np.float64).reshape(-1)[:5]
    d[:len(coeffs)] = coeffs
    return Camera(camera_id=0, model_id=PINHOLE, width=1, height=1, fx=1.0,
                  fy=1.0, cx=0.0, cy=0.0, dist_coeffs=d)


def undistort_points(px, K, dist, R=None, P=None,
                     iters: int = 5) -> np.ndarray:
    """cv2.undistortPoints: pixels [N, 2] -> ideal points [N, 2], normalized
    or, with P, in P's pixels after the rotation R. The distortion is
    inverted by OpenCV's fixed-point iteration, stopped after `iters` (5,
    its default) as OpenCV stops it."""
    px = np.asarray(px, np.float64).reshape(-1, 2)
    d = _brown_conrady(dist).dist_coeffs
    k1, k2, p1, p2, k3 = d
    x0 = (px[:, 0] - K[0, 2]) / K[0, 0]
    y0 = (px[:, 1] - K[1, 2]) / K[1, 1]
    x, y = x0.copy(), y0.copy()
    if np.any(d != 0):
        for _ in range(iters):
            r2 = x * x + y * y
            icdist = 1.0 / (1 + ((k3 * r2 + k2) * r2 + k1) * r2)
            dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
            dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
            x, y = (x0 - dx) * icdist, (y0 - dy) * icdist
    RR = np.eye(3) if R is None else np.asarray(R, np.float64)
    if P is not None:
        RR = np.asarray(P, np.float64)[:3, :3] @ RR
    w = 1.0 / (RR[2, 0] * x + RR[2, 1] * y + RR[2, 2])
    return np.stack([(RR[0, 0] * x + RR[0, 1] * y + RR[0, 2]) * w,
                     (RR[1, 0] * x + RR[1, 1] * y + RR[1, 2]) * w], 1)


def _inner_outer(K, dist, R, P, size):
    """The rectangles inside and around a 9 x 9 grid over the image's
    pixel centres (0 to w - 1, 0 to h - 1) mapped through undistortion, R
    and P (OpenCV's getUndistortRectangles, in float64)."""
    w, h = size
    g = np.arange(9, dtype=np.float64) / 8
    gx, gy = np.meshgrid(g * (w - 1), g * (h - 1))
    u = undistort_points(np.stack([gx.ravel(), gy.ravel()], 1), K, dist, R,
                         P).reshape(9, 9, 2)
    inner = (u[:, 0, 0].max(), u[0, :, 1].max(), u[:, 8, 0].min(),
             u[8, :, 1].min())
    outer = (u[..., 0].min(), u[..., 1].min(), u[..., 0].max(),
             u[..., 1].max())
    return inner, outer


def stereo_rectify(K0, D0, K1, D1, size, R, T):
    """cv2.stereoRectify(K0, D0, K1, D1, size, R, T,
    flags=CALIB_ZERO_DISPARITY, alpha=0)[:4]: the rotations R1, R2 that
    make the two views' rows epipolar lines (half of R each, then the
    baseline onto x) and the projections P1, P2 [3, 4] with one focal
    length and one principal point, scaled so that every rectified pixel
    of both views comes from inside its image (alpha 0)."""
    K0, K1 = np.asarray(K0, np.float64), np.asarray(K1, np.float64)
    R = np.asarray(R, np.float64)
    T = np.asarray(T, np.float64).reshape(3)
    w, h = size
    r_half = rodrigues(rodrigues_inverse(R).reshape(3) * -0.5)
    t = r_half @ T
    idx = 0 if abs(t[0]) > abs(t[1]) else 1
    c, nt = t[idx], np.linalg.norm(t)
    uu = np.zeros(3)
    uu[idx] = 1.0 if c > 0 else -1.0
    ww = np.cross(t, uu)
    nw = np.linalg.norm(ww)
    if nw > 0:
        ww *= np.arccos(abs(c) / nt) / nw
    wR = rodrigues(ww)
    R1 = wR @ r_half.T
    R2 = wR @ r_half
    t = R2 @ T
    fc = (K0[idx ^ 1, idx ^ 1] + K1[idx ^ 1, idx ^ 1]) * 0.5
    corners = np.array([[0, 0], [w - 1, 0], [0, h - 1], [w - 1, h - 1]],
                       np.float32)
    cc = []
    for K, D, Rk in ((K0, D0, R1), (K1, D1, R2)):
        n = undistort_points(corners, K, D).astype(np.float32)
        X = np.concatenate([n, np.ones((4, 1), np.float32)], 1).astype(
            np.float64) @ rodrigues(rodrigues_inverse(Rk)).T
        proj = (fc * X[:, :2] / X[:, 2:]).astype(np.float32)
        avg = proj.astype(np.float64).mean(0)
        cc.append(((w - 1) / 2 - avg[0], (h - 1) / 2 - avg[1]))
    cx = (cc[0][0] + cc[1][0]) * 0.5
    cy = (cc[0][1] + cc[1][1]) * 0.5
    P1 = np.array([[fc, 0, cx, 0], [0, fc, cy, 0], [0, 0, 1, 0]])
    P2 = P1.copy()
    P2[idx, 3] = t[idx] * fc
    s = 0.0
    for K, D, Rk, P in ((K0, D0, R1, P1), (K1, D1, R2, P2)):
        (ix0, iy0, ix1, iy1), _ = _inner_outer(K, D, Rk, P, size)
        s = max(s, cx / (cx - ix0), cy / (cy - iy0),
                (w - 1 - cx) / (ix1 - cx), (h - 1 - cy) / (iy1 - cy))
    for P in (P1, P2):
        P[0, 0] = P[1, 1] = fc * s
    P2[idx, 3] *= s
    return R1, R2, P1, P2


def init_undistort_rectify_map(K, dist, R, P, size):
    """cv2.initUndistortRectifyMap(K, dist, R, P, size, CV_32FC1): for each
    rectified pixel, the source pixel (map_x, map_y) [h, w] float32 in the
    distorted image (radial-tangential)."""
    w, h = size
    iR = np.linalg.inv(np.asarray(P, np.float64)[:3, :3]
                       @ np.asarray(R, np.float64))
    v, u = np.mgrid[0:h, 0:w].astype(np.float64)
    X = iR[0, 0] * u + iR[0, 1] * v + iR[0, 2]
    Y = iR[1, 0] * u + iR[1, 1] * v + iR[1, 2]
    Wt = iR[2, 0] * u + iR[2, 1] * v + iR[2, 2]
    xd, yd = _brown_conrady(dist)._distort_normalized(X / Wt, Y / Wt)
    K = np.asarray(K, np.float64)
    return ((K[0, 0] * xd + K[0, 2]).astype(np.float32),
            (K[1, 1] * yd + K[1, 2]).astype(np.float32))


def remap_linear(img: np.ndarray, map_x: np.ndarray,
                 map_y: np.ndarray) -> np.ndarray:
    """cv2.remap(img, map_x, map_y, INTER_LINEAR) of a float32 [H, W] or
    [H, W, C] image with float32 maps, border constant 0: the bilinear
    blend of the four neighbours of each source position (OpenCV 5 blends
    float images at the maps' exact positions; earlier versions rounded
    them to 1/32 px), a neighbour outside the image counting as 0."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    mx = np.asarray(map_x, np.float64)
    my = np.asarray(map_y, np.float64)
    x0, y0 = np.floor(mx).astype(np.int64), np.floor(my).astype(np.int64)
    fx, fy = mx - x0, my - y0
    weights = ((1 - fy) * (1 - fx), (1 - fy) * fx, fy * (1 - fx), fy * fx)
    out = 0.0
    for (dy, dx), wt in zip(((0, 0), (0, 1), (1, 0), (1, 1)), weights):
        yy, xx = y0 + dy, x0 + dx
        inside = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        v = img[yy.clip(0, h - 1), xx.clip(0, w - 1)]
        if img.ndim == 3:
            inside, wt = inside[..., None], wt[..., None]
        out = out + np.where(inside, v, 0.0) * wt
    return np.asarray(out, np.float32)


# ---------------------------------------------------------------------------
# ORB (cv2.ORB_create's defaults)
# ---------------------------------------------------------------------------

ORB_LEVELS = 8
ORB_SCALE = np.float32(1.2)  # ORB::create's float scaleFactor, 1.2f
EDGE_THRESHOLD = 31          # keypoints at least this far from a level's edge
PATCH_SIZE = 31
FAST_THRESHOLD = 20
HARRIS_BLOCK = 7
HARRIS_K = 0.04
# The descriptors' level blur: GaussianBlur(level, (7, 7), 2, 2,
# BORDER_REFLECT_101), whose taps are getGaussianKernel(7, 2, CV_32F).
BLUR_TAPS = tuple(float(np.float32(t)) for t in (
    0.07015932, 0.13107488, 0.19071282, 0.21610594, 0.19071282, 0.13107488,
    0.07015932))
BLUR_RADIUS = 3

# FAST's Bresenham circle of radius 3, as (dx, dy), in OpenCV's order.
FAST_CIRCLE = ((0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2),
               (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0),
               (-3, 1), (-2, 2), (-1, 3))

# The 256 test pairs (x0, y0, x1, y1) of ORB's steered BRIEF: OpenCV's
# learned table `bit_pattern_31_` (modules/features2d/src/orb.cpp), copied
# as it stands. That file carries this notice:
#
#   Software License Agreement (BSD License)
#
#   Copyright (c) 2009, Willow Garage, Inc.
#   All rights reserved.
#
#   Redistribution and use in source and binary forms, with or without
#   modification, are permitted provided that the following conditions
#   are met:
#
#    * Redistributions of source code must retain the above copyright
#      notice, this list of conditions and the following disclaimer.
#    * Redistributions in binary form must reproduce the above
#      copyright notice, this list of conditions and the following
#      disclaimer in the documentation and/or other materials provided
#      with the distribution.
#    * Neither the name of the Willow Garage nor the names of its
#      contributors may be used to endorse or promote products derived
#      from this software without specific prior written permission.
#
#   THIS SOFTWARE IS PROVIDED BY THE COPYRIGHT HOLDERS AND CONTRIBUTORS
#   "AS IS" AND ANY EXPRESS OR IMPLIED WARRANTIES, INCLUDING, BUT NOT
#   LIMITED TO, THE IMPLIED WARRANTIES OF MERCHANTABILITY AND FITNESS
#   FOR A PARTICULAR PURPOSE ARE DISCLAIMED. IN NO EVENT SHALL THE
#   COPYRIGHT OWNER OR CONTRIBUTORS BE LIABLE FOR ANY DIRECT, INDIRECT,
#   INCIDENTAL, SPECIAL, EXEMPLARY, OR CONSEQUENTIAL DAMAGES (INCLUDING,
#   BUT NOT LIMITED TO, PROCUREMENT OF SUBSTITUTE GOODS OR SERVICES;
#   LOSS OF USE, DATA, OR PROFITS; OR BUSINESS INTERRUPTION) HOWEVER
#   CAUSED AND ON ANY THEORY OF LIABILITY, WHETHER IN CONTRACT, STRICT
#   LIABILITY, OR TORT (INCLUDING NEGLIGENCE OR OTHERWISE) ARISING IN
#   ANY WAY OUT OF THE USE OF THIS SOFTWARE, EVEN IF ADVISED OF THE
#   POSSIBILITY OF SUCH DAMAGE.
#
# OpenCV as a whole is distributed under the Apache License, Version 2.0
# (https://www.apache.org/licenses/LICENSE-2.0), the licence that the
# opencv-python wheel ships for its OpenCV binary; the wheel's own
# LICENSE.txt reads:
#
#   MIT License
#
#   Copyright (c) Olli-Pekka Heinisuo
#
#   Permission is hereby granted, free of charge, to any person obtaining
#   a copy of this software and associated documentation files (the
#   "Software"), to deal in the Software without restriction, including
#   without limitation the rights to use, copy, modify, merge, publish,
#   distribute, sublicense, and/or sell copies of the Software, and to
#   permit persons to whom the Software is furnished to do so, subject to
#   the following conditions:
#
#   The above copyright notice and this permission notice shall be
#   included in all copies or substantial portions of the Software.
#
#   THE SOFTWARE IS PROVIDED "AS IS", WITHOUT WARRANTY OF ANY KIND,
#   EXPRESS OR IMPLIED, INCLUDING BUT NOT LIMITED TO THE WARRANTIES OF
#   MERCHANTABILITY, FITNESS FOR A PARTICULAR PURPOSE AND
#   NONINFRINGEMENT. IN NO EVENT SHALL THE AUTHORS OR COPYRIGHT HOLDERS BE
#   LIABLE FOR ANY CLAIM, DAMAGES OR OTHER LIABILITY, WHETHER IN AN ACTION
#   OF CONTRACT, TORT OR OTHERWISE, ARISING FROM, OUT OF OR IN CONNECTION
#   WITH THE SOFTWARE OR THE USE OR OTHER DEALINGS IN THE SOFTWARE.
ORB_PATTERN = np.array([
    8, -3, 9, 5, 4, 2, 7, -12, -11, 9, -8, 2, 7, -12, 12, -13,
    2, -13, 2, 12, 1, -7, 1, 6, -2, -10, -2, -4, -13, -13, -11, -8,
    -13, -3, -12, -9, 10, 4, 11, 9, -13, -8, -8, -9, -11, 7, -9, 12,
    7, 7, 12, 6, -4, -5, -3, 0, -13, 2, -12, -3, -9, 0, -7, 5,
    12, -6, 12, -1, -3, 6, -2, 12, -6, -13, -4, -8, 11, -13, 12, -8,
    4, 7, 5, 1, 5, -3, 10, -3, 3, -7, 6, 12, -8, -7, -6, -2,
    -2, 11, -1, -10, -13, 12, -8, 10, -7, 3, -5, -3, -4, 2, -3, 7,
    -10, -12, -6, 11, 5, -12, 6, -7, 5, -6, 7, -1, 1, 0, 4, -5,
    9, 11, 11, -13, 4, 7, 4, 12, 2, -1, 4, 4, -4, -12, -2, 7,
    -8, -5, -7, -10, 4, 11, 9, 12, 0, -8, 1, -13, -13, -2, -8, 2,
    -3, -2, -2, 3, -6, 9, -4, -9, 8, 12, 10, 7, 0, 9, 1, 3,
    7, -5, 11, -10, -13, -6, -11, 0, 10, 7, 12, 1, -6, -3, -6, 12,
    10, -9, 12, -4, -13, 8, -8, -12, -13, 0, -8, -4, 3, 3, 7, 8,
    5, 7, 10, -7, -1, 7, 1, -12, 3, -10, 5, 6, 2, -4, 3, -10,
    -13, 0, -13, 5, -13, -7, -12, 12, -13, 3, -11, 8, -7, 12, -4, 7,
    6, -10, 12, 8, -9, -1, -7, -6, -2, -5, 0, 12, -12, 5, -7, 5,
    3, -10, 8, -13, -7, -7, -4, 5, -3, -2, -1, -7, 2, 9, 5, -11,
    -11, -13, -5, -13, -1, 6, 0, -1, 5, -3, 5, 2, -4, -13, -4, 12,
    -9, -6, -9, 6, -12, -10, -8, -4, 10, 2, 12, -3, 7, 12, 12, 12,
    -7, -13, -6, 5, -4, 9, -3, 4, 7, -1, 12, 2, -7, 6, -5, 1,
    -13, 11, -12, 5, -3, 7, -2, -6, 7, -8, 12, -7, -13, -7, -11, -12,
    1, -3, 12, 12, 2, -6, 3, 0, -4, 3, -2, -13, -1, -13, 1, 9,
    7, 1, 8, -6, 1, -1, 3, 12, 9, 1, 12, 6, -1, -9, -1, 3,
    -13, -13, -10, 5, 7, 7, 10, 12, 12, -5, 12, 9, 6, 3, 7, 11,
    5, -13, 6, 10, 2, -12, 2, 3, 3, 8, 4, -6, 2, 6, 12, -13,
    9, -12, 10, 3, -8, 4, -7, 9, -11, 12, -4, -6, 1, 12, 2, -8,
    6, -9, 7, -4, 2, 3, 3, -2, 6, 3, 11, 0, 3, -3, 8, -8,
    7, 8, 9, 3, -11, -5, -6, -4, -10, 11, -5, 10, -5, -8, -3, 12,
    -10, 5, -9, 0, 8, -1, 12, -6, 4, -6, 6, -11, -10, 12, -8, 7,
    4, -2, 6, 7, -2, 0, -2, 12, -5, -8, -5, 2, 7, -6, 10, 12,
    -9, -13, -8, -8, -5, -13, -5, -2, 8, -8, 9, -13, -9, -11, -9, 0,
    1, -8, 1, -2, 7, -4, 9, 1, -2, 1, -1, -4, 11, -6, 12, -11,
    -12, -9, -6, 4, 3, 7, 7, 12, 5, 5, 10, 8, 0, -4, 2, 8,
    -9, 12, -5, -13, 0, 7, 2, 12, -1, 2, 1, 7, 5, 11, 7, -9,
    3, 5, 6, -8, -13, -4, -8, 9, -5, 9, -3, -3, -4, -7, -3, -12,
    6, 5, 8, 0, -7, 6, -6, 12, -13, 6, -5, -2, 1, -10, 3, 10,
    4, 1, 8, -4, -2, -2, 2, -13, 2, -12, 12, 12, -2, -13, 0, -6,
    4, 1, 9, 3, -6, -10, -3, -5, -3, -13, -1, 1, 7, 5, 12, -11,
    4, -2, 5, -7, -13, 9, -9, -5, 7, 1, 8, 6, 7, -8, 7, 6,
    -7, -4, -7, 1, -8, 11, -7, -8, -13, 6, -12, -8, 2, 4, 3, 9,
    10, -5, 12, 3, -6, -5, -6, 7, 8, -3, 9, -8, 2, -12, 2, 8,
    -11, -2, -10, 3, -12, -13, -7, -9, -11, 0, -10, -5, 5, -3, 11, 8,
    -2, -13, -1, 12, -1, -8, 0, 9, -13, -11, -12, -5, -10, -2, -10, 11,
    -3, 9, -2, -13, 2, -3, 3, 2, -9, -13, -4, 0, -4, 6, -3, -10,
    -4, 12, -2, -7, -6, -11, -4, 9, 6, -3, 6, 11, -13, 11, -5, 5,
    11, 11, 12, 6, 7, -5, 12, -2, -1, 12, 0, 7, -4, -8, -3, -2,
    -7, 1, -6, 7, -13, -12, -8, -13, -7, -2, -6, -8, -8, 5, -6, -9,
    -5, -1, -4, 5, -13, 7, -8, 10, 1, 5, 5, -13, 1, 0, 10, -13,
    9, 12, 10, -1, 5, -8, 10, -9, -1, 11, 1, -13, -9, -3, -6, 2,
    -1, -10, 1, 12, -13, 1, -8, -10, 8, -11, 10, -6, 2, -13, 3, -6,
    7, -13, 12, -9, -10, -10, -5, -7, -10, -8, -8, -13, 4, -6, 8, 5,
    3, 12, 8, -13, -4, 2, -3, -3, 5, -13, 10, -12, 4, -13, 5, -1,
    -9, 9, -4, 3, 0, 3, 3, -9, -12, 1, -6, 1, 3, 2, 4, -8,
    -10, -10, -10, 9, 8, -13, 12, 12, -8, -12, -6, -5, 2, 2, 3, 7,
    10, 6, 11, -8, 6, 8, 8, -12, -7, 10, -6, 5, -3, -9, -3, 9,
    -1, -13, -1, 5, -3, -7, -3, 4, -8, -2, -8, 3, 4, 2, 12, 12,
    2, -5, 3, 11, 6, -9, 11, -13, 3, -1, 7, 12, 11, -1, 12, 4,
    -3, 0, -3, 6, 4, -11, 4, 12, 2, -4, 2, 1, -10, -6, -8, 1,
    -13, 7, -11, 1, -13, 12, -11, -13, 6, 0, 11, -13, 0, -1, 1, 4,
    -13, 3, -9, -2, -9, 8, -6, -3, -13, -6, -8, -2, 5, -9, 8, 10,
    2, 7, 3, -9, -1, -6, -1, -1, 9, 5, 11, -2, 11, -3, 12, -8,
    3, 0, 3, 5, -1, 4, 0, 10, 3, -6, 4, 5, -13, 0, -10, 5,
    5, 8, 12, 11, 8, 9, 9, -6, 7, -4, 8, -12, -10, 4, -10, 9,
    7, 3, 12, 4, 9, -7, 10, -2, 7, 0, 12, -2, -1, -6, 0, -11,
], np.int64).reshape(256, 4)


class OrbFeatures(NamedTuple):
    """Keypoints in level-0 pixels [N, 2] float32, descriptors [N, 32]
    uint8 (bit j of byte i is test pair 8i + j), Harris responses [N]
    float32, orientations [N] float32 degrees in [0, 360), pyramid levels
    [N] int32."""

    px: np.ndarray
    desc: np.ndarray
    resp: np.ndarray
    angle: np.ndarray
    level: np.ndarray


def level_budget(nfeatures: int) -> list[int]:
    """Features per level, n (1 - 1/s) / (1 - (1/s)^8) (1/s)^l, the last
    level taking the remainder (float32, as OpenCV computes it)."""
    f32 = np.float32
    factor = f32(1.0 / float(ORB_SCALE))
    per = f32(nfeatures) * (f32(1) - factor) / (
        f32(1) - f32(float(factor) ** ORB_LEVELS))
    out = []
    for _ in range(ORB_LEVELS - 1):
        out.append(int(np.rint(per)))
        per = f32(per * factor)
    out.append(max(nfeatures - sum(out), 0))
    return out


def level_scales() -> np.ndarray:
    """Per-level scale s^l as float32: the power taken in double of the
    float scale factor, as OpenCV's getScale."""
    return np.array([float(ORB_SCALE) ** l for l in range(ORB_LEVELS)],
                    np.float32)


def _patch_mask() -> np.ndarray:
    """The circular patch of radius 15 as OpenCV's ORB walks it (umax per
    row, made symmetric) -> [31, 31] bool."""
    half = PATCH_SIZE // 2
    umax = [0] * (half + 2)
    vmax = int(np.floor(half * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(half * np.sqrt(2.0) / 2))
    for v in range(vmax + 1):
        umax[v] = int(np.rint(np.sqrt(half * half - v * v)))
    v0 = 0
    for v in range(half, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    dv, du = np.mgrid[-half:half + 1, -half:half + 1]
    return np.abs(du) <= np.array(umax[:half + 1])[np.abs(dv)]


@functools.lru_cache(maxsize=8)
def _tables(device: torch.device):
    """The circular patch's (du, dv), the Harris block's (dy, dx) and the
    test points [512, 2] (x, y) as float32 on `device`, uploaded once per
    device."""
    half = PATCH_SIZE // 2
    dv, du = np.nonzero(_patch_mask())
    r = HARRIS_BLOCK // 2
    hy, hx = np.mgrid[-r:r + 1, -r:r + 1]
    return tuple(torch.from_numpy(x).to(device) for x in (
        (du - half).astype(np.int64), (dv - half).astype(np.int64),
        hy.ravel().astype(np.int64), hx.ravel().astype(np.int64),
        ORB_PATTERN.reshape(512, 2).astype(np.float32)))


@functools.lru_cache(maxsize=64)
def _resize_coeffs(src: int, dst: int, device: torch.device):
    """Bilinear taps and 8-bit fixed-point weights for src -> dst pixels
    (pixel centres aligned, as OpenCV's INTER_LINEAR_EXACT), on
    `device`."""
    f = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    i0 = np.floor(f).astype(np.int64)
    w1 = np.rint((f - i0) * 256).astype(np.int64)
    return tuple(torch.from_numpy(x).to(device) for x in (
        np.clip(i0, 0, src - 1), np.clip(i0 + 1, 0, src - 1), 256 - w1, w1))


def _resize(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Integer bilinear downscale of an int32 [H, W] image."""
    x0, x1, wx0, wx1 = _resize_coeffs(img.shape[1], w, img.device)
    y0, y1, wy0, wy1 = _resize_coeffs(img.shape[0], h, img.device)
    rows = img[:, x0] * wx0 + img[:, x1] * wx1                  # [H, w]
    out = rows[y0] * wy0[:, None] + rows[y1] * wy1[:, None]
    return (out + (1 << 15)) >> 16


def pyramid(gray: torch.Tensor) -> list[torch.Tensor]:
    """The ORB pyramid of an int32 [H, W] image: level l is
    cvRound(size / s^l) in float32, each resized from the one above."""
    H, W = gray.shape
    levels = [gray]
    for s in level_scales()[1:]:
        h = int(np.rint(np.float32(H) / s))
        w = int(np.rint(np.float32(W) / s))
        levels.append(_resize(levels[-1], h, w))
    return levels


def fast_scores(img: torch.Tensor, threshold: int = FAST_THRESHOLD):
    """FAST-9 on an int32 [H, W] image with 3x3 non-max suppression ->
    [H, W] int32 scores, 0 where there is no corner. The score is OpenCV's:
    the largest t such that 9 contiguous circle pixels are all brighter
    than centre + t, or all darker than centre - t, less one."""
    H, W = img.shape
    c = img[3:H - 3, 3:W - 3].to(torch.int16)
    d = torch.stack([c - img[3 + dy:H - 3 + dy, 3 + dx:W - 3 + dx].to(
        torch.int16) for dx, dy in FAST_CIRCLE])                # [16, h, w]
    d = torch.cat([d, d[:8]])                                    # circular

    def arc9(x, op):
        # op over 9 contiguous entries, for the 16 starting positions.
        m2 = op(x[:-1], x[1:])                                   # 23
        m4 = op(m2[:-2], m2[2:])                                 # 21
        m8 = op(m4[:-4], m4[4:])                                 # 17
        return op(m8[:16], x[8:24])

    darker = arc9(d, torch.minimum).amax(0)      # centre brighter by >= t
    brighter = (-arc9(d, torch.maximum)).amax(0)
    best = torch.maximum(darker, brighter).to(torch.int32)
    score = torch.where(best > threshold, best - 1, 0)
    score = torch.nn.functional.pad(score, (3, 3, 3, 3))
    # Non-max suppression: strictly above all 8 neighbours.
    p = torch.nn.functional.pad(score, (1, 1, 1, 1))
    keep = score > 0
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                keep &= score > p[1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
    return torch.where(keep, score, 0)


def retain_best(response, k: int) -> np.ndarray:
    """OpenCV's KeyPointsFilter::retainBest on float32 responses in input
    order -> the int64 indices it keeps, in the order it leaves them: the
    k best (ties with the k-th kept) as std::nth_element and
    std::partition arrange them. Computed by csrc_host/retain_best.cpp,
    which calls libstdc++'s own algorithms, built by native.py."""
    resp = np.ascontiguousarray(response, np.float32).reshape(-1)
    out = np.empty(len(resp), np.int32)
    lib = native._lib("retain_best")
    native.calls["retain_best"] += 1
    count = lib.retain_best(resp, len(resp), int(k), out)
    return out[:count].astype(np.int64)


def retain_best_plain(response, k: int) -> np.ndarray:
    """retain_best in Python, the plain twin that tests hold the shim
    against: libstdc++'s std::nth_element at k - 1 by response greater
    (nth_element_plain), then std::__partition (bidirectional) of the rest
    by response at least the k-th's, transcribed step for step."""
    r = np.asarray(response, np.float32).reshape(-1).tolist()
    n = len(r)
    if k < 0 or n <= k:
        return np.arange(n, dtype=np.int64)
    if k == 0:
        return np.zeros(0, np.int64)
    a = list(range(n))      # the records, by input index
    nth_element_plain(a, k - 1, lambda x, y: r[x] > r[y])
    v = r[a[k - 1]]
    first, last = k, n
    while True:
        while first != last and r[a[first]] >= v:
            first += 1
        if first == last:
            break
        last -= 1
        while first != last and not r[a[last]] >= v:
            last -= 1
        if first == last:
            break
        a[first], a[last] = a[last], a[first]
        first += 1
    return np.array(a[:first], np.int64)


def nth_element_plain(a: list, nth: int, comp) -> bool:
    """libstdc++'s std::nth_element(a, a + nth, a + len(a), comp) on the
    list `a` in place, transcribed step for step: std::__introselect with
    the depth limit 2 lg n, the median of three moved to the front, the
    unguarded partition, std::__heap_select when the depth runs out and
    std::__insertion_sort once 3 or fewer are left. Returns whether the
    depth ran out."""

    def swap(i, j):
        a[i], a[j] = a[j], a[i]

    def adjust_heap(first, hole, length, value):
        top = second = hole
        while second < (length - 1) // 2:
            second = 2 * (second + 1)
            if comp(a[first + second], a[first + second - 1]):
                second -= 1
            a[first + hole] = a[first + second]
            hole = second
        if length % 2 == 0 and second == (length - 2) // 2:
            second = 2 * (second + 1)
            a[first + hole] = a[first + second - 1]
            hole = second - 1
        parent = (hole - 1) // 2           # std::__push_heap
        while hole > top and comp(a[first + parent], value):
            a[first + hole] = a[first + parent]
            hole = parent
            parent = (hole - 1) // 2
        a[first + hole] = value

    def median_to_first(result, x, y, z):
        if comp(a[x], a[y]):
            if comp(a[y], a[z]):
                swap(result, y)
            elif comp(a[x], a[z]):
                swap(result, z)
            else:
                swap(result, x)
        elif comp(a[x], a[z]):
            swap(result, x)
        elif comp(a[y], a[z]):
            swap(result, z)
        else:
            swap(result, y)

    def unguarded_partition(first, last, pivot):
        while True:
            while comp(a[first], a[pivot]):
                first += 1
            last -= 1
            while comp(a[pivot], a[last]):
                last -= 1
            if not first < last:
                return first
            swap(first, last)
            first += 1

    first, last = 0, len(a)
    if first == last or nth == last:
        return False
    depth = 2 * (last.bit_length() - 1)
    while last - first > 3:
        if depth == 0:
            middle = nth + 1               # std::__heap_select
            length = middle - first
            for parent in range((length - 2) // 2, -1, -1):
                adjust_heap(first, parent, length, a[first + parent])
            for i in range(middle, last):
                if comp(a[i], a[first]):
                    value = a[i]
                    a[i] = a[first]
                    adjust_heap(first, 0, length, value)
            swap(first, nth)
            return True
        depth -= 1
        median_to_first(first, first + 1, first + (last - first) // 2,
                        last - 1)
        cut = unguarded_partition(first + 1, last, first)
        if cut <= nth:
            first = cut
        else:
            last = cut
    for i in range(first + 1, last):       # std::__insertion_sort
        val = a[i]
        if comp(val, a[first]):
            a[first + 1:i + 1] = a[first:i]
            a[first] = val
            continue
        j = i
        while comp(val, a[j - 1]):
            a[j] = a[j - 1]
            j -= 1
        a[j] = val
    return False


def _window_sums(img, ys, xs, dys, dxs):
    """img at (ys + dys, xs + dxs) for every keypoint and offset -> [N, M]
    (int64)."""
    W = img.shape[1]
    flat = (ys[:, None] + dys[None]) * W + (xs[:, None] + dxs[None])
    return img.reshape(-1)[flat].to(torch.int64)


def harris_sums(img, ys, xs):
    """OpenCV's Harris sums over the 7x7 block around each keypoint: a =
    sum Ix^2, b = sum Iy^2, c = sum Ix Iy with 3x3 Sobel gradients ->
    three [N] int64 tensors."""
    i = img
    ix = torch.zeros_like(i)
    iy = torch.zeros_like(i)
    ix[1:-1, 1:-1] = ((i[1:-1, 2:] - i[1:-1, :-2]) * 2
                      + (i[:-2, 2:] - i[:-2, :-2]) + (i[2:, 2:] - i[2:, :-2]))
    iy[1:-1, 1:-1] = ((i[2:, 1:-1] - i[:-2, 1:-1]) * 2
                      + (i[2:, :-2] - i[:-2, :-2]) + (i[2:, 2:] - i[:-2, 2:]))
    _, _, dys, dxs, _ = _tables(img.device)
    gx = _window_sums(ix, ys, xs, dys, dxs)
    gy = _window_sums(iy, ys, xs, dys, dxs)
    return (gx * gx).sum(1), (gy * gy).sum(1), (gx * gy).sum(1)


def harris_response(a, b, c) -> torch.Tensor:
    """OpenCV's float32 Harris response from the integer sums, each
    product and sum rounded in float32 in HarrisResponses' order."""
    f32 = np.float32
    scale = f32(1.0) / f32((1 << 2) * HARRIS_BLOCK * 255.0)
    s4 = float(scale * scale * scale * scale)
    a, b, c = (x.to(torch.float32) for x in (a, b, c))
    ab = a + b
    k_ab = float(f32(HARRIS_K)) * ab
    return (a * b - c * c - k_ab * ab) * s4


# OpenCV's fastAtan2: a degree-7 odd polynomial in float32 of the smaller
# over the larger coordinate, its coefficients rounded to float32 and each
# scaled by (float)(180 / pi) in float32; +DBL_EPSILON (as float) keeps
# 0 / 0 finite.
_ATAN_COEFFS = tuple(
    float(np.float32(c) * np.float32(180.0 / np.pi)) for c in (
        0.9997878412794807, -0.3258083974640975, 0.1555786518463281,
        -0.04432655554792128))
_ATAN_EPS = float(np.float32(np.finfo(np.float64).eps))


def fast_atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """cv::fastAtan2(y, x) on float32 tensors, bit for bit: degrees in
    [0, 360), each operation one float32 op (no fused multiply-add, as
    OpenCV's baseline build evaluates it)."""
    p1, p3, p5, p7 = _ATAN_COEFFS
    ax, ay = x.abs(), y.abs()
    wide = ax >= ay
    c = torch.where(wide, ay, ax) / (torch.where(wide, ax, ay) + _ATAN_EPS)
    c2 = c * c
    a = (((c2 * p7 + p5) * c2 + p3) * c2 + p1) * c
    a = torch.where(wide, a, 90.0 - a)
    a = torch.where(x < 0, 180.0 - a, a)
    return torch.where(y < 0, 360.0 - a, a)


# sin and cos in double for |r| <= pi/4 (fdlibm's __kernel_sin and
# __kernel_cos, under 1 ulp), after a Cody-Waite reduction by pi/2: the
# first 33 bits of pi/2 and the next 53.
_SIN_COEFFS = (-1.66666666666666324348e-01, 8.33333333332248946124e-03,
               -1.98412698298579493134e-04, 2.75573137070700676789e-06,
               -2.50507602534068634195e-08, 1.58969099521155010221e-10)
_COS_COEFFS = (4.16666666666666019037e-02, -1.38888888888741095749e-03,
               2.48015872894767294178e-05, -2.75573143513906633035e-07,
               2.08757232129817482790e-09, -1.13596475577881948265e-11)
_PIO2_HI = 1.57079632673412561417e+00
_PIO2_LO = 6.07710050650619224932e-11
_DEG_TO_RAD = float(np.float32(np.pi / 180.0))


def _horner(z, coeffs):
    out = torch.full_like(z, coeffs[-1])
    for c in coeffs[-2::-1]:
        out = out * z + c
    return out


def orb_steering(angle: torch.Tensor):
    """(cos, sin) as computeOrbDescriptors takes them from a keypoint's
    float32 angle in degrees: the angle times (float)(CV_PI / 180) in
    float32, its cosine and sine in double rounded to float32. The double
    functions are explicit float64 ops (reduction and polynomials), so
    that every device gives the same bits."""
    r = (angle * _DEG_TO_RAD).to(torch.float64)
    q = torch.round(r * (2.0 / np.pi))
    r = (r - q * _PIO2_HI) - q * _PIO2_LO
    z = r * r
    sin = r + z * r * (_SIN_COEFFS[0] + z * _horner(z, _SIN_COEFFS[1:]))
    hz = 0.5 * z
    w = 1.0 - hz
    cos = w + (((1.0 - w) - hz) + z * z * _horner(z, _COS_COEFFS))
    quad = q.to(torch.int64) % 4
    c = torch.where(quad % 2 == 0, cos, sin)
    s = torch.where(quad % 2 == 0, sin, cos)
    c = torch.where((quad == 1) | (quad == 2), -c, c)
    s = torch.where(quad >= 2, -s, s)
    return c.to(torch.float32), s.to(torch.float32)


def _fma32(a: torch.Tensor, b: float, c: torch.Tensor) -> torch.Tensor:
    """a * b + c of float32 tensors rounded once (a fused multiply-add),
    in float64: a * b is exact there, the sum is rounded to odd (its error
    recovered as in _two_sum, the last bit set toward it where the sum was
    inexact and even), and the cast to float32 then rounds as once."""
    p = a.to(torch.float64).mul_(b)
    c = c.to(torch.float64)
    s = p + c
    z = s - p
    err = p.sub_(s - z).add_(c.sub_(z))
    bits = s.view(torch.int64)
    toward = err.sign_().mul_(s.sign()).to(torch.int64)
    bits.add_(toward.mul_((bits & 1).neg_().add_(1)))
    return s.to(torch.float32)


def _reflect_101(n: int, r: int, device) -> torch.Tensor:
    """Indices of 0..n-1 padded by r on each side with BORDER_REFLECT_101
    (gfedcb|abcdefgh|gfedcba)."""
    i = torch.arange(-r, n + r, device=device).abs()
    return torch.where(i > n - 1, 2 * (n - 1) - i, i)


def orb_level_blur(img: torch.Tensor) -> torch.Tensor:
    """The level blur of ORB's descriptors on an int32 [H, W] image ->
    int32 [H, W]: OpenCV's separable float filter on 8-bit input, as its
    vector build computes it. The row pass sums the 7 taps left to right,
    the first product rounded and each further one fused into the sum; the
    column pass starts from the centre row's product and fuses in each
    symmetric pair (the two rows added in float32 first), nearest first;
    then cvRound and saturation to 8 bits. The border is
    BORDER_REFLECT_101: ORB blurs each level in place inside its pyramid
    buffer, whose border copyMakeBorder filled that way."""
    H, W = img.shape
    r = BLUR_RADIUS
    k = BLUR_TAPS
    p = img[_reflect_101(H, r, img.device)][:, _reflect_101(W, r,
                                                            img.device)]
    p = p.to(torch.float64)                                  # [H+6, W+6]
    # Row pass: the exact sum of a float32 partial (>= 2^-4 or 0) and a
    # tap (lsb >= 2^-27) times an 8-bit pixel spans at most 35 bits, so
    # float64 holds it and the cast to float32 is the fused rounding.
    s = (p[:, :W] * k[0]).to(torch.float32)
    for j in range(1, 2 * r + 1):
        s = (p[:, j:j + W] * k[j]).add_(s.to(torch.float64)).to(
            torch.float32)
    t = s[r:r + H] * k[r]
    for j in range(1, r + 1):
        pair = s[r + j:r + j + H] + s[r - j:r - j + H]
        t = _fma32(pair, k[r + j], t)
    return torch.round(t).clamp(0, 255).to(torch.int32)


def orb_descriptors(blurred: torch.Tensor, ys, xs, angle) -> torch.Tensor:
    """The 256 steered tests of each keypoint on its blurred level, as
    computeOrbDescriptors: each test point rotated by the keypoint's
    (cos, sin) with every product and sum in float32, rounded half to
    even (cvRound), and the pixel there compared -> [N, 32] uint8."""
    W = blurred.shape[1]
    pts = _tables(blurred.device)[4]
    a, b = orb_steering(angle)
    a, b = a[:, None], b[:, None]
    px, py = pts[None, :, 0], pts[None, :, 1]
    ix = torch.round(px * a - py * b).to(torch.int64)        # [N, 512]
    iy = torch.round(px * b + py * a).to(torch.int64)
    flat = (ys[:, None] + iy) * W + xs[:, None] + ix
    vals = blurred.reshape(-1)[flat]
    bits = (vals[:, 0::2] < vals[:, 1::2]).to(torch.int32)
    weights = 1 << torch.arange(8, device=blurred.device, dtype=torch.int32)
    return (bits.reshape(-1, 32, 8) * weights).sum(-1).to(torch.uint8)


def orb_detect_and_compute(gray, nfeatures: int, device) -> OrbFeatures:
    """ORB keypoints and descriptors of an 8-bit gray image [H, W] (numpy
    or tensor), computed with torch on `device`: what
    cv2.ORB_create(nfeatures).detectAndCompute(gray, None) returns, the
    same keypoints (level and float32 point), float32 responses and
    angles, and descriptors bit for bit. 8 levels at the float scale 1.2
    with the per-level budget of level_budget; FAST-9 at threshold 20 with
    non-max suppression on each level, keypoints at least 31 pixels from
    its edge; the best 2n per level by FAST score, then the best n by the
    float32 Harris response (k 0.04, 7x7 block), ties at the n-th kept;
    orientation by fastAtan2 of the intensity centroid over the circular
    patch of radius 15; OpenCV's 256 learned tests, steered, on the level
    blurred by orb_level_blur. Points come back in level-0 pixels, level by
    level, each level in OpenCV's order: FAST's raster order as
    retain_best leaves it after the cut to 2n by score and then after the
    cut to n by response. Matching follows that order, and so do the
    samples of the RANSAC loops downstream."""
    device = torch.device(device)
    img = torch.as_tensor(np.asarray(gray, np.uint8)).to(device).to(
        torch.int32)
    du, dv, _, _, _ = _tables(device)
    budget = level_budget(nfeatures)
    scales = level_scales()
    out = {k: [] for k in OrbFeatures._fields}
    for lvl, (im, n) in enumerate(zip(pyramid(img), budget)):
        H, W = im.shape
        if n == 0 or H <= 2 * EDGE_THRESHOLD or W <= 2 * EDGE_THRESHOLD:
            continue
        score = fast_scores(im)
        e = EDGE_THRESHOLD
        inner = torch.zeros_like(score)
        inner[e:H - e, e:W - e] = score[e:H - e, e:W - e]
        ys, xs = torch.nonzero(inner, as_tuple=True)
        if len(ys) == 0:
            continue
        # retainBest's order, as OpenCV leaves it: the FAST corners in
        # raster order (torch.nonzero's) cut to 2n by score, the Harris
        # responses taken in that order and cut to n.
        keep = retain_best(inner[ys, xs].cpu().numpy(), 2 * n)
        keep = torch.from_numpy(keep).to(device)
        ys, xs = ys[keep], xs[keep]
        resp = harris_response(*harris_sums(im, ys, xs))
        keep = torch.from_numpy(retain_best(resp.cpu().numpy(), n))
        keep = keep.to(device)
        ys, xs, resp = ys[keep], xs[keep], resp[keep]
        # Orientation: the intensity centroid over the circular patch.
        patch = _window_sums(im, ys, xs, dv, du)
        m10 = (patch * du).sum(1)
        m01 = (patch * dv).sum(1)
        angle = fast_atan2(m01.to(torch.float32), m10.to(torch.float32))
        desc = orb_descriptors(orb_level_blur(im), ys, xs, angle)
        xs_h, ys_h, resp_h, ang_h, desc_h = (
            t.cpu().numpy() for t in (xs, ys, resp, angle, desc))
        s = scales[lvl]
        out["px"].append(np.stack([xs_h.astype(np.float32) * s,
                                   ys_h.astype(np.float32) * s], 1))
        out["desc"].append(desc_h)
        out["resp"].append(resp_h)
        out["angle"].append(ang_h)
        out["level"].append(np.full(len(xs_h), lvl, np.int32))
    empty = dict(px=np.zeros((0, 2), np.float32),
                 desc=np.zeros((0, 32), np.uint8),
                 resp=np.zeros(0, np.float32),
                 angle=np.zeros(0, np.float32),
                 level=np.zeros(0, np.int32))
    return OrbFeatures(**{k: (np.concatenate(v) if v else empty[k])
                          for k, v in out.items()})
