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
  * triangulate_points: homogeneous DLT through an SVD per point;
  * solve_pnp_ransac: cv2.solvePnPRansac with SOLVEPNP_ITERATIVE, bit for
    bit on the CPU: OpenCV's RANSAC registrator (its own cv::RNG) over
    EPnP on five-point samples, the winner's inliers refined by OpenCV's
    Levenberg-Marquardt from the caller's guess (or the winning model),
    every sum in OpenCV's order (see "OpenCV's own numerics");
  * find_essential_mat / recover_pose: the minimal five-point solver
    (every real solution, the Groebner-basis form of Nister's problem)
    inside RANSAC on OpenCV's scoring (Sampson error, most inliers), the
    winner refit on its inliers; recoverPose's four decompositions through
    OpenCV's own Jacobi SVD (so ties go as OpenCV's do) and the cheirality
    test by triangulation;
  * orb_detect_and_compute: cv2.ORB_create(nfeatures).detectAndCompute,
    in plain torch on a given device, with OpenCV's learned test pairs;
  * stereo_rectify, init_undistort_rectify_map, remap_linear: the EuRoC
    loader's rectification (cv2.stereoRectify with CALIB_ZERO_DISPARITY
    and alpha 0, initUndistortRectifyMap, remap with INTER_LINEAR), with
    undistort_points (cv2.undistortPoints' five fixed-point iterations).

find_essential_mat draws its samples from an np.random.Generator seeded
per call, PnP from OpenCV's cv::RNG, so a run repeats exactly.

ORB returns what OpenCV's does: the same keypoints (level and float32
point), float32 responses and angles, and descriptors bit for bit; only
the order within a level differs (raster order here, std::nth_element's
inside OpenCV). It computes in integers wherever OpenCV does (the
pyramid's fixed-point bilinear, FAST, the Harris sums, the intensity
centroid) and elsewhere follows OpenCV's float32 arithmetic op by op: the
float scale factor 1.2f and its powers, the Harris response, fastAtan2's
polynomial, the level blur's separable float filter with the fused
multiply-adds of OpenCV's vector build (emulated exactly in float64), and
the steering of the 256 learned tests. Each of those is a chain of single
elementwise torch ops, each rounded once as IEEE prescribes, with no op
that could contract a multiply and an add (nor a convolution, whose
summation order a library picks), so the card and the CPU agree bit for
bit.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch


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
# Two-view geometry
# ---------------------------------------------------------------------------

def triangulate_points(P0, P1, p0, p1) -> np.ndarray:
    """Homogeneous DLT triangulation (cv2.triangulatePoints): P0, P1 [3, 4]
    projection matrices, p0, p1 [2, N] pixels -> [4, N] homogeneous
    points, each the right singular vector of its 4x4 system."""
    P0 = np.asarray(P0, np.float64)
    P1 = np.asarray(P1, np.float64)
    p0 = np.asarray(p0, np.float64).reshape(2, -1)
    p1 = np.asarray(p1, np.float64).reshape(2, -1)
    A = np.stack([p0[0][:, None] * P0[2] - P0[0],
                  p0[1][:, None] * P0[2] - P0[1],
                  p1[0][:, None] * P1[2] - P1[0],
                  p1[1][:, None] * P1[2] - P1[1]], 1)      # [N, 4, 4]
    if len(A) == 0:
        return np.zeros((4, 0))
    return np.linalg.svd(A)[2][:, 3, :].T


def _normalized(px, K) -> np.ndarray:
    """Pixels [N, 2] -> normalized image coordinates [N, 2]."""
    px = np.asarray(px, np.float64).reshape(-1, 2)
    return np.stack([(px[:, 0] - K[0, 2]) / K[0, 0],
                     (px[:, 1] - K[1, 2]) / K[1, 1]], 1)


def _eight_point(x0, x1) -> np.ndarray:
    """Essential matrices from normalized correspondences [B, M, 2] (M >= 8),
    Hartley-normalized least squares with the (1, 1, 0) singular values
    enforced -> [B, 3, 3], with x1^T E x0 = 0."""
    def conditioner(x):
        mu = x.mean(1, keepdims=True)
        d = np.sqrt(((x - mu) ** 2).sum(-1)).mean(1)
        s = np.sqrt(2.0) / np.maximum(d, 1e-12)
        T = np.zeros((len(x), 3, 3))
        T[:, 0, 0] = T[:, 1, 1] = s
        T[:, :2, 2] = -s[:, None] * mu[:, 0]
        T[:, 2, 2] = 1.0
        return T

    T0, T1 = conditioner(x0), conditioner(x1)
    h0 = np.concatenate([x0, np.ones(x0.shape[:2] + (1,))], -1) @ \
        T0.transpose(0, 2, 1)
    h1 = np.concatenate([x1, np.ones(x1.shape[:2] + (1,))], -1) @ \
        T1.transpose(0, 2, 1)
    A = (h1[..., :, None] * h0[..., None, :]).reshape(len(x0), -1, 9)
    F = np.linalg.svd(A, full_matrices=A.shape[1] < 9)[2][:, -1].reshape(
        -1, 3, 3)
    U, _, Vt = np.linalg.svd(T1.transpose(0, 2, 1) @ F @ T0)
    return U @ np.diag([1.0, 1.0, 0.0]) @ Vt / np.sqrt(2.0)


def _monomials(degree):
    """Exponents (x, y, z) of the monomials of degree <= `degree`, those of
    the highest degree first, each degree in lexicographic order:
    degree 1 -> x, y, z, 1."""
    out = []
    for d in range(degree, -1, -1):
        out += [(a, b, d - a - b) for a in range(d, -1, -1)
                for b in range(d - a, -1, -1)]
    return out


def _product_table(left, right, out):
    """T [len(left), len(right), len(out)] with T[i, j, k] = 1 where
    monomial left[i] times right[j] is out[k]."""
    index = {m: k for k, m in enumerate(out)}
    T = np.zeros((len(left), len(right), len(out)))
    for i, a in enumerate(left):
        for j, b in enumerate(right):
            T[i, j, index[tuple(p + q for p, q in zip(a, b))]] = 1.0
    return T


_MONO1, _MONO2, _MONO3 = _monomials(1), _monomials(2), _monomials(3)
_MUL11 = _product_table(_MONO1, _MONO1, _MONO2)       # [4, 4, 10]
_MUL21 = _product_table(_MONO2, _MONO1, _MONO3)       # [10, 4, 20]


ESSENTIAL_BATCH = 32  # five-point samples solved and scored at once
_EPIPOLAR_POLISH = 16    # Newton steps on the epipolar equations, at most
_ROOT_TOL = 1e-10        # |x1^T E x0| / (|x0| |x1|) of a root
_SKEW = np.array([[[0.0, 0.0, 0.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0]],
                  [[0.0, 0.0, 1.0], [0.0, 0.0, 0.0], [-1.0, 0.0, 0.0]],
                  [[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 0.0]]])
_SPLIT = 134217729.0                                   # 2^27 + 1
# decomposeEssentialMat's W: R = U W V^T or U W^T V^T, t = U's last column.
_W90 = np.array([[0.0, 1.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
# (coefficient, the cubics x (or y, z) times x^2, xy, xz, y^2, yz, z^2
# are, the basis monomials it times x, y, z, 1 is) of the linear form whose
# action _five_point diagonalizes.
_ACTIONS = ((0.7071, [0, 1, 2, 3, 4, 5], [0, 1, 2, 6]),
            (0.5377, [1, 3, 4, 6, 7, 8], [1, 3, 4, 7]),
            (0.4597, [2, 4, 5, 7, 8, 9], [2, 4, 5, 8]))


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


def _residual(rhs, lead, G):
    """rhs - lead @ G ([B, n, m]) summed as if in twice the working
    precision (Ogita, Rump and Oishi's Dot2)."""
    s, c = rhs, np.zeros_like(rhs)
    for k in range(lead.shape[2]):
        p, e = _two_product(-lead[:, :, k, None], G[:, None, k, :])
        s, e2 = _two_sum(s, p)
        c = c + (e + e2)
    return s + c


def _poly(outer, table):
    """Products of polynomials from their coefficients' outer products
    [..., P, Q] and the product table [P, Q, R] -> [..., R]."""
    return outer.reshape(outer.shape[:-2] + (-1,)) @ table.reshape(
        -1, table.shape[-1])


def _cubics(N):
    """The ten cubic constraints det(E) = 0 and 2 E E^T E - tr(E E^T) E = 0
    on E = x N0 + y N1 + z N2 + N3, for null-space bases N [B, 4, 9]: their
    coefficients [B, 10, 20] over the monomials of _MONO3."""
    B = len(N)
    Ep = N.transpose(0, 2, 1).reshape(B, 3, 3, 4)   # over (x, y, z, 1)
    EEt = _poly(np.einsum("bikp,bjkq->bijpq", Ep, Ep), _MUL11)
    EEtE = _poly(np.einsum("bikq,bkjp->bijqp", EEt, Ep), _MUL21)
    trace = EEt[:, 0, 0] + EEt[:, 1, 1] + EEt[:, 2, 2]
    trE = _poly(trace[:, None, None, :, None] * Ep[..., None, :], _MUL21)
    r1, r2 = Ep[:, 1], Ep[:, 2]
    cof = _poly(r1[:, [1, 2, 0], :, None] * r2[:, [2, 0, 1], None, :]
                - r1[:, [2, 0, 1], :, None] * r2[:, [1, 2, 0], None, :],
                _MUL11)                                         # [B, 3, 10]
    det = _poly(np.einsum("bkq,bkp->bqp", cof, Ep[:, 0]), _MUL21)
    return np.concatenate([det[:, None],
                           (2.0 * EEtE - trE).reshape(B, 9, 20)], 1)


def _action_roots(N):
    """The real roots of _cubics(N) [B, 10, 20]: Gauss-Jordan elimination
    of the ten cubic columns (refined in twice the working precision), the
    action of a generic linear form on the ten remaining monomials (x^2,
    xy, xz, y^2, yz, z^2, x, y, z, 1) as a 10x10 matrix, whose eigenvectors
    give (x, y, z) at each real eigenvalue. -> E [B, 10, 3, 3] (unit
    norm), valid [B, 10]."""
    B = len(N)
    M = _cubics(N)
    lead = M[:, :, :10]
    ok = np.abs(np.linalg.det(lead)) > 0
    lead = np.where(ok[:, None, None], lead, np.eye(10))
    G = np.linalg.solve(lead, M[:, :, 10:])
    G = G + np.linalg.solve(lead, _residual(M[:, :, 10:], lead, G))
    # Each variable times a quadratic is a cubic (-G's rows), times x, y,
    # z or 1 a basis monomial. A generic form keeps apart two solutions
    # that share x.
    act = np.zeros((B, 10, 10))
    for coef, cubics, lower in _ACTIONS:
        act[:, :6] -= coef * G[:, cubics]
        act[:, [6, 7, 8, 9], lower] += coef
    act = np.where(np.isfinite(act), act, 0.0)
    lam, vec = np.linalg.eig(act)                  # [B, 10], [B, 10, 10]
    real = np.abs(lam.imag) <= 1e-8 * np.maximum(1.0, np.abs(lam.real))
    v = vec.real
    w = v[:, 9]
    with np.errstate(divide="ignore", invalid="ignore"):
        xyz = np.stack([v[:, 6] / w, v[:, 7] / w, v[:, 8] / w], -1)
    valid = (ok[:, None] & real & (np.abs(w) > 1e-12 * np.abs(v).max(1))
             & np.isfinite(xyz).all(-1))
    xyz = np.where(valid[..., None], xyz, 0.0)
    E = np.concatenate([xyz, np.ones((B, 10, 1))], -1) @ N
    E /= np.linalg.norm(E, axis=2, keepdims=True)
    return E.reshape(B, 10, 3, 3), valid


def _family_frame(N, h0, h1):
    """Null-space bases N [B, 4, 9] turned so that the last vector is the
    one direction of the null space off the family {[s]x R0} (R0 the
    rotation that best maps the five bearings h0 onto h1), scaled by how
    far the family lies outside the null space. At small parallax every
    solution lies near that family, and the monomials at the roots, taken
    in the standard basis, are nearly dependent: the eigenproblem of
    _action_roots loses them. In this frame it does not."""
    B = len(N)
    f0 = h0 / np.linalg.norm(h0, axis=-1, keepdims=True)
    f1 = h1 / np.linalg.norm(h1, axis=-1, keepdims=True)
    U, _, Vt = np.linalg.svd(f1.transpose(0, 2, 1) @ f0)
    D = np.zeros((B, 3, 3))
    D[:, 0, 0] = D[:, 1, 1] = 1.0
    D[:, 2, 2] = np.sign(np.linalg.det(U @ Vt))
    R0 = U @ D @ Vt
    S = (_SKEW @ R0[:, None]).reshape(B, 3, 9) / np.sqrt(2.0)  # orthonormal
    Uc, cos, _ = np.linalg.svd(N @ S.transpose(0, 2, 1))       # [B, 4, 4]
    off = np.sqrt(np.clip(1.0 - cos ** 2, 0.0, None)).max(1)
    Nf = Uc.transpose(0, 2, 1) @ N
    Nf[:, 3] *= np.clip(off, 1e-6, 1.0)[:, None]
    return Nf


def _batched_rotation(w) -> np.ndarray:
    """Rotation matrices [B, 3, 3] of rotation vectors w [B, 3]."""
    th = np.linalg.norm(w, axis=1)[:, None, None]
    k = np.zeros((len(w), 3, 3))
    k[:, 0, 1], k[:, 0, 2], k[:, 1, 2] = -w[:, 2], w[:, 1], -w[:, 0]
    k = k - k.transpose(0, 2, 1)
    small = th < 1e-8
    ths = np.where(small, 1.0, th)
    a = np.where(small, 1.0, np.sin(ths) / ths)
    b = np.where(small, 0.5, (1 - np.cos(ths)) / ths ** 2)
    return np.eye(3) + a * k + b * (k @ k)


def _epipolar_polish(E, h0, h1):
    """Newton on the five epipolar equations t . (R x0 x x1) = 0 over the
    essential manifold (a rotation increment and t's two tangent
    directions), from each E [K, 3, 3] on its homogeneous correspondences
    h0, h1 [K, 5, 3], each until its step is below 1e-12. This form is far
    better conditioned than the cubics at small parallax. -> ([t]x R
    [K, 3, 3] of unit norm, the largest |x1^T E x0| / (|x0| |x1|) [K])."""
    U, _, Vt = np.linalg.svd(E)
    U = U * np.where(np.linalg.det(U) < 0, -1.0, 1.0)[:, None, None]
    Vt = Vt * np.where(np.linalg.det(Vt) < 0, -1.0, 1.0)[:, None, None]
    R, t = U @ _W90 @ Vt, U[:, :, 2]
    live = np.arange(len(E))
    for _ in range(_EPIPOLAR_POLISH):
        Rl, tl, g0, g1 = R[live], t[live], h0[live], h1[live]
        Rx0 = g0 @ Rl.transpose(0, 2, 1)                         # [L, 5, 3]
        c = np.cross(Rx0, g1)
        axis = np.eye(3)[np.argmin(np.abs(tl), -1)]
        b1 = np.cross(tl, axis)
        b1 /= np.linalg.norm(b1, axis=-1, keepdims=True)
        b2 = np.cross(tl, b1)
        J = np.concatenate([np.cross(Rx0, np.cross(g1, tl[:, None])),
                            c @ b1[..., None], c @ b2[..., None]], -1)
        ok = np.isfinite(J).all((1, 2)) & (np.abs(np.linalg.det(J)) > 0)
        step = np.linalg.solve(np.where(ok[:, None, None], J, np.eye(5)),
                               np.where(ok[:, None, None], c @ tl[..., None],
                                        0.0))[..., 0]           # [L, 5]
        R[live] = _batched_rotation(-step[:, :3]) @ Rl
        tl = tl - step[:, 3:4] * b1 - step[:, 4:5] * b2
        t[live] = tl / np.linalg.norm(tl, axis=-1, keepdims=True)
        live = live[np.abs(step).max(1) > 1e-12]
        if not len(live):
            break
    E = (_SKEW.reshape(3, 9).T @ t[..., None]).reshape(-1, 3, 3) @ R
    E /= np.sqrt(2.0)
    res = np.abs(np.einsum("kni,kij,knj->kn", h1, E, h0)) / (
        np.linalg.norm(h0, axis=-1) * np.linalg.norm(h1, axis=-1))
    return E, res.max(-1)


def _five_point(x0, x1):
    """Every real essential matrix of minimal samples: normalized
    correspondences x0, x1 [B, 5, 2] -> E [B, 10, 3, 3] (unit Frobenius
    norm, x1^T E x0 = 0) and a validity mask [B, 10].

    The Groebner-basis form of the five-point problem by Stewenius, Engels
    and Nister (ISPRS J. Photogramm. 2006), which has the solution set of
    Nister's degree-10 polynomial (cv2.findEssentialMat's five-point.cpp):
    E = x N0 + y N1 + z N2 + N3 over the null space of the 5x9 epipolar
    system, the ten cubic constraints, their action matrix (_action_roots).
    It runs in two frames of the null space, the SVD's and _family_frame's;
    each root of either is polished on the epipolar equations
    (_epipolar_polish), kept if they then hold to _ROOT_TOL, and counted
    once."""
    B = len(x0)
    h0 = np.concatenate([x0, np.ones(x0.shape[:2] + (1,))], -1)
    h1 = np.concatenate([x1, np.ones(x1.shape[:2] + (1,))], -1)
    A = (h1[..., :, None] * h0[..., None, :]).reshape(B, 5, 9)
    N = np.linalg.svd(A)[2][:, 5:]                              # [B, 4, 9]
    E, valid = _action_roots(np.concatenate([N, _family_frame(N, h0, h1)]))
    E = E.reshape(2, B, 10, 3, 3).transpose(1, 0, 2, 3, 4).reshape(
        B, 20, 3, 3)
    valid = valid.reshape(2, B, 10).transpose(1, 0, 2).reshape(B, 20)
    b, c = np.nonzero(valid)
    E[b, c], res = _epipolar_polish(E[b, c], h0[b], h1[b])
    valid[b, c] = res <= _ROOT_TOL
    flat = E.reshape(B, 20, 9)
    apart = np.minimum(
        np.abs(flat[:, :, None] - flat[:, None]).max(-1),
        np.abs(flat[:, :, None] + flat[:, None]).max(-1))      # [B, 20, 20]
    seen = valid[:, :, None] & (apart < 1e-6) & np.tri(20, k=-1, dtype=bool).T
    valid &= ~seen.any(1)
    order = np.argsort(~valid, axis=1, kind="stable")[:, :10]
    return (np.take_along_axis(E, order[..., None, None], 1),
            np.take_along_axis(valid, order, 1))


def _sampson(E, x0, x1) -> np.ndarray:
    """Squared Sampson distances [B, N] of models E [B, 3, 3] on normalized
    correspondences [N, 2] (OpenCV's essential-matrix error)."""
    h0 = np.concatenate([x0, np.ones((len(x0), 1))], 1)
    h1 = np.concatenate([x1, np.ones((len(x1), 1))], 1)
    Ex0 = E @ h0.T                                             # [B, 3, N]
    Etx1 = E.transpose(0, 2, 1) @ h1.T
    num = (h1.T * Ex0).sum(1) ** 2
    den = Ex0[:, 0] ** 2 + Ex0[:, 1] ** 2 + Etx1[:, 0] ** 2 + Etx1[:, 1] ** 2
    return num / np.maximum(den, 1e-300)


def _ransac_iters(prob, inlier_ratio, sample, cap) -> int:
    """Iterations that find an all-inlier sample with probability `prob`
    (OpenCV's RANSACUpdateNumIters)."""
    ok = inlier_ratio ** sample
    if ok <= 0.0:
        return cap
    if ok >= 1.0:
        return 0
    return int(min(cap, np.ceil(np.log(1.0 - prob) / np.log(1.0 - ok))))


def _samples(rng, n, k, count) -> np.ndarray:
    """`count` samples of k distinct indices of range(n) -> [count, k]."""
    return np.argpartition(rng.random((count, n)), k - 1, axis=1)[:, :k]


def _ransac_essential(x0, x1, t2, prob, max_iters, seed):
    """RANSAC over five-point samples of normalized correspondences, as
    OpenCV's RANSACPointSetRegistrator runs it for findEssentialMat: every
    real solution of a sample (_five_point) is scored by its squared
    Sampson distances against t2; the model with the most inliers wins,
    the truncated cost sum(min(err, t2)) breaking ties; the iterations cut
    as the best inlier ratio grows (RANSACUpdateNumIters). -> (E [3, 3],
    its distances [N], its truncated cost) or None."""
    n = len(x0)
    rng = np.random.default_rng(seed)
    best, best_key = None, (4, 0.0)
    done, need, batch = 0, max_iters, ESSENTIAL_BATCH
    while done < need:
        b = min(batch, need - done)
        idx = _samples(rng, n, 5, b)
        E, valid = _five_point(x0[idx], x1[idx])
        E = E[valid]
        if len(E):
            err = _sampson(E, x0, x1)
            count = (err <= t2).sum(1)
            cost = np.minimum(err, t2).sum(1)
            j = int(np.lexsort((cost, -count))[0])
            if (count[j], -cost[j]) > best_key:
                best, best_key = (E[j], err[j], cost[j]), (count[j], -cost[j])
                need = max(done + b, _ransac_iters(prob, count[j] / n, 5,
                                                   max_iters))
        done += b
    return best


def find_essential_mat(p0, p1, K, prob: float = 0.999,
                       threshold: float = 1.0, max_iters: int = 1000,
                       seed: int = 0):
    """Essential matrix by RANSAC over five-point samples, as
    cv2.findEssentialMat(p0, p1, K, RANSAC, prob, threshold) computes it
    (_ransac_essential), inliers within `threshold` pixels scaled by the
    mean focal length. OpenCV returns the winning sample's model; here it
    is refit on its inliers (_eight_point) where that lowers the truncated
    cost, which on the low-parallax scenes of tests/test_torch_vision.py
    cuts the median rotation error by a third and more. Returns (E [3, 3]
    with x1^T E x0 = 0, mask [N, 1] uint8) or (None, None)."""
    K = np.asarray(K, np.float64)
    x0, x1 = _normalized(p0, K), _normalized(p1, K)
    if len(x0) < 5:
        return None, None
    t2 = (threshold / ((K[0, 0] + K[1, 1]) * 0.5)) ** 2
    best = _ransac_essential(x0, x1, t2, prob, max_iters, seed)
    if best is None:
        return None, None
    E, err, cost = best
    inl = err <= t2
    if inl.sum() >= 8:
        E8 = _eight_point(x0[inl][None], x1[inl][None])[0]
        err = _sampson(E8[None], x0, x1)[0]
        if np.minimum(err, t2).sum() < cost:
            E, inl = E8, err <= t2
    return E, inl.astype(np.uint8).reshape(-1, 1)


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


def jacobi_svd(At, null_vectors: bool = True):
    """lapack.cpp's JacobiSVDImpl_ on a batch, step for step: At [B, n, m]
    holds A^T (the n columns of an m x n matrix A, m >= n; cv::SVD runs it
    under 25 rows, OpenCV 5.0 calls LAPACK from there). One-sided Jacobi
    rotations with its hypot and formulas until a sweep changes nothing,
    the descending selection sort, and for a zero singular value a random
    sign vector from cv::RNG(0x12345678) made orthogonal to the earlier
    left singular vectors (skipped without null_vectors, for callers that
    never read those rows). -> (W [B, n], U^T [B, n, m], V^T [B, n, n]),
    A = U diag(W) V^T, with OpenCV's signs."""
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
    for b in np.nonzero((W <= _DBL_MIN).any(1) & null_vectors)[0]:
        # Zero singular values (sorted last): each left singular vector is
        # a random sign vector made orthogonal to the earlier ones, drawn
        # from one generator per decomposition.
        rng = CvRNG(0x12345678)
        for i in np.nonzero(W[b] <= _DBL_MIN)[0]:
            At[b, i] = _null_vector(At[b], i, m, eps, rng)
    return W, At, Vt


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


def recover_pose(E, p0, p1, K, mask=None, distance_thresh: float = 50.0):
    """Relative pose from an essential matrix, as cv2.recoverPose computes
    it: the four decompositions of E (decomposeEssentialMat through
    _svd3), each held to the cheirality test (points triangulated in front
    of both cameras and nearer than `distance_thresh`) over the masked
    correspondences, the first with the most points winning. Returns
    (count, R [3, 3], t [3, 1], mask [N, 1] uint8) with X1 = R X0 + t; the
    mask holds the input mask's value at each point that passed (255
    without an input mask), as OpenCV's does."""
    K = np.asarray(K, np.float64)
    x0, x1 = _normalized(p0, K), _normalized(p1, K)
    m_in = (np.full(len(x0), 255, np.uint8) if mask is None
            else np.asarray(mask).reshape(-1).astype(np.uint8))
    U, _, Vt = _svd3(E)
    if np.linalg.det(U) < 0:
        U = -U
    if np.linalg.det(Vt) < 0:
        Vt = -Vt
    R1, R2, t = U @ _W90 @ Vt, U @ _W90.T @ Vt, U[:, 2]
    P0 = np.eye(4)[:3]
    best = None
    for R, tt in ((R1, t), (R2, t), (R1, -t), (R2, -t)):
        P1 = np.concatenate([R, tt[:, None]], 1)
        Q = triangulate_points(P0, P1, x0.T, x1.T)
        ok = Q[2] * Q[3] > 0
        with np.errstate(divide="ignore", invalid="ignore"):
            X = Q[:3] / Q[3]
        ok &= X[2] < distance_thresh
        X1 = R @ X + tt[:, None]
        ok &= (X1[2] > 0) & (X1[2] < distance_thresh) & (m_in > 0)
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
           max_iters, batch=16):
    """cv::RANSACPointSetRegistrator::run over `count` correspondences,
    generic over its kernel: kernel(subsets [b, k]) -> (models [b', ...],
    subset [b'] each model came from, in order); errors(models) -> float32
    squared errors [b', count], inliers where at most float32(threshold^2).
    A model wins with strictly more inliers than the best so far (and than
    model_points - 1), the iterations cut by ransac_update_num_iters.
    Subsets do not depend on the models, so the kernel runs on batches of
    them (batch, then up to 64 a call) and the models are visited in
    OpenCV's order. -> (best model, inlier mask [count]) or (None, None)."""
    if count < model_points:
        return None, None
    t = np.float32(float(np.float32(threshold)) ** 2)
    if count == model_points:
        models, _ = kernel(np.arange(count)[None])
        if len(models) == 0:
            return None, None
        return models[0], np.ones(count, bool)
    niters = max(max_iters, 1)
    subsets = _ransac_subsets(count, model_points, niters)
    best, best_mask, best_good = None, None, 0
    it = 0
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
        batch = 64
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

    model, mask = ransac(n, PNP_SAMPLE, kernel, errors, reproj_err,
                         PNP_CONFIDENCE, iters)
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


def _retain_best(score: torch.Tensor, n: int) -> torch.Tensor:
    """Mask of the entries at or above the n-th largest score (ties kept,
    as KeyPointsFilter::retainBest)."""
    if len(score) <= n:
        return torch.ones_like(score, dtype=torch.bool)
    if n == 0:
        return torch.zeros_like(score, dtype=torch.bool)
    return score >= torch.topk(score, n).values[-1]


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
    level, each level in raster order; OpenCV's own order comes from
    std::nth_element inside retainBest and carries no meaning."""
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
        keep = _retain_best(inner[ys, xs], 2 * n)
        ys, xs = ys[keep], xs[keep]
        resp = harris_response(*harris_sums(im, ys, xs))
        keep = _retain_best(resp, n)
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
