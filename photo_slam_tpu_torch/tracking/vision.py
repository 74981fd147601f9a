"""The vision functions of the SLAM frontend, owned by the port.

The JAX package's frontend calls OpenCV for these (photo_slam_tpu/tracking/
frontend.py:161, :289-299, :430-438, :508-521, :827). The card's machine
has no OpenCV, so the port implements them here with the same semantics,
and the frontend reaches them only through this module (a test swaps in
OpenCV's versions):

  * rgb_to_gray: OpenCV's fixed-point RGB->gray, bit for bit;
  * rodrigues / rodrigues_inverse: rotation vector <-> matrix;
  * triangulate_points: homogeneous DLT through an SVD per point;
  * solve_pnp_ransac: P3P minimal samples (a fourth point picks the root)
    inside RANSAC, refined on the inliers by the native pose_optimize;
  * find_essential_mat / recover_pose: the normalized 8-point algorithm
    inside RANSAC (Sampson error), the four decompositions and the
    cheirality test by triangulation;
  * orb_detect_and_compute: ORB with cv2.ORB_create's defaults, in plain
    torch on a given device.

Every random draw comes from an np.random.Generator seeded per call, so a
run repeats exactly. ORB computes in integers wherever OpenCV does (the
pyramid's fixed-point bilinear, FAST, the Harris sums, the intensity
centroid, the smoothed level), so the card and the CPU find the same
keypoints; only the orientation goes through a float atan2.

ORB's 256 test pairs are not OpenCV's learned table (`bit_pattern_31_`,
which this repository does not carry): they are drawn once from a fixed
seed, both points of a pair isotropic Gaussian with sigma = 31/5, rounded
and clipped to the 31x31 patch (BRIEF's G II), and stored below as
BRIEF_PATTERN. The port's descriptors therefore differ bit-wise from
OpenCV's; keypoints, responses and orientations agree.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from photo_slam_tpu_torch.native import pose_optimize

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
    """Rotation vector -> 3x3 rotation matrix (cv2.Rodrigues)."""
    r = np.asarray(rvec, np.float64).reshape(3)
    theta = float(np.linalg.norm(r))
    if theta < np.finfo(np.float64).eps:
        return np.eye(3)
    c, s = np.cos(theta), np.sin(theta)
    k = r / theta
    kx = np.array([[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]],
                   [-k[1], k[0], 0.0]])
    return c * np.eye(3) + (1.0 - c) * np.outer(k, k) + s * kx


def rodrigues_inverse(R) -> np.ndarray:
    """3x3 rotation matrix -> rotation vector [3, 1] (cv2.Rodrigues): the
    matrix is first projected onto SO(3) through its SVD."""
    U, _, Vt = np.linalg.svd(np.asarray(R, np.float64))
    R = U @ Vt
    r = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    s = np.sqrt((r @ r) * 0.25)
    c = float(np.clip((np.trace(R) - 1.0) * 0.5, -1.0, 1.0))
    theta = np.arccos(c)
    if s < 1e-5:
        if c > 0:
            return np.zeros((3, 1))
        r = np.array([np.sqrt(max((R[0, 0] + 1.0) * 0.5, 0.0)),
                      np.sqrt(max((R[1, 1] + 1.0) * 0.5, 0.0))
                      * (-1.0 if R[0, 1] < 0 else 1.0),
                      np.sqrt(max((R[2, 2] + 1.0) * 0.5, 0.0))
                      * (-1.0 if R[0, 2] < 0 else 1.0)])
        if (abs(r[0]) < abs(r[1]) and abs(r[0]) < abs(r[2])
                and (R[1, 2] > 0) != (r[1] * r[2] > 0)):
            r[2] = -r[2]
        return (r * theta / np.linalg.norm(r)).reshape(3, 1)
    return (r * theta / (2.0 * s)).reshape(3, 1)


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
    F = np.linalg.svd(A)[2][:, -1].reshape(-1, 3, 3)
    U, _, Vt = np.linalg.svd(T1.transpose(0, 2, 1) @ F @ T0)
    return U @ np.diag([1.0, 1.0, 0.0]) @ Vt / np.sqrt(2.0)


def _sampson(E, x0, x1) -> np.ndarray:
    """Squared Sampson distances [B, N] of models E [B, 3, 3] on normalized
    correspondences [N, 2] (OpenCV's essential-matrix error)."""
    h0 = np.concatenate([x0, np.ones((len(x0), 1))], 1)
    h1 = np.concatenate([x1, np.ones((len(x1), 1))], 1)
    Ex0 = np.einsum("bij,nj->bni", E, h0)
    Etx1 = np.einsum("bji,nj->bni", E, h1)
    num = np.einsum("ni,bni->bn", h1, Ex0) ** 2
    den = (Ex0[..., 0] ** 2 + Ex0[..., 1] ** 2 + Etx1[..., 0] ** 2
           + Etx1[..., 1] ** 2)
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


def find_essential_mat(p0, p1, K, prob: float = 0.999,
                       threshold: float = 1.0, max_iters: int = 1000,
                       seed: int = 0):
    """Essential matrix by RANSAC over 8-point samples (the role of
    cv2.findEssentialMat(p0, p1, K, RANSAC, prob, threshold)): inliers by
    the Sampson distance at `threshold` pixels (scaled by the mean focal
    length); models ranked by the truncated cost sum(min(err, t^2)) (MSAC),
    so of two models with the same inliers the one that fits them closer
    wins; the best refit on its inliers when that lowers the cost. Returns
    (E [3, 3] with x1^T E x0 = 0, mask [N, 1] uint8) or (None, None)."""
    K = np.asarray(K, np.float64)
    x0, x1 = _normalized(p0, K), _normalized(p1, K)
    n = len(x0)
    if n < 8:
        return None, None
    t2 = (threshold / ((K[0, 0] + K[1, 1]) * 0.5)) ** 2
    rng = np.random.default_rng(seed)
    best_E, best_cost, best_err = None, np.inf, None
    done, need, batch = 0, max_iters, 64
    while done < need:
        b = min(batch, need - done)
        idx = _samples(rng, n, 8, b)
        E = _eight_point(x0[idx], x1[idx])
        err = _sampson(E, x0, x1)
        cost = np.minimum(err, t2).sum(1)
        j = int(np.argmin(cost))
        if cost[j] < best_cost:
            best_E, best_cost, best_err = E[j], cost[j], err[j]
            need = max(done + b, _ransac_iters(
                prob, (best_err <= t2).mean(), 8, max_iters))
        done += b
    inl = best_err <= t2
    if inl.sum() >= 8:
        E = _eight_point(x0[inl][None], x1[inl][None])[0]
        err = _sampson(E[None], x0, x1)[0]
        if np.minimum(err, t2).sum() < best_cost:
            best_E, inl = E, err <= t2
    return best_E, inl.astype(np.uint8).reshape(-1, 1)


def recover_pose(E, p0, p1, K, mask=None, distance_thresh: float = 50.0):
    """Relative pose from an essential matrix (the role of
    cv2.recoverPose): the four decompositions of E, each held to the
    cheirality test (points triangulated in front of both cameras and
    nearer than `distance_thresh`) over the masked correspondences.
    Returns (count, R [3, 3], t [3, 1], mask [N, 1] uint8) with
    X1 = R X0 + t."""
    K = np.asarray(K, np.float64)
    x0, x1 = _normalized(p0, K), _normalized(p1, K)
    m_in = (np.ones(len(x0), bool) if mask is None
            else np.asarray(mask).reshape(-1) > 0)
    U, _, Vt = np.linalg.svd(np.asarray(E, np.float64))
    if np.linalg.det(U) < 0:
        U = -U
    if np.linalg.det(Vt) < 0:
        Vt = -Vt
    W = np.array([[0.0, 1.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    R1, R2, t = U @ W @ Vt, U @ W.T @ Vt, U[:, 2]
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
        ok &= (X1[2] > 0) & (X1[2] < distance_thresh) & m_in
        good = int(ok.sum())
        if best is None or good > best[0]:
            best = (good, R, tt.reshape(3, 1), ok)
    good, R, tt, ok = best
    return good, R, tt, ok.astype(np.uint8).reshape(-1, 1)


# ---------------------------------------------------------------------------
# PnP
# ---------------------------------------------------------------------------

def _polymul(a, b):
    """Products of batched polynomials (highest power first) [B, m], [B, n]
    -> [B, m + n - 1]."""
    out = np.zeros((len(a), a.shape[1] + b.shape[1] - 1))
    for i in range(a.shape[1]):
        out[:, i:i + b.shape[1]] += a[:, i:i + 1] * b
    return out


def _pad(a, n):
    return np.concatenate([np.zeros((len(a), n - a.shape[1])), a], 1)


def _p3p(W, f):
    """Batched P3P: world points W [B, 3, 3] and unit bearings f [B, 3, 3]
    -> up to four poses per sample: R [B, 4, 3, 3], t [B, 4, 3] and a
    validity mask [B, 4]. With u = s2/s1, v = s3/s1 for the distances s_i
    along the bearings, the laws of cosines give two quadratics in u whose
    resultant is a quartic in v; their sum is linear in u."""
    a2 = ((W[:, 1] - W[:, 2]) ** 2).sum(-1)
    b2 = ((W[:, 0] - W[:, 2]) ** 2).sum(-1)
    c2 = ((W[:, 0] - W[:, 1]) ** 2).sum(-1)
    ca = (f[:, 1] * f[:, 2]).sum(-1)
    cb = (f[:, 0] * f[:, 2]).sum(-1)
    cg = (f[:, 0] * f[:, 1]).sum(-1)
    B = len(W)
    one = np.ones(B)
    zero = np.zeros(B)
    # g(v) = 1 + v^2 - 2 v cb
    g = np.stack([one, -2 * cb, one], 1)
    # E1: b2 u^2 - 2 b2 cg u + (b2 - c2 g(v)) = 0
    p2 = np.stack([b2], 1)
    p1 = np.stack([-2 * b2 * cg], 1)
    p0 = -c2[:, None] * g
    p0[:, 2] += b2
    # E2: -b2 u^2 + 2 b2 ca v u + (a2 g(v) - b2 v^2) = 0
    q2 = np.stack([-b2], 1)
    q1 = np.stack([2 * b2 * ca, zero], 1)
    q0 = a2[:, None] * g
    q0[:, 0] -= b2
    d20 = _pad(_polymul(p2, q0), 3) - _pad(_polymul(p0, q2), 3)
    d21 = _pad(_polymul(p2, q1), 2) - _pad(_polymul(p1, q2), 2)
    d10 = _pad(_polymul(p1, q0), 4) - _pad(_polymul(p0, q1), 4)
    quartic = _pad(_polymul(d20, d20), 5) - _pad(_polymul(d21, d10), 5)
    lead = quartic[:, 0]
    scale = np.abs(quartic).max(1)
    ok_lead = np.abs(lead) > 1e-12 * np.maximum(scale, 1e-300)
    lead = np.where(ok_lead, lead, 1.0)
    comp = np.zeros((B, 4, 4))
    comp[:, 0, :] = -quartic[:, 1:] / lead[:, None]
    comp[:, 1, 0] = comp[:, 2, 1] = comp[:, 3, 2] = 1.0
    comp = np.where(np.isfinite(comp), comp, 0.0)
    roots = np.linalg.eigvals(comp)                           # [B, 4]
    real = np.abs(roots.imag) <= 1e-8 * np.maximum(1.0, np.abs(roots.real))
    v = roots.real
    den = 2 * b2[:, None] * (ca[:, None] * v - cg[:, None])
    num = -(b2[:, None] - c2[:, None] * (1 + v * v - 2 * v * cb[:, None])
            + a2[:, None] * (1 + v * v - 2 * v * cb[:, None])
            - b2[:, None] * v * v)
    with np.errstate(divide="ignore", invalid="ignore"):
        u = num / den
        gv = 1 + v * v - 2 * v * cb[:, None]
        s1 = np.sqrt(b2[:, None] / gv)
    valid = (ok_lead[:, None] & real & (v > 0) & np.isfinite(u) & (u > 0)
             & (gv > 0) & np.isfinite(s1))
    s = np.stack([s1, u * s1, v * s1], -1)                     # [B, 4, 3]
    s = np.where(valid[..., None], s, 1.0)
    C = s[..., None] * f[:, None]                              # [B, 4, 3, 3]
    Wb = np.broadcast_to(W[:, None], C.shape)
    mw = Wb.mean(2, keepdims=True)
    mc = C.mean(2, keepdims=True)
    H = np.einsum("bkni,bknj->bkij", Wb - mw, C - mc)
    U, _, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(Vt.transpose(0, 1, 3, 2)
                              @ U.transpose(0, 1, 3, 2)))
    D = np.zeros(U.shape)
    D[..., 0, 0] = D[..., 1, 1] = 1.0
    D[..., 2, 2] = np.where(d == 0, 1.0, d)
    R = Vt.transpose(0, 1, 3, 2) @ D @ U.transpose(0, 1, 3, 2)
    t = mc[:, :, 0] - np.einsum("bkij,bkj->bki", R, mw[:, :, 0])
    return R, t, valid


def _reprojection(R, t, obj, img, K):
    """Pixel errors [B, N] of poses R [B, 3, 3], t [B, 3] (inf behind the
    camera)."""
    Xc = np.einsum("bij,nj->bni", R, obj) + t[:, None]
    z = Xc[..., 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        u = K[0, 0] * Xc[..., 0] / z + K[0, 2]
        v = K[1, 1] * Xc[..., 1] / z + K[1, 2]
        err = np.hypot(u - img[:, 0], v - img[:, 1])
    return np.where(z > 0, err, np.inf)


def solve_pnp_ransac(obj, img, K, rvec0=None, tvec0=None,
                     use_guess: bool = False, reproj_err: float = 8.0,
                     iters: int = 100, seed: int = 0):
    """Camera pose from 3D-2D correspondences with outliers (the role of
    cv2.solvePnPRansac with SOLVEPNP_ITERATIVE): RANSAC over P3P minimal
    samples of four points (three solve, the fourth picks the root), with
    the guess (rvec0, tvec0) as one more hypothesis when use_guess; the
    inliers are the points within `reproj_err` pixels. The best pose is
    refined on its inliers by the native pose_optimize and the inliers are
    taken again under it. Returns (ok, rvec [3, 1], tvec [3, 1], inliers
    [M, 1] int32 or None)."""
    obj = np.asarray(obj, np.float64).reshape(-1, 3)
    img = np.asarray(img, np.float64).reshape(-1, 2)
    K = np.asarray(K, np.float64)
    n = len(obj)
    fail = (False, np.zeros((3, 1)), np.zeros((3, 1)), None)
    if n < 4:
        return fail
    rng = np.random.default_rng(seed)
    idx = _samples(rng, n, 4, iters)
    bear = np.concatenate([_normalized(img, K), np.ones((n, 1))], 1)
    bear /= np.linalg.norm(bear, axis=1, keepdims=True)
    R, t, valid = _p3p(obj[idx[:, :3]], bear[idx[:, :3]])
    # The fourth point of each sample picks its root.
    Xc = np.einsum("bkij,bj->bki", R, obj[idx[:, 3]]) + t
    with np.errstate(divide="ignore", invalid="ignore"):
        uv = Xc[..., :2] / Xc[..., 2:3] * K[[0, 1], [0, 1]] + K[:2, 2]
        e4 = np.hypot(*(uv - img[idx[:, 3]][:, None]).transpose(2, 0, 1))
    e4 = np.where(valid & (Xc[..., 2] > 0) & np.isfinite(e4), e4, np.inf)
    k = np.argmin(e4, axis=1)
    has = np.isfinite(e4[np.arange(len(k)), k])
    R, t = R[np.arange(len(k)), k][has], t[np.arange(len(k)), k][has]
    if use_guess and rvec0 is not None and tvec0 is not None:
        R = np.concatenate([rodrigues(rvec0)[None], R])
        t = np.concatenate([np.asarray(tvec0, np.float64).reshape(1, 3), t])
    if len(R) == 0:
        return fail
    inliers = _reprojection(R, t, obj, img, K) < reproj_err
    j = int(np.argmax(inliers.sum(1)))
    inl = inliers[j]
    if inl.sum() < 4:
        return fail
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R[j], t[j]
    _, T, _ = pose_optimize(obj[inl], img[inl], K[0, 0], K[1, 1], K[0, 2],
                            K[1, 2], T)
    refined = _reprojection(T[None, :3, :3], T[None, :3, 3], obj, img,
                            K)[0] < reproj_err
    if refined.sum() >= inl.sum():
        inl = refined
    else:
        T[:3, :3], T[:3, 3] = R[j], t[j]
    return (True, rodrigues_inverse(T[:3, :3]), T[:3, 3].reshape(3, 1),
            np.nonzero(inl)[0].astype(np.int32).reshape(-1, 1))


# ---------------------------------------------------------------------------
# ORB (cv2.ORB_create's defaults)
# ---------------------------------------------------------------------------

ORB_LEVELS = 8
ORB_SCALE = 1.2
EDGE_THRESHOLD = 31          # keypoints at least this far from a level's edge
PATCH_SIZE = 31
FAST_THRESHOLD = 20
HARRIS_BLOCK = 7
HARRIS_K = 0.04              # = 1/25: the score is ranked as 25x in integers
ANGLE_BINS = 360             # steering table resolution, degrees
PATTERN_SEED = 31
PATTERN_SIGMA = PATCH_SIZE / 5

# FAST's Bresenham circle of radius 3, as (dx, dy), in OpenCV's order.
FAST_CIRCLE = ((0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2),
               (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0),
               (-3, 1), (-2, 2), (-1, 3))

# The 256 test pairs (x0, y0, x1, y1), drawn by draw_pattern(PATTERN_SEED).
BRIEF_PATTERN = np.array([
    -2, 2, 4, -6, 7, -6, 11, 7, -4, 4, 3, -11, 4, -4, -2, -4,
    -3, 0, 1, -10, -2, -8, -8, -2, 5, 4, -4, -4, -5, 1, 6, 0,
    4, 2, 9, -12, -13, -1, 4, -3, 3, -7, -8, -4, 5, 4, -4, 1,
    -4, 0, -7, 0, -5, 0, -4, -5, 1, -2, 0, -3, 4, -5, 5, 8,
    -2, 11, 13, 3, -8, -10, -1, 11, 4, 5, -2, -5, 2, -7, -1, 3,
    0, 3, -3, 4, 3, -10, -6, -4, 4, 2, 2, 1, 4, 6, -3, -10,
    4, -1, 0, -1, -7, -9, 6, 7, 6, 1, 2, -3, 0, -2, -3, 1,
    11, -12, 4, 4, -8, 2, 1, -3, -3, -9, 11, 15, 10, -2, 2, 2,
    -5, -2, 3, -3, -11, -8, 2, -2, -2, 8, 1, -4, 0, 13, -7, 11,
    9, -1, -2, 9, 2, -3, 11, 1, 2, 0, -2, 1, -2, 3, 7, 7,
    7, 9, 5, -4, 6, -10, -4, 2, -10, 9, -6, -9, -5, -5, 0, -1,
    6, -1, 1, -6, 3, -5, -12, 8, -7, -7, -5, 4, -9, -2, 4, 12,
    -2, 0, -5, 12, -1, 0, 1, -6, 0, -8, 9, -1, -1, 7, -8, 9,
    9, -5, 4, -1, 5, 0, -6, 4, -1, 1, 6, 8, 4, -9, 4, -2,
    7, -1, 9, 3, 0, 2, -11, 4, 1, -7, 3, 2, 2, -1, 5, 5,
    1, 0, -3, -4, 4, -3, -9, 2, 7, -2, 5, 3, -6, 2, -1, 4,
    -15, 5, 5, -6, 7, -1, 1, 5, 8, 1, 4, 3, -4, 10, 5, 1,
    7, 3, -3, 6, 0, 4, 6, 6, 12, 1, -1, -4, -4, 4, 3, -5,
    -4, -3, 10, -6, 2, -10, -1, 9, -8, 7, -11, 1, -7, 0, -1, 5,
    2, 1, -3, 3, -5, -4, -4, 4, 14, 0, 12, -6, -3, 3, 4, 5,
    10, -1, 7, 2, -15, -6, -3, 1, 4, -1, 8, -6, 0, 6, -7, 8,
    6, -1, 0, 0, 0, 8, 3, -8, -9, 4, -15, -9, -4, 0, 9, 1,
    15, 2, 6, 7, 0, 6, 4, 2, -4, -2, 5, 0, 3, 3, 2, 0,
    4, 5, 9, 3, -3, -4, 4, -9, -3, 7, -2, -4, 8, -15, 0, -3,
    -3, 6, 9, 7, 4, 2, -1, 0, -10, -3, 4, -1, 5, -9, -3, -6,
    7, -1, -2, -7, -3, -6, -3, 14, -7, -1, -5, 8, -6, -5, 2, 10,
    2, -3, -15, -15, 0, 0, 7, 3, -1, 8, 11, -4, 6, 8, -5, 4,
    0, 7, 7, -13, -1, 9, 3, -6, -3, -7, 2, -8, 8, 5, 11, 7,
    6, 6, 4, -12, 4, -5, -15, 10, 0, -10, 2, 3, 1, 9, -7, 6,
    -6, 3, 4, -3, 15, -11, -9, -3, -5, 7, -3, 8, -3, 5, 5, 1,
    5, 2, 13, 15, -2, 3, 7, 4, 12, 15, -12, -3, 9, 4, -4, -1,
    1, 11, -6, 2, 9, 7, -1, -1, -11, -10, -5, 5, 5, 8, 6, 5,
    1, -5, 8, -2, -11, 3, 1, 15, -1, 2, -7, 4, 2, -5, 2, -8,
    4, -3, 2, -6, -5, -1, 5, 1, -15, 4, -1, 4, 7, 5, -5, -2,
    3, 6, -5, -4, -6, 3, -4, 14, 5, 7, 4, -4, -15, 9, 2, -12,
    15, 5, 10, -1, -11, -5, 5, -13, -3, 7, 7, 1, -15, -2, 8, 5,
    -2, 2, 4, -2, -5, -4, -5, 0, 0, 4, 4, -1, -13, 4, -6, 11,
    -2, 14, 4, 11, 1, 3, -3, -3, -3, 5, -7, 6, -2, 4, -6, 0,
    -11, -4, -1, -6, -1, 1, 1, -13, -2, -1, -5, -6, 12, 5, 6, 7,
    -6, -2, -11, 1, -12, -4, 5, 3, -6, -6, 8, 3, -3, 1, 1, -7,
    -3, -13, 1, 1, 6, 6, -3, 10, -5, 6, -3, -4, -8, 0, 14, 1,
    3, -2, 3, 4, 3, 9, 0, 3, 10, 4, -5, 8, 4, -5, -5, -2,
    5, 2, 6, 15, 11, 1, -4, 9, -4, -5, -1, 2, -1, 2, -15, -2,
    0, 4, 2, -1, 15, 6, 4, 2, 3, -5, -6, 2, -10, 4, -2, 5,
    1, -5, -4, -2, 8, 9, -1, 1, -5, 9, 2, -4, -8, 3, 12, 1,
    -5, -5, -3, -14, 6, -3, -11, -15, 2, 1, 9, 6, -3, -11, 1, -4,
    1, -10, -2, -1, -8, -11, -14, 0, 7, 0, -15, 0, -10, 1, 11, 2,
    -15, 6, 2, 12, 3, 4, -11, 9, -8, -13, 3, 5, 9, 7, 2, 2,
    5, 2, 3, -13, -1, -2, 3, -5, 6, 5, -7, 0, 3, -7, -15, -2,
    2, 0, 7, 2, 10, -4, 10, -2, 3, -12, -5, 7, 0, 0, -7, 5,
    -6, 9, 4, -3, -5, -3, 2, 2, -10, 2, -7, 11, -12, 6, -7, 2,
    7, 3, -7, -10, 9, -5, 5, 7, -10, 12, -1, -1, -6, 1, 3, 7,
    6, 6, -1, -1, 1, 1, 8, 6, -1, -6, -12, -1, 0, -12, -2, 2,
    1, -9, -4, -9, 5, 2, 15, -4, 9, 0, 1, 7, -12, -7, 9, 6,
    12, 4, -3, 5, -3, 0, -1, -5, 13, 4, 1, 2, -4, -2, 1, 2,
    -13, 8, -13, -6, -9, 1, -11, 6, 4, 6, 5, -2, 1, -6, -3, 3,
    -8, -2, -3, 6, 3, -3, 5, 12, 7, 1, 1, -6, -3, 2, 2, -9,
    -8, -8, -7, -4, -1, -7, -4, -12, -2, 1, -4, -10, 15, -5, 2, -14,
    -5, 1, -1, 1, 0, -5, -6, -2, -4, -4, 2, 1, -3, 6, -1, -2,
    5, 1, -10, 2, -10, -2, 1, 4, -6, -3, 4, 12, 12, 5, 10, -4,
    -2, 5, 5, -10, 7, -6, -1, -7, -2, 6, -8, -4, 0, 3, 10, 1,
    6, -10, -4, -15, 7, -4, 4, -7, -7, -7, -5, -2, -11, 0, 3, -12,
    -10, -7, -6, 10, 4, -8, 15, 5, -8, -11, 2, -11, 1, 5, -6, -5,
    -6, 8, 4, 3, 5, 0, -4, 2, 5, -1, -2, -6, 8, 5, 1, 1,
], np.int64).reshape(256, 4)


def draw_pattern(seed: int = PATTERN_SEED) -> np.ndarray:
    """The steered-BRIEF test pairs [256, 4] (x0, y0, x1, y1): both points
    isotropic Gaussian with sigma = 31/5 (BRIEF's G II), rounded, clipped to
    the 31x31 patch; a pair whose points coincide is drawn again."""
    rng = np.random.default_rng(seed)
    half = PATCH_SIZE // 2
    pairs = []
    while len(pairs) < 256:
        p = np.clip(np.rint(rng.normal(0.0, PATTERN_SIGMA, (2, 2))), -half,
                    half).astype(np.int64)
        if (p[0] != p[1]).any():
            pairs.append(p.ravel())
    return np.array(pairs)


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
    factor = f32(1.0 / ORB_SCALE)
    per = f32(nfeatures) * (f32(1) - factor) / (
        f32(1) - f32(float(factor) ** ORB_LEVELS))
    out = []
    for _ in range(ORB_LEVELS - 1):
        out.append(int(np.rint(per)))
        per = f32(per * factor)
    out.append(max(nfeatures - sum(out), 0))
    return out


def level_scales() -> np.ndarray:
    """Per-level scale 1.2^l as float32."""
    return np.array([ORB_SCALE ** l for l in range(ORB_LEVELS)], np.float32)


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


def _steered_pattern() -> np.ndarray:
    """BRIEF_PATTERN's points rotated to each of ANGLE_BINS orientations
    and rounded -> [ANGLE_BINS, 512, 2] (dx, dy)."""
    pts = BRIEF_PATTERN.reshape(512, 2).astype(np.float64)
    th = np.deg2rad(np.arange(ANGLE_BINS) * 360.0 / ANGLE_BINS)
    a, b = np.cos(th)[:, None], np.sin(th)[:, None]
    x = np.rint(pts[:, 0] * a - pts[:, 1] * b)
    y = np.rint(pts[:, 0] * b + pts[:, 1] * a)
    return np.stack([x, y], -1).astype(np.int64)


@functools.lru_cache(maxsize=8)
def _tables(device: torch.device):
    """The circular patch's (du, dv), the Harris block's (dy, dx) and the
    steered test points on `device`, uploaded once per device."""
    half = PATCH_SIZE // 2
    dv, du = np.nonzero(_patch_mask())
    r = HARRIS_BLOCK // 2
    hy, hx = np.mgrid[-r:r + 1, -r:r + 1]
    return tuple(torch.from_numpy(x).to(device) for x in (
        (du - half).astype(np.int64), (dv - half).astype(np.int64),
        hy.ravel().astype(np.int64), hx.ravel().astype(np.int64),
        _steered_pattern()))


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
    round(size / 1.2^l), each resized from the one above."""
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
    H, W = img.shape
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


def harris_response(a, b, c) -> np.ndarray:
    """OpenCV's float32 Harris response from the integer sums."""
    f32 = np.float32
    a, b, c = (np.asarray(x).astype(np.float32) for x in (a, b, c))
    scale = f32(1.0) / f32((1 << 2) * HARRIS_BLOCK * 255.0)
    s4 = scale * scale * scale * scale
    return ((a * b - c * c - f32(HARRIS_K) * (a + b) * (a + b)) * s4).astype(
        np.float32)


def _smooth(img: torch.Tensor) -> torch.Tensor:
    """5x5 binomial smoothing of an int32 image, rounded (the 2-pixel
    border is left unsmoothed: no keypoint's tests reach it)."""
    out = img.clone()
    h = (img[:, :-4] + 4 * img[:, 1:-3] + 6 * img[:, 2:-2] + 4 * img[:, 3:-1]
         + img[:, 4:])
    v = (h[:-4] + 4 * h[1:-3] + 6 * h[2:-2] + 4 * h[3:-1] + h[4:])
    out[2:-2, 2:-2] = (v + 128) >> 8
    return out


def orb_detect_and_compute(gray, nfeatures: int = 500,
                           device="cpu") -> OrbFeatures:
    """ORB keypoints and descriptors of an 8-bit gray image [H, W] (numpy
    or tensor), computed with torch on `device`, following
    cv2.ORB_create(nfeatures)'s defaults: 8 levels at scale 1.2 with the
    per-level budget of level_budget; FAST-9 at threshold 20 with non-max
    suppression on each level, keypoints at least 31 pixels from its edge;
    the best 2n per level by FAST score, then the best n by the Harris
    score (k 0.04, 7x7 block); orientation by the intensity centroid over
    the circular patch of radius 15; 256 steered tests on the 5x5-smoothed
    level. Points come back in level-0 pixels, level by level, each level
    in raster order."""
    device = torch.device(device)
    img = torch.as_tensor(np.asarray(gray, np.uint8)).to(device).to(
        torch.int32)
    du, dv, _, _, steered = _tables(device)
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
        a, b, c = harris_sums(im, ys, xs)
        rank = 25 * (a * b - c * c) - (a + b) * (a + b)
        keep = _retain_best(rank, n)
        ys, xs, a, b, c = ys[keep], xs[keep], a[keep], b[keep], c[keep]
        # Orientation: the intensity centroid over the circular patch.
        patch = _window_sums(im, ys, xs, dv, du)
        m10 = (patch * du).sum(1)
        m01 = (patch * dv).sum(1)
        angle = torch.rad2deg(torch.atan2(m01.to(torch.float64),
                                          m10.to(torch.float64)))
        angle = torch.remainder(angle, 360.0)
        # Steered tests on the smoothed level.
        k = torch.remainder(torch.round(angle * (ANGLE_BINS / 360.0)),
                            ANGLE_BINS).to(torch.int64)
        offs = steered[k]                                    # [N, 512, 2]
        flat = ((ys[:, None] + offs[..., 1]) * W + xs[:, None]
                + offs[..., 0])
        vals = _smooth(im).reshape(-1)[flat]
        bits = (vals[:, 0::2] < vals[:, 1::2]).to(torch.int32)
        weights = (1 << torch.arange(8, device=device, dtype=torch.int32))
        desc = (bits.reshape(-1, 32, 8) * weights).sum(-1).to(torch.uint8)
        host = [t.cpu().numpy() for t in (xs, ys, a, b, c, angle, desc)]
        xs_h, ys_h, a_h, b_h, c_h, ang_h, desc_h = host
        s = scales[lvl]
        out["px"].append(np.stack([xs_h.astype(np.float32) * s,
                                   ys_h.astype(np.float32) * s], 1))
        out["desc"].append(desc_h)
        out["resp"].append(harris_response(a_h, b_h, c_h))
        out["angle"].append(ang_h.astype(np.float32))
        out["level"].append(np.full(len(xs_h), lvl, np.int32))
    empty = dict(px=np.zeros((0, 2), np.float32),
                 desc=np.zeros((0, 32), np.uint8),
                 resp=np.zeros(0, np.float32),
                 angle=np.zeros(0, np.float32),
                 level=np.zeros(0, np.int32))
    return OrbFeatures(**{k: (np.concatenate(v) if v else empty[k])
                          for k, v in out.items()})
