"""The port's own vision functions (photo_slam_tpu_torch/tracking/vision.py)
against OpenCV's, on seeded numpy inputs.

Tolerances: rgb_to_gray bit-equal to cv2.cvtColor; rodrigues within 1e-12
(and bit-equal, with its derivative, beside projectPoints);
triangulate_points bit-equal to cv2.triangulatePoints (float32 points
too); solve_pnp_ransac on noise-free correspondences with 30 % outliers:
the pose within 1e-6 and the inliers exactly the points within the
threshold; solve_pnp_ransac against cv2.solvePnPRansac on 310 seeded
scenes and where OpenCV fails: the same ok and inliers, the pose within
1e-9; its numerics (CvRNG, jacobi_svd, svd_solve, svd_invert, gemm_at_b,
mul_transposed, fma) bit-equal to OpenCV's, norm_l2sqr on whole blocks of
16. The two-view geometry bit for bit against OpenCV 5.0:
find_essential_mat against cv2.findEssentialMat(RANSAC) (E and mask) and
recover_pose against cv2.recoverPose on its E (count, R, t, mask) on the
low-parallax suite (LOW_PARALLAX_SCENES scenes of a slow pan) and on
seeded scenes of 8-2,000 points, 0-1 px of noise, 0-50 % outliers, a
near-pure rotation, five points (every root's E, stacked) and fewer; the
five-point kernel against OpenCV's stacked roots on exact minimal samples
(hypothesis); its steps against OpenCV's own (solve_poly against
cv2.solvePoly, lu_solve against cv2.solve(DECOMP_LU), the full Jacobi SVD
against cv2.SVDecomp(SVD_FULL_UV), decompose_essential_mat against
cv2.decomposeEssentialMat); _svd3 against cv2.SVDecomp. With a noise-free
scene the pose is also held to the truth (1e-6). ORB equal to
cv2.ORB_create(n).detectAndCompute at 320x240, 600x340, 640x480, 752x480
and 1200x680 on three images for n = 500, 1000, 2000: the same keypoints
(level and float32 point), equal float32 responses and angles, bit-equal
descriptors, row for row in OpenCV's order (retain_best, the shim that
gives it, index for index against its plain twin retain_best_plain on
heavily tied responses and past the selection's depth limit); its pieces
bit for bit against OpenCV's (the learned test pairs, fastAtan2, the level
blur against cv2.sepFilter2D, the steering on angles where cosf would
round otherwise, a Harris tie at a level's budget)."""
import ctypes
import ctypes.util
import hashlib
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke
from photo_slam_tpu_torch.tools import synth_replica
from photo_slam_tpu_torch.tracking import vision
from test_torch_blend import one_torch_thread  # noqa: F401
from test_torch_frontend import splat_render, textured_world

cv2 = pytest.importorskip("cv2")

K = np.array([[260.0, 0.0, 160.0], [0.0, 260.0, 120.0], [0.0, 0.0, 1.0]])


def project(R, t, X):
    xc = X @ R.T + t
    return np.stack([K[0, 0] * xc[:, 0] / xc[:, 2] + K[0, 2],
                     K[1, 1] * xc[:, 1] / xc[:, 2] + K[1, 2]], 1)


def scene(seed, n=200):
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                  rng.uniform(4, 8, n)], 1)
    rvec = rng.normal(0, 0.1, 3)
    tvec = rng.normal(0, 0.3, 3)
    return rng, X, vision.rodrigues(rvec), rvec, tvec


def test_rgb_to_gray_bit_equal():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (240, 320, 3), dtype=np.uint8)
    np.testing.assert_array_equal(vision.rgb_to_gray(img),
                                  cv2.cvtColor(img, cv2.COLOR_RGB2GRAY))


@pytest.mark.parametrize("rvec", [
    [0.3, -0.2, 0.1], [1e-12, 0.0, 0.0], [0.0, 0.0, 0.0], [np.pi, 0.0, 0.0],
    [0.0, 2.5, -1.0], [1e-6, -2e-6, 3e-7]])
def test_rodrigues(rvec):
    r = np.array(rvec, np.float64)
    R = vision.rodrigues(r)
    want_R = cv2.Rodrigues(r.reshape(3, 1))[0]
    np.testing.assert_allclose(R, want_R, rtol=0, atol=1e-12)
    np.testing.assert_allclose(vision.rodrigues_inverse(R),
                               cv2.Rodrigues(want_R)[0], rtol=0, atol=1e-12)


def test_triangulate_points():
    """cv2.triangulatePoints' output bit for bit, through K and with noise;
    float32 points give float32 output, as OpenCV's do."""
    rng, X, R, _, t = scene(1)
    P0 = K @ np.eye(4)[:3]
    P1 = K @ np.concatenate([R, t[:, None]], 1)
    p0 = project(np.eye(3), np.zeros(3), X).T
    p1 = project(R, t, X).T + rng.normal(0, 0.5, (2, len(X)))
    got = vision.triangulate_points(P0, P1, p0, p1)
    want = cv2.triangulatePoints(P0, P1, p0, p1)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    a, b = p0.astype(np.float32), p1.astype(np.float32)
    want = cv2.triangulatePoints(P0, P1, a, b)
    got = vision.triangulate_points(P0, P1, a, b)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert vision.triangulate_points(P0, P1, p0[:, :0], p1[:, :0]).shape \
        == (4, 0)


@pytest.mark.parametrize("use_guess", [False, True])
def test_solve_pnp_ransac(use_guess):
    rng, X, R, rvec, tvec = scene(2)
    img = project(R, tvec, X)
    out = rng.random(len(X)) < 0.3
    img[out] = rng.uniform([0, 0], [320, 240], (out.sum(), 2))
    guess = (rvec + 0.02, tvec.reshape(3, 1) + 0.05) if use_guess else (
        None, None)
    ok, r, t, inl = vision.solve_pnp_ransac(X, img, K, *guess,
                                            use_guess=use_guess,
                                            reproj_err=4.0, iters=100)
    assert ok
    np.testing.assert_allclose(r.ravel(), rvec, atol=1e-6)
    np.testing.assert_allclose(t.ravel(), tvec, atol=1e-6)
    err = np.linalg.norm(project(R, tvec, X) - img, axis=1)
    np.testing.assert_array_equal(inl.ravel(), np.nonzero(err < 4.0)[0])
    assert out.sum() > 40 and not set(inl.ravel()) & set(
        np.nonzero(out & (err >= 4.0))[0])
    # OpenCV on the same problem finds the same inliers.
    _, _, _, cv_inl = cv2.solvePnPRansac(X, img, K, None,
                                         reprojectionError=4.0,
                                         iterationsCount=100)
    np.testing.assert_array_equal(np.sort(cv_inl.ravel()), inl.ravel())


# ---------------------------------------------------------------------------
# PnP as cv2.solvePnPRansac computes it (OpenCV 5.0), and its numerics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [1, 7, 12345, 2**31 - 1])
def test_cv_rng_stream_is_opencvs(seed):
    """CvRNG(seed) draws what cv::theRNG() draws after cv::setRNGSeed(seed)
    (cv2.randu on int32 takes next() % range, in order)."""
    cv2.setRNGSeed(seed)
    want = np.zeros(64, np.int32)
    cv2.randu(want, 0, 1000)
    rng = vision.CvRNG(seed)
    assert [rng.uniform(0, 1000) for _ in range(64)] == want.tolist()


@pytest.mark.parametrize("shape", [(3, 3), (6, 4), (6, 3), (6, 5), (6, 6),
                                   (12, 12), (9, 2), (24, 7)])
def test_jacobi_svd_matches_opencv(shape):
    """jacobi_svd on A^T against cv2.SVDecomp(A), bit-equal: W, U, V^T on
    random, rank-deficient, zero-column and symmetric matrices (whose
    zero singular values take OpenCV's random vectors)."""
    rng = np.random.default_rng(shape[0] * 100 + shape[1])
    m, n = shape
    for kind in range(8):
        A = rng.normal(size=(m, n)) * 10.0 ** rng.uniform(-3, 3)
        if kind == 1:
            A[:, -1] = A[:, 0]
        elif kind == 2:
            A[:, rng.permutation(n)[:rng.integers(1, n)]] = 0.0
        elif kind == 3 and m == n:
            A = A @ A.T
        elif kind == 4 and m == n and n > 2:
            A[:, -2:] = 0.0
            A = A @ A.T
        w, u, vt = cv2.SVDecomp(A)
        W, Ut, Vt = vision.jacobi_svd(A.T[None])
        np.testing.assert_array_equal(W[0], w.ravel())
        np.testing.assert_array_equal(Ut[0].T, u)
        np.testing.assert_array_equal(Vt[0], vt)


def test_svd_solve_and_invert_match_opencv():
    """svd_solve and svd_invert against cv2.solve and cv2.invert with
    DECOMP_SVD, bit-equal, singular systems included."""
    rng = np.random.default_rng(3)
    for trial in range(40):
        m, n = [(6, 4), (6, 3), (6, 5), (6, 6), (3, 3)][trial % 5]
        A = rng.normal(size=(m, n))
        if trial % 4 == 0:
            A[:, -1] = 0.0
        b = rng.normal(size=(m, 1))
        _, x = cv2.solve(A, b, flags=cv2.DECOMP_SVD)
        np.testing.assert_array_equal(
            vision.svd_solve(A[None], b.T)[0], x.ravel())
        if m == n:
            _, inv = cv2.invert(A, flags=cv2.DECOMP_SVD)
            np.testing.assert_array_equal(vision.svd_invert(A[None])[0], inv)


def test_opencv_sums_are_opencvs():
    """The sums OpenCV and its OpenBLAS take, bit-equal: fma against exact
    rationals, gemm_at_b against cv2.gemm(GEMM_1_T) below and above
    OpenCV's 100-row BLAS threshold and across OpenBLAS's K blocks,
    mul_transposed against cv2.mulTransposed, norm_l2sqr against
    cv2.norm(NORM_L2SQR) on whole blocks of 16 (within 1e-15 relative
    where a shorter tail remains: only comparisons read it)."""
    from fractions import Fraction

    rng = np.random.default_rng(4)
    a, b, c = (rng.normal(size=500) * 10.0 ** rng.uniform(-5, 5, 500)
               for _ in range(3))
    exact = [float(Fraction(x) * Fraction(y) + Fraction(z))
             for x, y, z in zip(a, b, c)]
    np.testing.assert_array_equal(vision.fma(a, b, c), exact)
    for n in (6, 15, 16, 17, 32, 99, 100, 127, 128, 129, 255, 256, 300,
              1001, 2000):
        e = rng.normal(size=n) * 10.0 ** rng.uniform(-3, 3)
        J = rng.normal(size=(n, 6)) * 10.0 ** rng.uniform(-2, 2)
        want = cv2.norm(e[:, None], cv2.NORM_L2SQR)
        if n % 16:
            assert abs(vision.norm_l2sqr(e) - want) <= 1e-15 * want
        else:
            assert vision.norm_l2sqr(e) == want
        np.testing.assert_array_equal(
            vision.gemm_at_b(J, e),
            cv2.gemm(J, e[:, None], 1, None, 0, flags=cv2.GEMM_1_T).ravel())
        np.testing.assert_array_equal(vision.mul_transposed(J),
                                      cv2.mulTransposed(J, True))


def test_rodrigues_and_projection_bit_equal():
    """rodrigues, rodrigues_inverse and _rodrigues' derivative against
    cv2.Rodrigues, _project and its derivative against cv2.projectPoints
    (float64 and float32 points), all bit-equal."""
    rng = np.random.default_rng(5)
    rvecs = np.concatenate([rng.normal(0, 1, (40, 3)),
                            [[0, 0, 0], [1e-17, 0, 0], [np.pi, 0, 0],
                             [0, 3.1, 0.2], [1e-6, -2e-6, 3e-7]]])
    X = np.stack([rng.uniform(-3, 3, 50), rng.uniform(-2, 2, 50),
                  rng.uniform(4, 8, 50)], 1)
    for r in rvecs:
        R, J = cv2.Rodrigues(r.reshape(3, 1))
        np.testing.assert_array_equal(vision.rodrigues(r), R)
        np.testing.assert_array_equal(vision._rodrigues(r)[1][0], J)
        np.testing.assert_array_equal(vision.rodrigues_inverse(R),
                                      cv2.Rodrigues(R)[0])
        t = rng.normal(0, 0.3, 3)
        for pts in (X, X.astype(np.float32)):
            want, dp = cv2.projectPoints(pts, r, t, K, None)
            uv, dj = vision._project(pts.astype(np.float64), R[None], t[None],
                                     K, J[None])
            np.testing.assert_array_equal(
                uv[0].astype(pts.dtype), want.reshape(-1, 2))
            np.testing.assert_array_equal(dj[0].reshape(-1, 6), dp[:, :6])


def pnp_scene(seed, n, noise, outliers, planar=False):
    """n points seen by a camera near the origin, pixels with Gaussian
    noise and a share of them replaced by uniform outliers."""
    rng = np.random.default_rng(seed)
    z = np.full(n, 5.0) if planar else rng.uniform(4, 8, n)
    X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), z], 1)
    rvec, tvec = rng.normal(0, 0.1, 3), rng.normal(0, 0.3, 3)
    img = project(vision.rodrigues(rvec), tvec, X) + rng.normal(
        0, noise, (n, 2))
    out = rng.random(n) < outliers
    img[out] = rng.uniform([0, 0], [320, 240], (out.sum(), 2))
    guess = (rvec + rng.normal(0, 0.02, 3), tvec + rng.normal(0, 0.05, 3))
    return X, img, guess


def assert_pnp_is_opencvs(X, img, guess, thr, iters, use_guess):
    """solve_pnp_ransac against cv2.solvePnPRansac(SOLVEPNP_ITERATIVE): the
    same ok, the same inliers, rvec and tvec within 1e-9 (where OpenCV
    fails without a guess its pose is undefined, and not compared)."""
    if use_guess:
        want = cv2.solvePnPRansac(
            X, img, K, None, guess[0].reshape(3, 1).copy(),
            guess[1].reshape(3, 1).copy(), True, iters, thr, 0.99, None,
            cv2.SOLVEPNP_ITERATIVE)
        got = vision.solve_pnp_ransac(X, img, K, *guess, use_guess=True,
                                      reproj_err=thr, iters=iters)
    else:
        want = cv2.solvePnPRansac(X, img, K, None, None, None, False, iters,
                                  thr, 0.99, None, cv2.SOLVEPNP_ITERATIVE)
        got = vision.solve_pnp_ransac(X, img, K, reproj_err=thr, iters=iters)
    assert got[0] == want[0]
    assert (got[3] is None) == (want[3] is None)
    if want[3] is not None:
        assert got[3].dtype == np.int32 and got[3].shape == want[3].shape
        np.testing.assert_array_equal(got[3], want[3])
    if want[0] or use_guess:
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-9)
        np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-9)
    return want[0]


# The callers' settings: (reprojectionError, iterationsCount, guess) of
# tracking the local map, loop verification, relocalization and vo_tracker.
PNP_SITES = ((4.0, 100, True), (5.0, 200, False), (5.0, 200, False),
             (3.0, 100, False))
PNP_SIZES = (5, 6, 7, 9, 12, 20, 35, 60, 100, 180, 300, 600, 1000)
PNP_GROUPS = 31    # of 10 scenes: 310


@pytest.mark.parametrize("group", range(PNP_GROUPS))
def test_solve_pnp_ransac_matches_opencv(group):
    """310 seeded scenes against cv2.solvePnPRansac: 5 to 1,000 points,
    every seventh on a plane, noise of 0 to 2 px, 0 to 60 % outliers, each
    caller's threshold, iterations and guess."""
    for k in range(10):
        s = group * 10 + k
        n = PNP_SIZES[s % len(PNP_SIZES)]
        thr, iters, use_guess = PNP_SITES[s % 4]
        X, img, guess = pnp_scene(s, n, (0.0, 0.5, 1.0, 2.0)[s // 4 % 4],
                                  (0.0, 0.15, 0.3, 0.45, 0.6)[s // 16 % 5],
                                  planar=s % 7 == 3)
        assert_pnp_is_opencvs(X, img, guess, thr, iters, use_guess)


@pytest.mark.parametrize("iters", [1, 2, 5, 30])
def test_solve_pnp_ransac_fails_as_opencv(iters):
    """Half outliers: with 1, 2 or 5 iterations OpenCV's RANSAC finds no
    sample of inliers and fails (ok False, no inliers); with 30 it finds
    one. The port does the same."""
    X, img, guess = pnp_scene(11, 60, 0.5, 0.5)
    ok = assert_pnp_is_opencvs(X, img, guess, 4.0, iters, False)
    assert ok == (iters == 30)
    assert_pnp_is_opencvs(X, img, guess, 4.0, iters, True)


# The low-parallax suite: the slow pan of the monocular room (ROADMAP
# Queue 3) as two-view scenes at 1200x680, f 600: 400 points at 3.5-6 m,
# a yaw of 0.02-0.08 rad, a mostly sideways baseline of 3-8 cm, 0.5 px of
# noise and 20 % outliers.
LOW_PARALLAX_SCENES = 100
K_PAN = np.array([[600.0, 0.0, 600.0], [0.0, 600.0, 340.0], [0.0, 0.0, 1.0]])


def pan_scene(seed, n=400):
    rng = np.random.default_rng(seed)
    z = rng.uniform(3.5, 6.0, n)
    px = rng.uniform([0, 0], [1200, 680], (n, 2))
    X = np.concatenate([(px - K_PAN[:2, 2]) / 600.0 * z[:, None],
                        z[:, None]], 1)
    axis = np.array([0.0, 1.0, 0.0]) + rng.normal(0, 0.1, 3)
    yaw = rng.uniform(0.02, 0.08) * rng.choice([-1, 1])
    R = vision.rodrigues(yaw * axis / np.linalg.norm(axis))
    d = np.array([rng.choice([-1.0, 1.0]), 0.0, 0.0]) + rng.normal(0, 0.3, 3)
    t = rng.uniform(0.03, 0.08) * d / np.linalg.norm(d)
    Xc = X @ R.T + t
    p0 = px + rng.normal(0, 0.5, (n, 2))
    p1 = Xc[:, :2] / Xc[:, 2:] * 600.0 + K_PAN[:2, 2] + rng.normal(
        0, 0.5, (n, 2))
    out = rng.random(n) < 0.2
    p1[out] = rng.uniform([0, 0], [1200, 680], (out.sum(), 2))
    return p0, p1, R, t


def pose_errors(R, t, R_est, t_est):
    """(rotation error, angle between the translations), in degrees."""
    rot = np.degrees(np.linalg.norm(cv2.Rodrigues(R_est @ R.T)[0]))
    c = t_est.ravel() @ t / np.linalg.norm(t_est) / np.linalg.norm(t)
    return rot, np.degrees(np.arccos(np.clip(c, -1.0, 1.0)))


def test_low_parallax_suite_against_opencv():
    """find_essential_mat + recover_pose against cv2.findEssentialMat +
    cv2.recoverPose on every scene of the suite: E, both masks, the count,
    R and t bit-equal."""
    for seed in range(LOW_PARALLAX_SCENES):
        p0, p1, _, _ = pan_scene(seed)
        assert_essential_is_opencvs(p0, p1, K_PAN, prob=0.999, threshold=1.0)


def test_find_essential_mat_is_deterministic_and_refuses_few_points():
    p0, p1, _, _ = pan_scene(0)
    a = vision.find_essential_mat(p0, p1, K_PAN)
    b = vision.find_essential_mat(p0, p1, K_PAN)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert a[1].dtype == np.uint8 and a[1].shape == (len(p0), 1)
    assert vision.find_essential_mat(p0[:4], p1[:4], K_PAN) == (None, None)


def assert_essential_is_opencvs(p0, p1, K_, **kw):
    """find_essential_mat against cv2.findEssentialMat(RANSAC) on the same
    points: E and mask bit-equal (on five points every root's E stacked;
    under five (None, None)). Where OpenCV finds a single E, recover_pose
    against cv2.recoverPose on it: the same count, R, t and mask, bit for
    bit. -> OpenCV's E."""
    args = [kw.get("prob", 0.999), kw.get("threshold", 1.0)]
    if "max_iters" in kw:
        args.append(kw["max_iters"])
    E, mask = cv2.findEssentialMat(p0, p1, K_, cv2.RANSAC, *args)
    got = vision.find_essential_mat(p0, p1, K_, **kw)
    if E is None:
        assert got == (None, None)
        return E
    assert got[0].shape == E.shape and got[1].dtype == mask.dtype == np.uint8
    np.testing.assert_array_equal(got[0], E)
    np.testing.assert_array_equal(got[1], mask)
    if E.shape == (3, 3):
        want = cv2.recoverPose(E, p0, p1, K_, mask=mask.copy())
        pose = vision.recover_pose(E, p0, p1, K_, mask=mask.copy())
        assert pose[0] == want[0]
        for a, b in zip(pose[1:], want[1:]):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    return E


def test_essential_and_recover_pose():
    """Noise-free correspondences with 20 % outliers: find_essential_mat
    and recover_pose equal OpenCV's bit for bit, the mask holds 0 and 1
    and keeps every inlier, and the cheirality test passes every inlier.
    (The pose is OpenCV's minimal-sample model, not a refit: on this
    narrow view it is 0.02 rad off the truth, for OpenCV as for the
    port.)"""
    rng, X, R, _, t = scene(3)
    p0 = project(np.eye(3), np.zeros(3), X)
    p1 = project(R, t, X)
    out = rng.random(len(X)) < 0.2
    p1[out] = rng.uniform([0, 0], [320, 240], (out.sum(), 2))
    assert_essential_is_opencvs(p0, p1, K, prob=0.999, threshold=1.0)
    E, mask = vision.find_essential_mat(p0, p1, K, prob=0.999, threshold=1.0)
    assert mask.shape == (len(X), 1) and mask.ravel()[~out].all()
    assert set(np.unique(mask)) <= {0, 1}
    n, _, _, pose_mask = vision.recover_pose(E, p0, p1, K, mask=mask)
    assert n >= (~out).sum() and pose_mask.ravel()[~out].all()


def two_view_scene(seed, n, noise, outliers, baseline=0.3, angle=0.1):
    """n points at 4-8 m seen from the origin and from a camera turned by
    about `angle` rad and moved by `baseline` m, pixels (f 260, 320x240)
    with Gaussian noise and a share replaced by uniform outliers."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                  rng.uniform(4, 8, n)], 1)
    R = vision.rodrigues(rng.normal(0, angle / 2, 3))
    t = rng.normal(size=3)
    t *= baseline / np.linalg.norm(t)
    p0 = project(np.eye(3), np.zeros(3), X) + rng.normal(0, noise, (n, 2))
    p1 = project(R, t, X) + rng.normal(0, noise, (n, 2))
    out = rng.random(n) < outliers
    p1[out] = rng.uniform([0, 0], [320, 240], (out.sum(), 2))
    return p0, p1


# (seed, points, noise px, outlier share, baseline m, angle rad)
ESSENTIAL_GROUPS = {
    "sizes": [(10, 8, 0.5, 0.0, 0.3, 0.1), (11, 60, 0.5, 0.15, 0.3, 0.1),
              (12, 400, 0.5, 0.15, 0.3, 0.1),
              (13, 2000, 0.5, 0.15, 0.3, 0.1)],
    "noise": [(20, 200, 0.0, 0.1, 0.3, 0.1), (21, 200, 0.25, 0.1, 0.3, 0.1),
              (22, 200, 1.0, 0.1, 0.3, 0.1)],
    "outliers": [(30, 300, 0.5, 0.0, 0.3, 0.1),
                 (31, 300, 0.5, 0.25, 0.3, 0.1),
                 (32, 300, 0.5, 0.5, 0.3, 0.1)],
    "rotation": [(40, 200, 0.3, 0.1, 1e-4, 0.1),
                 (41, 200, 0.0, 0.0, 1e-6, 0.2)],
    "five": [(50, 5, 0.0, 0.0, 0.3, 0.1), (51, 5, 0.5, 0.0, 0.05, 0.02),
             (52, 5, 0.0, 0.0, 0.01, 0.3)],
    "few": [(60, 4, 0.5, 0.0, 0.3, 0.1), (61, 1, 0.5, 0.0, 0.3, 0.1)],
}


@pytest.mark.parametrize("group", ["pan"] + list(ESSENTIAL_GROUPS))
def test_find_essential_mat_matches_opencv(group):
    """find_essential_mat (and recover_pose on its E) against OpenCV, bit
    for bit, on seeded scenes: the pan's low parallax, 8 to 2,000 points,
    0 to 1 px of noise, 0 to 50 % outliers, a near-pure rotation,
    exactly five points (every root's E, stacked) and fewer than five
    ((None, None))."""
    if group == "pan":
        for seed in range(3):
            p0, p1, _, _ = pan_scene(4000 + seed)
            assert_essential_is_opencvs(p0, p1, K_PAN)
        return
    for seed, n, noise, outliers, baseline, angle in ESSENTIAL_GROUPS[group]:
        p0, p1 = two_view_scene(seed, n, noise, outliers, baseline, angle)
        E = assert_essential_is_opencvs(p0, p1, K)
        if group == "five":
            assert E is not None and len(E) % 3 == 0 and len(E) > 3
        assert (E is None) == (group == "few")


def test_find_essential_mat_takes_opencvs_settings():
    """prob, threshold and max_iters reach the registrator as OpenCV's do:
    a loose and a tight threshold, a lower confidence, and iteration caps
    of 1 and 20 on half outliers."""
    p0, p1 = two_view_scene(70, 150, 0.7, 0.5)
    for kw in ({"threshold": 3.0}, {"threshold": 0.1}, {"prob": 0.9},
               {"max_iters": 1}, {"max_iters": 20}):
        assert_essential_is_opencvs(p0, p1, K, **kw)


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), baseline=st.sampled_from(
    [0.01, 0.02, 0.05, 0.1, 0.5]), angle=st.sampled_from([0.0, 0.02, 0.3]))
def test_five_point_solver(seed, baseline, angle):
    """The five-point kernel (EMEstimatorCallback::runKernel) on five exact
    correspondences at 4-6 m (a baseline of 1 cm there is nearly a pure
    rotation), in normalized coordinates: the roots' essential matrices
    that cv2.findEssentialMat returns stacked on exactly five points, as
    many and bit-equal, in OpenCV's order."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-2, 2, 5), rng.uniform(-1.5, 1.5, 5),
                  rng.uniform(4, 6, 5)], 1)
    axis = rng.normal(size=3)
    R = vision.rodrigues(angle * axis / np.linalg.norm(axis))
    t = rng.normal(size=3)
    t *= baseline / np.linalg.norm(t)
    Xc = X @ R.T + t
    x0, x1 = X[:, :2] / X[:, 2:], Xc[:, :2] / Xc[:, 2:]
    want, _ = cv2.findEssentialMat(x0, x1, np.eye(3), cv2.RANSAC, 0.999,
                                   1.0)
    E, owner = vision._em_kernel(x0[None], x1[None])
    assert (owner == 0).all()
    if want is None:
        assert len(E) == 0
        return
    assert E.shape == (len(want) // 3, 3, 3)
    np.testing.assert_array_equal(E.reshape(-1, 3), want)


@pytest.mark.parametrize("kind", ["random", "essential", "cut", "repeated"])
def test_solve_poly_matches_opencv(kind):
    """solve_poly against cv2.solvePoly(c, maxIters=300), bit for bit: the
    roots' real and imaginary parts in OpenCV's order, on random real
    polynomials of degree 1 to 10 (a zero constant term among them), on
    the five-point kernel's own degree-10 polynomials, where the leading
    coefficients are at most DBL_EPSILON (the degree cut, the missing
    roots 0), and with repeated roots (z^2, z^3, (z - 1)^2, (z - 1)^3,
    (z^2 + 1)^2, z^2 (z^4 + 1))."""
    rng = np.random.default_rng({"random": 1, "essential": 2, "cut": 3,
                                 "repeated": 4}[kind])
    polys = []
    if kind == "random":
        for deg in range(1, 11):
            for _ in range(3):
                c = rng.normal(size=deg + 1) * 10.0 ** rng.uniform(-3, 3)
                polys.append(c)
            polys.append(np.concatenate([[0.0], rng.normal(size=deg)]))
    elif kind == "essential":
        for seed in range(8):
            p0, p1 = two_view_scene(80 + seed, 5, 0.5, 0.0)
            x0, x1 = (vision._normalized(p, K) for p in (p0, p1))
            polys.append(vision._essential_polys(x0[None], x1[None])[2][0])
    elif kind == "cut":
        for cut in (1, 2, 4):
            c = rng.normal(size=11)
            c[11 - cut:] = rng.uniform(-1, 1, cut) * 1e-17
            polys.append(c)
    else:
        polys = [np.array(c, np.float64) for c in (
            [0, 0, 1], [0, 0, 0, 1], [1, -2, 1], [-1, 3, -3, 1],
            [1, 0, 2, 0, 1], [0, 0, 1, 0, 0, 0, 1])]
    for c in polys:
        want = cv2.solvePoly(c, maxIters=300)[1].reshape(-1, 2)
        re, im = vision.solve_poly(c[None])
        np.testing.assert_array_equal(re[0], want[:, 0])
        np.testing.assert_array_equal(im[0], want[:, 1])


def test_lu_solve_matches_opencv():
    """lu_solve against cv2.solve(..., DECOMP_LU), bit for bit: 10x10
    systems with ten right-hand sides (the kernel's), other sizes, and a
    singular one (x 0, as OpenCV leaves it)."""
    rng = np.random.default_rng(6)
    for m, k in ((10, 10), (10, 1), (4, 3), (7, 7)):
        A = rng.normal(size=(6, m, m)) * 10.0 ** rng.uniform(-3, 3)
        b = rng.normal(size=(6, m, k))
        A[0, :, -1] = A[0, :, 0]
        got = vision.lu_solve(A, b)
        for i in range(6):
            ok, x = cv2.solve(A[i], b[i], flags=cv2.DECOMP_LU)
            np.testing.assert_array_equal(got[i], x if ok else 0.0)


def test_jacobi_svd_full_rows_match_opencv():
    """jacobi_svd(..., urows=9) on the 5x9 epipolar systems against
    cv2.SVDecomp(SVD_FULL_UV): the nine rows of V^T bit for bit, the four
    past the rank OpenCV's random sign vectors; on general, rank-deficient
    (a repeated correspondence) and zero-row systems, one batch."""
    rng = np.random.default_rng(7)
    Q = rng.normal(size=(12, 5, 9))
    Q[3, 4] = Q[3, 1]
    Q[5, 2:] = 0.0
    Q[8] *= 1e-150
    got = vision.jacobi_svd(Q, urows=9)[1]
    for q, g in zip(Q, got):
        np.testing.assert_array_equal(g, cv2.SVDecomp(q,
                                                      flags=cv2.SVD_FULL_UV)[2])


def test_decompose_essential_mat_matches_opencv():
    """decompose_essential_mat against cv2.decomposeEssentialMat, bit for
    bit, on OpenCV's essential matrices of the pan scenes and on exact
    [t]x R."""
    rng = np.random.default_rng(8)
    mats = []
    for seed in range(10):
        p0, p1, R, t = pan_scene(5000 + seed)
        mats.append(cv2.findEssentialMat(p0, p1, K_PAN, cv2.RANSAC, 0.999,
                                         1.0)[0])
        R = vision.rodrigues(rng.normal(0, 0.3, 3))
        mats.append(skew(rng.normal(size=3)) @ R)
    for E in mats:
        R1, R2, t = cv2.decomposeEssentialMat(E)
        got = vision.decompose_essential_mat(E)
        np.testing.assert_array_equal(got[0], R1)
        np.testing.assert_array_equal(got[1], R2)
        np.testing.assert_array_equal(got[2], t.ravel())


def skew(t):
    return np.array([[0.0, -t[2], t[1]], [t[2], 0.0, -t[0]],
                     [-t[1], t[0], 0.0]])
@pytest.mark.parametrize("kind", ["full_rank", "essential", "zero_column"])
def test_svd3_matches_opencv(kind):
    """_svd3 gives cv2.SVDecomp's U, W and Vt bit for bit: on random
    matrices; on the essential matrices of the pan scenes, OpenCV's and
    the port's, whose two equal singular values and numerically zero third
    leave the vectors' order and signs to rounding; and where a column is
    zero (OpenCV's seeded random vector)."""
    rng = np.random.default_rng(11)
    mats = [rng.normal(size=(3, 3)) * 10.0 ** rng.uniform(-3, 3)
            for _ in range(200)]
    if kind == "essential":
        mats = []
        for seed in range(20):
            p0, p1, _, _ = pan_scene(1000 + seed)
            mats += [cv2.findEssentialMat(p0, p1, K_PAN, cv2.RANSAC, 0.999,
                                          1.0)[0],
                     vision.find_essential_mat(p0, p1, K_PAN)[0]]
    elif kind == "zero_column":
        for A in mats:
            A[:, rng.permutation(3)[:rng.integers(1, 4)]] = 0.0
    for A in mats:
        w, u, vt = cv2.SVDecomp(A)
        U, W, Vt = vision._svd3(A)
        np.testing.assert_array_equal(U, u)
        np.testing.assert_array_equal(W, w.ravel())
        np.testing.assert_array_equal(Vt, vt)


@pytest.mark.parametrize("source", ["opencv", "port", "opencv_no_mask"])
def test_recover_pose_matches_opencv(source):
    """recover_pose against cv2.recoverPose on the same essential matrix,
    points and mask (OpenCV's findEssentialMat's or the port's; or no
    mask) on the pan scenes, where few points pass the distance test and
    decompositions often tie: the same count, mask, R and t, bit for
    bit."""
    for seed in range(30):
        p0, p1, _, _ = pan_scene(2000 + seed)
        if source == "port":
            E, mask = vision.find_essential_mat(p0, p1, K_PAN)
        else:
            E, mask = cv2.findEssentialMat(p0, p1, K_PAN, cv2.RANSAC, 0.999,
                                           1.0)
        kw = {} if source == "opencv_no_mask" else {"mask": mask}
        n, R, t, m = vision.recover_pose(E, p0, p1, K_PAN,
                                         **{k: v.copy() for k, v in
                                            kw.items()})
        n_cv, R_cv, t_cv, m_cv = cv2.recoverPose(
            E, p0, p1, K_PAN, **{k: v.copy() for k, v in kw.items()})
        assert n == n_cv, seed
        assert m.dtype == m_cv.dtype and m.shape == m_cv.shape
        np.testing.assert_array_equal(m, m_cv)
        np.testing.assert_array_equal(R, R_cv)
        np.testing.assert_array_equal(t, t_cv)


@pytest.mark.parametrize("frame", ["normalized", "pixels"])
def test_triangulate_points_on_recover_pose_inputs(frame):
    """triangulate_points against cv2.triangulatePoints where recoverPose
    and the mono initialization call it ([I|0] and [R|t], in normalized
    coordinates or through K), points nearly at infinity included: the
    homogeneous points bit for bit."""
    for seed in range(10):
        p0, p1, _, _ = pan_scene(3000 + seed)
        E, mask = cv2.findEssentialMat(p0, p1, K_PAN, cv2.RANSAC, 0.999, 1.0)
        _, R, t, _ = cv2.recoverPose(E, p0, p1, K_PAN, mask=mask)
        P0, P1 = np.eye(4)[:3], np.concatenate([R, t], 1)
        a, b = p0.T, p1.T
        if frame == "normalized":
            a, b = (vision._normalized(p, K_PAN).T for p in (p0, p1))
        else:
            P0, P1 = K_PAN @ P0, K_PAN @ P1
        np.testing.assert_array_equal(vision.triangulate_points(P0, P1, a, b),
                                      cv2.triangulatePoints(P0, P1, a, b))


@pytest.fixture(scope="module")
def rendered_gray():
    img = splat_render(textured_world(seed=0), np.eye(3),
                       np.array([0.05, 0.02, 0.0]))
    u8 = (np.clip(np.transpose(img, (1, 2, 0)), 0, 1) * 255).astype(np.uint8)
    return cv2.cvtColor(u8, cv2.COLOR_RGB2GRAY)


# ---------------------------------------------------------------------------
# ORB against cv2.ORB_create
# ---------------------------------------------------------------------------

ORB_SIZES = [(320, 240), (600, 340), (640, 480), (752, 480), (1200, 680)]
ORB_IMAGES = ["rendered", "noise", "photograph"]
PHOTO = str(synth_replica.PHOTO)
# sha256 of ORB_PATTERN as little-endian int32, the bytes of
# bit_pattern_31_ in OpenCV's binary.
ORB_PATTERN_SHA256 = ("7e645581387b82784797e8adddb9b6f0"
                      "c12611859fda09ca8a9bec96d767a05f")
# float32 angles (degrees) whose steered tests move when cos and sin are
# taken by cosf / sinf rather than in double: found by a sweep of every
# seventh float32 in [0, 360) for a test point whose cvRound changes.
STEER_ANGLES = [7.257879257202148, 16.17616081237793, 23.137121200561523,
                26.962949752807617, 27.275827407836914, 27.34601593017578,
                29.22079849243164, 31.171630859375, 35.4180908203125,
                43.793182373046875, 69.16156005859375, 111.66106414794922,
                193.49879455566406, 234.5139923095703, 285.76043701171875,
                312.41204833984375]


def orb_image(kind, size, rendered_gray):
    """An 8-bit gray test image of `size` (w, h): the rendered frame or the
    photograph (grey by rgb_to_gray) resized, or seeded noise smoothed by
    a Gaussian of sigma 2 and stretched to 0-255."""
    w, h = size
    if kind == "rendered":
        return cv2.resize(rendered_gray, size, interpolation=cv2.INTER_LINEAR)
    if kind == "photograph":
        rgb = cv2.cvtColor(cv2.imread(PHOTO), cv2.COLOR_BGR2RGB)
        return cv2.resize(vision.rgb_to_gray(rgb), size,
                          interpolation=cv2.INTER_AREA)
    rng = np.random.default_rng(w * 1000 + h)
    noise = rng.integers(0, 256, (h, w)).astype(np.uint8)
    return cv2.normalize(cv2.GaussianBlur(noise, (0, 0), 2.0), None, 0, 255,
                         cv2.NORM_MINMAX)


def opencv_orb(gray, n):
    """cv2.ORB_create(n).detectAndCompute as vision.OrbFeatures."""
    kps, desc = cv2.ORB_create(nfeatures=n).detectAndCompute(gray, None)
    return vision.OrbFeatures(
        np.array([k.pt for k in kps], np.float32).reshape(-1, 2),
        desc if desc is not None else np.zeros((0, 32), np.uint8),
        np.array([k.response for k in kps], np.float32),
        np.array([k.angle for k in kps], np.float32),
        np.array([k.octave for k in kps], np.int32))


def assert_same_features(got, want):
    """Equal keypoints, responses, angles and descriptors, bit for bit and
    row for row in the order returned."""
    for name in vision.OrbFeatures._fields:
        x, y = getattr(got, name), getattr(want, name)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        np.testing.assert_array_equal(x, y, err_msg=name)


def test_orb_pattern_is_opencvs():
    p = vision.ORB_PATTERN
    assert p.shape == (256, 4) and np.abs(p).max() == 13
    np.testing.assert_array_equal(p[0], [8, -3, 9, 5])
    np.testing.assert_array_equal(p[1], [4, 2, 7, -12])
    np.testing.assert_array_equal(p[-1], [-1, -6, 0, -11])
    table = p.astype("<i4").tobytes()
    assert hashlib.sha256(table).hexdigest() == ORB_PATTERN_SHA256
    binary = sorted(Path(cv2.__file__).parent.glob("cv2*.so"))
    assert binary and binary[0].read_bytes().count(table) == 1


def level_moments(gray):
    """(m01, m10) of every FAST corner at least 31 px inside each pyramid
    level of `gray` (ORB's intensity centroid) -> two int64 arrays."""
    du, dv = vision._tables(torch.device("cpu"))[:2]
    m01, m10 = [], []
    for im in vision.pyramid(torch.from_numpy(gray.astype(np.int32))):
        H, W = im.shape
        e = vision.EDGE_THRESHOLD
        if H <= 2 * e or W <= 2 * e:
            continue
        ys, xs = torch.nonzero(vision.fast_scores(im)[e:H - e, e:W - e],
                               as_tuple=True)
        patch = vision._window_sums(im, ys + e, xs + e, dv, du)
        m01.append((patch * dv).sum(1))
        m10.append((patch * du).sum(1))
    return torch.cat(m01).numpy(), torch.cat(m10).numpy()


def test_fast_atan2_matches_opencv(rendered_gray):
    """Every moment pair of the test images' FAST corners, and the axes,
    the diagonals and 0 / 0: bit-equal to cv2.fastAtan2."""
    pairs = [(0, 0), (0, 5), (5, 0), (0, -5), (-5, 0), (7, 7), (-7, 7),
             (7, -7), (-7, -7), (1, 3000000), (-3000000, 1)]
    for kind in ORB_IMAGES:
        for size in ORB_SIZES:
            m01, m10 = level_moments(orb_image(kind, size, rendered_gray))
            pairs += list(zip(m01.tolist(), m10.tolist()))
    pairs = np.unique(np.array(pairs, np.int64), axis=0)
    assert len(pairs) > 20000
    y, x = (torch.from_numpy(pairs[:, i].astype(np.float32)) for i in (0, 1))
    got = vision.fast_atan2(y, x).numpy()
    want = np.array([cv2.fastAtan2(float(a), float(b)) for a, b in pairs],
                    np.float32)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32 and (got >= 0).all() and (got < 360).all()


def test_orb_level_blur_matches_opencv(rendered_gray):
    """Each pyramid level of each test image, every pixel, against
    cv2.sepFilter2D with getGaussianKernel(7, 2, CV_32F) and
    BORDER_REFLECT_101 (the float path that ORB's in-place blur takes)."""
    k = cv2.getGaussianKernel(7, 2, ktype=cv2.CV_32F)
    np.testing.assert_array_equal(np.array(vision.BLUR_TAPS, np.float32),
                                  k.ravel())
    for kind in ORB_IMAGES:
        for size in ORB_SIZES:
            gray = orb_image(kind, size, rendered_gray)
            for im in vision.pyramid(torch.from_numpy(gray.astype(np.int32))):
                level = im.numpy().astype(np.uint8)
                want = cv2.sepFilter2D(level, -1, k, k,
                                       borderType=cv2.BORDER_REFLECT_101)
                got = vision.orb_level_blur(im).numpy()
                np.testing.assert_array_equal(got, want,
                                              err_msg=f"{kind} {size}")


def test_orb_steering_matches_opencv(monkeypatch):
    """Descriptors of keypoints at STEER_ANGLES, computed by OpenCV's ORB
    from the given keypoints, bit-equal to orb_descriptors: the steering
    takes cos and sin in double, as OpenCV does. Steering through the C
    library's float cosf and sinf would miss some of them."""
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (480, 640)).astype(np.uint8)
    n = 20 * len(STEER_ANGLES)
    xs, ys = 40 + np.arange(n) % 28 * 20, 40 + np.arange(n) // 28 * 20
    angles = np.array(STEER_ANGLES * 20, np.float32)
    kps = [cv2.KeyPoint(float(x), float(y), 31.0, float(a), 0.0, 0)
           for x, y, a in zip(xs, ys, angles)]
    kps_cv, desc = cv2.ORB_create().compute(img, kps)
    assert len(kps_cv) == n
    np.testing.assert_array_equal([k.angle for k in kps_cv], angles)
    blurred = vision.orb_level_blur(torch.from_numpy(img.astype(np.int32)))
    got = vision.orb_descriptors(blurred, torch.from_numpy(ys),
                                 torch.from_numpy(xs),
                                 torch.from_numpy(angles)).numpy()
    np.testing.assert_array_equal(got, desc)
    # The steering's cos and sin equal libm's double cos and sin, rounded.
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    for name in ("cosf", "sinf"):
        getattr(libm, name).restype = ctypes.c_float
        getattr(libm, name).argtypes = [ctypes.c_float]
    rad = angles[:len(STEER_ANGLES)] * np.float32(np.pi / 180)
    a, b = vision.orb_steering(torch.from_numpy(angles[:len(STEER_ANGLES)]))
    np.testing.assert_array_equal(a.numpy(), np.cos(rad.astype(np.float64))
                                  .astype(np.float32))
    np.testing.assert_array_equal(b.numpy(), np.sin(rad.astype(np.float64))
                                  .astype(np.float32))
    af = np.array([libm.cosf(float(r)) for r in rad], np.float32)
    bf = np.array([libm.sinf(float(r)) for r in rad], np.float32)
    assert ((af != a.numpy()) | (bf != b.numpy())).all()
    single = {float(t): (torch.tensor(c), torch.tensor(s))
              for t, c, s in zip(angles, af, bf)}
    monkeypatch.setattr(vision, "orb_steering", lambda ang: tuple(
        torch.stack(x) for x in zip(*(single[float(t)] for t in ang))))
    miss = vision.orb_descriptors(blurred, torch.from_numpy(ys),
                                  torch.from_numpy(xs),
                                  torch.from_numpy(angles)).numpy()
    assert (miss != desc).any(1).sum() > 0


def test_orb_steering_matches_double_trig():
    """orb_steering's own double cos and sin, rounded to float32, equal
    numpy's on 100,000 float32 angles in [0, 360)."""
    angles = np.random.default_rng(0).uniform(0, 360, 100000).astype(
        np.float32)
    rad = (angles * np.float32(np.pi / 180)).astype(np.float64)
    a, b = vision.orb_steering(torch.from_numpy(angles))
    np.testing.assert_array_equal(a.numpy(), np.cos(rad).astype(np.float32))
    np.testing.assert_array_equal(b.numpy(), np.sin(rad).astype(np.float32))


def test_orb_harris_tie_kept_as_opencv():
    """A level whose budget cuts between two equal float32 Harris
    responses keeps both, as OpenCV's retainBest does; their integer
    scores 25 (ab - c^2) - (a + b)^2 differ, so a ranking by those would
    keep one."""
    rng = np.random.default_rng(1600)
    noise = rng.integers(0, 256, (340, 600)).astype(np.uint8)
    gray = cv2.normalize(cv2.GaussianBlur(noise, (0, 0), 3.0), None, 0, 255,
                         cv2.NORM_MINMAX)
    got = vision.orb_detect_and_compute(gray, 2000, "cpu")
    assert_same_features(got, opencv_orb(gray, 2000))
    budget = vision.level_budget(2000)
    on2 = got.level == 2
    assert on2.sum() == budget[2] + 1
    resp = np.sort(got.resp[on2])
    assert resp[0] == resp[1]
    tied = np.nonzero(on2 & (got.resp == resp[0]))[0]
    s = float(vision.level_scales()[2])
    xs, ys = (torch.from_numpy(np.rint(got.px[tied, i] / s).astype(np.int64))
              for i in (0, 1))
    level = vision.pyramid(torch.from_numpy(gray.astype(np.int32)))[2]
    a, b, c = vision.harris_sums(level, ys, xs)
    rank = 25 * (a * b - c * c) - (a + b) * (a + b)
    assert len(tied) == 2 and rank[0] != rank[1]


@pytest.mark.parametrize("n", [500, 1000, 2000])
@pytest.mark.parametrize("kind", ORB_IMAGES)
@pytest.mark.parametrize("size", ORB_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_orb_bit_equal_to_opencv(size, kind, n, rendered_gray):
    gray = orb_image(kind, size, rendered_gray)
    got = vision.orb_detect_and_compute(gray, n, "cpu")
    want = opencv_orb(gray, n)
    assert len(want.px) >= min(n, 800) * 0.9
    assert_same_features(got, want)


@pytest.mark.parametrize("kind", chip_smoke.RETAIN_KINDS)
@pytest.mark.parametrize("n", chip_smoke.RETAIN_SIZES)
def test_retain_best_matches_libstdcpp(n, kind):
    """The shim (csrc_host/retain_best.cpp, libstdc++'s nth_element and
    partition) against retain_best_plain, index for index, for each k of
    chip_smoke's retainBest cases; both keep the k best and the ties with
    the k-th, and nothing else."""
    r, ks = chip_smoke.retain_case(n, kind)
    for k in ks:
        got = vision.retain_best(r, k)
        want = vision.retain_best_plain(r, k)
        assert got.dtype == want.dtype == np.int64
        np.testing.assert_array_equal(got, want, err_msg=f"k={k}")
        if k >= n:
            np.testing.assert_array_equal(got, np.arange(n))
        elif k == 0:
            assert len(got) == 0
        else:
            kth = np.sort(r)[::-1][k - 1]
            assert sorted(got.tolist()) == np.nonzero(r >= kth)[0].tolist()
            assert (r[got[:k - 1]] >= r[got[k - 1]]).all()


@pytest.mark.parametrize("n", chip_smoke.RETAIN_KILLERS)
def test_retain_best_past_the_depth_limit(n):
    """On chip_smoke's depth killers nth_element runs out of depth and
    takes the heap select, the same way again on the frozen values, and
    the shim keeps what retain_best_plain keeps, index for index."""
    for k in (1, 5, n // 4, n // 2):
        r, ran_out = chip_smoke.depth_killer(vision, n, k - 1)
        values = r.tolist()
        assert ran_out and vision.nth_element_plain(
            list(range(n)), k - 1, lambda x, y: values[x] > values[y])
        np.testing.assert_array_equal(vision.retain_best(r, k),
                                      vision.retain_best_plain(r, k),
                                      err_msg=f"k={k}")


def test_retain_best_build_failure_raises(tmp_path, monkeypatch):
    """A shim that does not build raises with g++'s output, from
    retain_best and from ORB: there is no fallback to the plain twin or
    to another order."""
    from photo_slam_tpu_torch import native

    src = tmp_path / "retain_best.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setitem(native.SOURCES, "retain_best", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    native._lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="native build failed"):
            vision.retain_best(np.ones(4, np.float32), 2)
        with pytest.raises(RuntimeError, match="retain_best.cpp"):
            vision.orb_detect_and_compute(
                orb_image("noise", (320, 240), None), 500, "cpu")
    finally:
        native._lib.cache_clear()
    assert not list((tmp_path / "build").glob("*.so"))


def test_retain_best_order_is_opencvs():
    """On a level's FAST corners in raster order, retain_best's order is
    the one cv2.ORB_create returns: the photograph's level 0 at 1000
    features, cut to 2n by FAST score and to n by Harris response, gives
    OpenCV's level-0 keypoints index for index; a sort by response would
    not."""
    rgb = cv2.cvtColor(cv2.imread(PHOTO), cv2.COLOR_BGR2RGB)
    gray = vision.rgb_to_gray(rgb)
    n = vision.level_budget(1000)[0]
    im = torch.from_numpy(gray.astype(np.int32))
    e = vision.EDGE_THRESHOLD
    score = vision.fast_scores(im)
    inner = torch.zeros_like(score)
    inner[e:-e, e:-e] = score[e:-e, e:-e]
    ys, xs = torch.nonzero(inner, as_tuple=True)
    keep = torch.from_numpy(vision.retain_best(inner[ys, xs].numpy(), 2 * n))
    ys, xs = ys[keep], xs[keep]
    resp = vision.harris_response(*vision.harris_sums(im, ys, xs)).numpy()
    keep = vision.retain_best(resp, n)
    got = np.stack([xs.numpy()[keep], ys.numpy()[keep]], 1)
    want = opencv_orb(gray, 1000)
    np.testing.assert_array_equal(got, want.px[want.level == 0])
    by_resp = np.argsort(-resp[keep], kind="stable")
    assert not np.array_equal(got[by_resp], got)


def test_orb_fixture_digest_is_opencvs():
    """chip_smoke.py holds the card's ORB of the photograph against this
    constant on the card's machine (no OpenCV there): OpenCV's features of
    the same grey image hash to it, and so do the port's on the CPU."""
    from photo_slam_tpu_torch.io import images

    rgb = images.read_png(PHOTO)[..., :3]
    np.testing.assert_array_equal(rgb, cv2.cvtColor(cv2.imread(PHOTO),
                                                    cv2.COLOR_BGR2RGB))
    gray = vision.rgb_to_gray(rgb)
    n = chip_smoke.ORB_FIXTURE_FEATURES
    assert chip_smoke.orb_digest(opencv_orb(gray, n)) == \
        chip_smoke.ORB_SHA256
    assert chip_smoke.orb_digest(vision.orb_detect_and_compute(
        gray, n, "cpu")) == chip_smoke.ORB_SHA256


def test_orb_matches_opencv(rendered_gray):
    """The rendered 320x240 frame at 1000 features: OpenCV's keypoints,
    responses, angles and descriptors exactly, index for index in
    OpenCV's order: level by level, and within a level the order that
    retainBest leaves, which is not raster order."""
    f = vision.orb_detect_and_compute(rendered_gray, 1000, "cpu")
    assert len(f.px) > 300 and f.desc.shape == (len(f.px), 32)
    assert f.desc.dtype == np.uint8 and f.px.dtype == np.float32
    want = opencv_orb(rendered_gray, 1000)
    assert_same_features(f, want)
    np.testing.assert_array_equal(f.px, want.px)
    assert (np.diff(f.level) >= 0).all()
    key = f.level.astype(np.float64) * 1e7 + f.px[:, 1] * 1e3 + f.px[:, 0]
    assert not (np.diff(key) > 0).all()
    assert (np.bincount(f.level, minlength=8)
            <= np.array(vision.level_budget(1000)) + 5).all()
    # Level-0 keypoints lie on whole pixels, at least 31 from the edge.
    p0 = f.px[f.level == 0]
    assert (p0 == np.round(p0)).all() and p0.min() >= 31
    assert (p0[:, 0] < 320 - 31).all() and (p0[:, 1] < 240 - 31).all()

def test_orb_descriptors_match_themselves_under_motion(rendered_gray):
    """A one-pixel shift of the image moves every keypoint by one pixel and
    keeps most descriptors within a few bits."""
    f0 = vision.orb_detect_and_compute(rendered_gray, 500, "cpu")
    shifted = np.zeros_like(rendered_gray)
    shifted[:, 1:] = rendered_gray[:, :-1]
    f1 = vision.orb_detect_and_compute(shifted, 500, "cpu")
    a = {tuple(p): i for i, p in enumerate(f0.px[f0.level == 0])}
    pairs = [(a[(x - 1, y)], i) for i, (x, y) in
             enumerate(f1.px[f1.level == 0]) if (x - 1, y) in a]
    assert len(pairs) >= 0.8 * (f0.level == 0).sum()
    bits = np.unpackbits(f0.desc[[i for i, _ in pairs]]
                         ^ f1.desc[[j for _, j in pairs]], axis=1).sum(1)
    assert np.median(bits) <= 8, np.median(bits)


def test_orb_is_deterministic_and_takes_tensors(rendered_gray):
    a = vision.orb_detect_and_compute(rendered_gray, 500, "cpu")
    b = vision.orb_detect_and_compute(torch.from_numpy(rendered_gray), 500,
                                      torch.device("cpu"))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    empty = vision.orb_detect_and_compute(np.zeros((240, 320), np.uint8),
                                          500, "cpu")
    assert empty.px.shape == (0, 2) and empty.desc.shape == (0, 32)


if __name__ == "__main__":
    # The low-parallax suite's errors and essential-matrix times on the
    # CPU, for OpenCV and the port:
    #   python tests/test_torch_vision.py [scenes]
    import sys
    import time

    scenes = int(sys.argv[1]) if len(sys.argv) > 1 else LOW_PARALLAX_SCENES
    runs = {
        "opencv": (lambda p0, p1, K: cv2.findEssentialMat(
            p0, p1, K, cv2.RANSAC, 0.999, 1.0), cv2.recoverPose),
        "port": (vision.find_essential_mat, vision.recover_pose)}
    for name, (essential, pose) in runs.items():
        errors, seconds = [], 0.0
        for seed in range(scenes):
            p0, p1, R, t = pan_scene(seed)
            t0 = time.perf_counter()
            E, mask = essential(p0, p1, K_PAN)
            seconds += time.perf_counter() - t0
            _, R_est, t_est, _ = pose(E, p0, p1, K_PAN, mask=mask)
            errors.append(pose_errors(R, t, R_est, t_est))
        med, p90 = np.median(errors, 0), np.percentile(errors, 90, 0)
        print(f"{name}: {scenes} scenes, rotation error median {med[0]:.4f}"
              f" p90 {p90[0]:.4f} deg, translation direction median "
              f"{med[1]:.3f} p90 {p90[1]:.3f} deg, essential matrix "
              f"{1e3 * seconds / scenes:.2f} ms a call (CPU)", flush=True)
