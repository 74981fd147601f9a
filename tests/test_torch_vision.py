"""The port's own vision functions (photo_slam_tpu_torch/tracking/vision.py)
against OpenCV's, on seeded numpy inputs.

Tolerances: rgb_to_gray bit-equal to cv2.cvtColor; rodrigues within 1e-12;
triangulate_points within 1e-9 relative (dehomogenized); solve_pnp_ransac
on noise-free correspondences with 30 % outliers: the pose within 1e-6 and
the inliers exactly the points within the threshold; find_essential_mat +
recover_pose: R within 1e-6 rad, the direction of t within 1e-6. The
five-point solver on exact minimal samples: one solution equal to the true
essential matrix within 1e-8 (up to sign), every solution on det(E) = 0 and
2 E E^T E - tr(E E^T) E = 0 within 1e-9. On the low-parallax suite
(LOW_PARALLAX_SCENES scenes of a slow pan), the port's median rotation and
translation-direction errors at most 1.5x OpenCV's. _svd3 against
cv2.SVDecomp within 1e-12 (bit-equal at a zero singular value);
recover_pose on OpenCV's own essential matrices: the same count, a
bit-equal mask, R and t within 1e-9; triangulate_points on recoverPose's
inputs within 1e-9 of the point's size. ORB on a
320x240 rendered frame: at least 80 % of the port's level-0 keypoints within
1 px of one of cv2.ORB's, the orientations of those within 5 degrees for at
least 90 %, and the 256-pair table fixed under its seed."""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

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
    rng, X, R, _, t = scene(1)
    P0 = K @ np.eye(4)[:3]
    P1 = K @ np.concatenate([R, t[:, None]], 1)
    p0 = project(np.eye(3), np.zeros(3), X).T
    p1 = project(R, t, X).T + rng.normal(0, 0.5, (2, len(X)))
    got = vision.triangulate_points(P0, P1, p0, p1)
    want = cv2.triangulatePoints(P0, P1, p0, p1)
    got, want = got[:3] / got[3], want[:3] / want[3]
    assert np.abs(got - want).max() <= 1e-9 * np.abs(want).max()


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


def test_essential_and_recover_pose():
    rng, X, R, _, t = scene(3)
    p0 = project(np.eye(3), np.zeros(3), X)
    p1 = project(R, t, X)
    out = rng.random(len(X)) < 0.2
    p1[out] = rng.uniform([0, 0], [320, 240], (out.sum(), 2))
    E, mask = vision.find_essential_mat(p0, p1, K, prob=0.999, threshold=1.0)
    assert mask.shape == (len(X), 1) and mask.ravel()[~out].all()
    n, R_est, t_est, pose_mask = vision.recover_pose(E, p0, p1, K, mask=mask)
    rot_err = np.linalg.norm(cv2.Rodrigues(R_est @ R.T)[0])
    assert rot_err < 1e-6
    dir_err = np.linalg.norm(t_est.ravel() / np.linalg.norm(t_est)
                             - t / np.linalg.norm(t))
    assert dir_err < 1e-6
    assert n >= (~out).sum() and pose_mask.ravel()[~out].all()
    # OpenCV's recoverPose on the port's essential matrix picks the same
    # decomposition.
    _, R_cv, t_cv, _ = cv2.recoverPose(E, p0, p1, K, mask=mask.copy())
    np.testing.assert_allclose(R_cv, R_est, atol=1e-9)
    np.testing.assert_allclose(t_cv, t_est, atol=1e-9)


def skew(t):
    return np.array([[0.0, -t[2], t[1]], [t[2], 0.0, -t[0]],
                     [-t[1], t[0], 0.0]])


def rounding_move(x0, x1, R, t):
    """How far the exact root of the rounded correspondences x0, x1 [5, 2]
    lies from the true [t]x R, to first order: the epipolar residuals of
    the truth over the smallest singular value of their Jacobian on the
    essential manifold (_epipolar_polish's)."""
    h0 = np.concatenate([x0, np.ones((5, 1))], 1)
    h1 = np.concatenate([x1, np.ones((5, 1))], 1)
    t = t / np.linalg.norm(t)
    Rx0 = h0 @ R.T
    c = np.cross(Rx0, h1)
    tangent = np.linalg.svd(t[None])[2][1:].T                    # [3, 2]
    J = np.concatenate([np.cross(Rx0, np.cross(h1, t)), c @ tangent], 1)
    return np.linalg.norm(c @ t) / np.linalg.svd(J)[1][-1]


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), baseline=st.sampled_from(
    [0.01, 0.02, 0.05, 0.1, 0.5]), angle=st.sampled_from([0.0, 0.02, 0.3]))
def test_five_point_solver(seed, baseline, angle):
    """Five exact correspondences at 4-6 m (a baseline of 1 cm there is
    nearly a pure rotation): one returned E is the true [t]x R within
    1e-8, and every returned E is an essential matrix. The rare draw whose
    own root moves further than 1e-8 under the rounding of its inputs
    (rounding_move) is held to ten times that move: no solver in double
    precision can do better there."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-2, 2, 5), rng.uniform(-1.5, 1.5, 5),
                  rng.uniform(4, 6, 5)], 1)
    axis = rng.normal(size=3)
    R = vision.rodrigues(angle * axis / np.linalg.norm(axis))
    t = rng.normal(size=3)
    t *= baseline / np.linalg.norm(t)
    Xc = X @ R.T + t
    x0, x1 = X[:, :2] / X[:, 2:], Xc[:, :2] / Xc[:, 2:]
    E, valid = vision._five_point(x0[None], x1[None])
    assert E.shape == (1, 10, 3, 3) and valid.shape == (1, 10)
    sols = E[0][valid[0]]
    assert 1 <= len(sols) <= 10
    want = skew(t) @ R
    want /= np.linalg.norm(want)
    err = min(min(np.abs(e - want).max(), np.abs(e + want).max())
              for e in sols)
    assert err <= max(1e-8, 10 * rounding_move(x0, x1, R, t)), err
    h0 = np.concatenate([x0, np.ones((5, 1))], 1)
    h1 = np.concatenate([x1, np.ones((5, 1))], 1)
    for e in sols:
        assert abs(np.linalg.norm(e) - 1.0) <= 1e-12
        assert abs(np.linalg.det(e)) <= 1e-9
        assert np.abs(2 * e @ e.T @ e - np.trace(e @ e.T) * e).max() <= 1e-9
        assert np.abs(np.einsum("ni,ij,nj->n", h1, e, h0)).max() <= 1e-9


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
    cv2.recoverPose on the same scenes: the port's median errors at most
    1.5x OpenCV's."""
    port, ocv = [], []
    for seed in range(LOW_PARALLAX_SCENES):
        p0, p1, R, t = pan_scene(seed)
        E, mask = vision.find_essential_mat(p0, p1, K_PAN, prob=0.999,
                                            threshold=1.0)
        _, R_est, t_est, _ = vision.recover_pose(E, p0, p1, K_PAN,
                                                 mask=mask)
        port.append(pose_errors(R, t, R_est, t_est))
        E, mask = cv2.findEssentialMat(p0, p1, K_PAN, cv2.RANSAC, 0.999, 1.0)
        _, R_est, t_est, _ = cv2.recoverPose(E, p0, p1, K_PAN, mask=mask)
        ocv.append(pose_errors(R, t, R_est, t_est))
    port, ocv = np.median(port, 0), np.median(ocv, 0)
    assert (port <= 1.5 * ocv).all(), (port, ocv)


def test_find_essential_mat_is_deterministic_and_refuses_few_points():
    p0, p1, _, _ = pan_scene(0)
    a = vision.find_essential_mat(p0, p1, K_PAN, seed=3)
    b = vision.find_essential_mat(p0, p1, K_PAN, seed=3)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert a[1].dtype == np.uint8 and a[1].shape == (len(p0), 1)
    assert vision.find_essential_mat(p0[:4], p1[:4], K_PAN) == (None, None)


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
    decompositions often tie: the same count, a bit-equal mask, R and t
    within 1e-9."""
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
        np.testing.assert_allclose(R, R_cv, rtol=0, atol=1e-9)
        np.testing.assert_allclose(t, t_cv, rtol=0, atol=1e-9)


@pytest.mark.parametrize("frame", ["normalized", "pixels"])
def test_triangulate_points_on_recover_pose_inputs(frame):
    """triangulate_points against cv2.triangulatePoints where recoverPose
    and the mono initialization call it ([I|0] and [R|t], in normalized
    coordinates or through K), points nearly at infinity included: the
    dehomogenized points within 1e-9 of each point's size."""
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
        got = vision.triangulate_points(P0, P1, a, b)
        want = cv2.triangulatePoints(P0, P1, a, b)
        got, want = got[:3] / got[3], want[:3] / want[3]
        size = np.maximum(np.abs(want).max(0), 1.0)
        assert (np.abs(got - want).max(0) <= 1e-9 * size).all(), seed


def test_brief_pattern_fixed_under_its_seed():
    pattern = vision.draw_pattern(vision.PATTERN_SEED)
    np.testing.assert_array_equal(pattern, vision.BRIEF_PATTERN)
    assert pattern.shape == (256, 4) and np.abs(pattern).max() <= 15
    assert (pattern[:, :2] != pattern[:, 2:]).any(1).all()
    assert not np.array_equal(vision.draw_pattern(vision.PATTERN_SEED + 1),
                              pattern)


@pytest.fixture(scope="module")
def rendered_gray():
    img = splat_render(textured_world(seed=0), np.eye(3),
                       np.array([0.05, 0.02, 0.0]))
    u8 = (np.clip(np.transpose(img, (1, 2, 0)), 0, 1) * 255).astype(np.uint8)
    return cv2.cvtColor(u8, cv2.COLOR_RGB2GRAY)


def orb_agreement(f, kps):
    """(share of the port's level-0 keypoints within 1 px of one of
    OpenCV's, share of those whose orientation is within 5 degrees)."""
    cv_px = np.array([k.pt for k in kps])
    cv_lvl = np.array([k.octave for k in kps])
    cv_ang = np.array([k.angle for k in kps])
    mine = f.level == 0
    d = np.linalg.norm(f.px[mine][:, None] - cv_px[cv_lvl == 0][None],
                       axis=2)
    near = d.min(1) <= 1.0
    j = d.argmin(1)
    dang = np.abs((f.angle[mine] - cv_ang[cv_lvl == 0][j] + 180) % 360
                  - 180)
    return near.mean(), (dang[near] < 5.0).mean()


def test_orb_matches_opencv(rendered_gray):
    f = vision.orb_detect_and_compute(rendered_gray, 1000, "cpu")
    kps, desc = cv2.ORB_create(nfeatures=1000).detectAndCompute(
        rendered_gray, None)
    assert len(f.px) > 300 and f.desc.shape == (len(f.px), 32)
    assert f.desc.dtype == np.uint8 and f.px.dtype == np.float32
    near, ang = orb_agreement(f, kps)
    assert near >= 0.8 and ang >= 0.9, (near, ang)
    # The per-level counts follow the budget as OpenCV's do.
    cv_lvl = np.array([k.octave for k in kps])
    counts = np.bincount(f.level, minlength=8)
    assert (counts <= np.array(vision.level_budget(1000)) + 5).all()
    assert abs(len(f.px) - len(kps)) <= 0.05 * len(kps), (
        counts, np.bincount(cv_lvl, minlength=8))
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
    # The low-parallax suite's errors and times on the CPU, for OpenCV,
    # the port and the port without its inlier refit (_ransac_essential's
    # winner as it stands):
    #   python tests/test_torch_vision.py [scenes]
    import sys
    import time

    scenes = int(sys.argv[1]) if len(sys.argv) > 1 else LOW_PARALLAX_SCENES
    t2 = (1.0 / 600.0) ** 2

    def no_refit(p0, p1, K):
        x0, x1 = vision._normalized(p0, K), vision._normalized(p1, K)
        E, err, _ = vision._ransac_essential(x0, x1, t2, 0.999, 1000, 0)
        return E, (err <= t2).astype(np.uint8).reshape(-1, 1)

    runs = {
        "opencv": (lambda p0, p1, K: cv2.findEssentialMat(
            p0, p1, K, cv2.RANSAC, 0.999, 1.0), cv2.recoverPose),
        "port": (vision.find_essential_mat, vision.recover_pose),
        "port without the refit": (no_refit, vision.recover_pose)}
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
