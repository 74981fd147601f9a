"""The port's own vision functions (photo_slam_tpu_torch/tracking/vision.py)
against OpenCV's, on seeded numpy inputs.

Tolerances: rgb_to_gray bit-equal to cv2.cvtColor; rodrigues within 1e-12;
triangulate_points within 1e-9 relative (dehomogenized); solve_pnp_ransac
on noise-free correspondences with 30 % outliers: the pose within 1e-6 and
the inliers exactly the points within the threshold; find_essential_mat +
recover_pose: R within 1e-6 rad, the direction of t within 1e-6. ORB on a
320x240 rendered frame: at least 80 % of the port's level-0 keypoints within
1 px of one of cv2.ORB's, the orientations of those within 5 degrees for at
least 90 %, and the 256-pair table fixed under its seed."""
import numpy as np
import pytest
import torch

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
