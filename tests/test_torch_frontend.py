"""The port's feature SLAM frontend (photo_slam_tpu_torch/tracking/
frontend.py) against the JAX package's, and the JAX tests' scenarios with
the port's own vision functions.

Held against JAX through the shared op stream: with OpenCV's functions
swapped into photo_slam_tpu_torch.tracking.vision (cv2_vision), the port's
and the JAX package's SlamFrontend see the same rendered sequences (RGB-D,
mono, and the out-and-back pan with injected drift that closes a loop) and
must give trajectories within 1e-9, the same keyframe ids and the same
MappingOperation stream: kinds, keyframes, point counts and payloads,
compared after the port's save_stream and the JAX load_stream.

With the port's own vision.py, the scenarios of tests/test_frontend.py,
tests/test_loop_closing.py and tests/test_multimap.py hold at their
thresholds. The sequences are rendered once per module at 320x240 by
splat_render, a numpy front-to-back blend of the JAX tests' splat worlds."""
import numpy as np
import pytest

from photo_slam_tpu.mapper import mapping_ops as jops
from photo_slam_tpu.models.camera import Camera as JCamera
from photo_slam_tpu.tracking.frontend import SlamFrontend as JFrontend
from photo_slam_tpu_torch.mapper import mapping_ops
from photo_slam_tpu_torch.mapper.mapping_ops import OprType
from photo_slam_tpu_torch.models.camera import PINHOLE, Camera
from photo_slam_tpu_torch.tracking import vision
from photo_slam_tpu_torch.tracking.frontend import (SlamFrontend,
                                                    match_descriptors)
from photo_slam_tpu_torch.tracking.gt_tracker import Frame
from photo_slam_tpu_torch.utils.evaluate import ate_rmse
from photo_slam_tpu_torch.utils.math import (se3_exp_numpy, se3_inverse,
                                             se3_log_numpy)
from photo_slam_tpu_torch.utils.sim3 import Sim3
from test_torch_blend import one_torch_thread  # noqa: F401

cv2 = pytest.importorskip("cv2")

W, H, F = 320, 240, 260.0
PLANE_Z = 5.0
CYL_R = 5.0
TRAJ_TOL = 1e-9


# ---------------------------------------------------------------------------
# Scenes (tests/test_frontend.py's and tests/test_loop_closing.py's worlds)
# ---------------------------------------------------------------------------

def make_camera(cls=Camera):
    return cls(camera_id=0, model_id=PINHOLE, width=W, height=H, fx=F, fy=F,
               cx=W / 2, cy=H / 2)


def textured_world(n=4000, seed=0, span=2.6):
    """Coloured splats on a plane at depth 5 with +-0.15 relief."""
    rng = np.random.RandomState(seed)
    span_x = PLANE_Z * W / (2 * F) * span
    span_y = PLANE_Z * H / (2 * F) * span
    pts = np.stack([rng.uniform(-span_x, span_x, n),
                    rng.uniform(-span_y, span_y, n),
                    np.full(n, PLANE_Z) + rng.uniform(-0.15, 0.15, n)], 1)
    return pts, rng.uniform(0.0, 1.0, (n, 3))


def cylinder_world(n=9000, seed=3):
    """Coloured splats on a cylinder of radius 5 around the camera."""
    rng = np.random.RandomState(seed)
    phi = rng.uniform(-2.2, 2.2, n)
    y = rng.uniform(-1.6, 1.6, n)
    r = CYL_R + rng.uniform(-0.1, 0.1, n)
    pts = np.stack([r * np.sin(phi), y, r * np.cos(phi)], 1)
    return pts, rng.uniform(0.0, 1.0, (n, 3))


def splat_render(world, R, t, cam=None, sigma=0.035, opacity=0.95):
    """[3, H, W] float32 through `cam` (default make_camera()): isotropic
    splats of world size `sigma`, blended front to back on black (alpha =
    opacity * gaussian, cut at 1/255)."""
    cam = cam or make_camera()
    W, H = cam.width, cam.height
    pts, cols = world
    xc = pts @ np.asarray(R).T + np.asarray(t)
    z = xc[:, 2]
    front = z > 0.05
    zs = np.where(front, z, 1.0)
    u = cam.fx * xc[:, 0] / zs + cam.cx
    v = cam.fy * xc[:, 1] / zs + cam.cy
    sig = cam.fx * sigma / zs
    r = np.ceil(3 * sig).astype(int)
    ok = front & (u > -r) & (u < W + r) & (v > -r) & (v < H + r)
    img = np.zeros((3, H, W))
    T = np.ones((H, W))
    for i in np.nonzero(ok)[0][np.argsort(z[ok], kind="stable")]:
        x0, x1 = max(int(u[i]) - r[i], 0), min(int(u[i]) + r[i] + 1, W)
        y0, y1 = max(int(v[i]) - r[i], 0), min(int(v[i]) + r[i] + 1, H)
        if x0 >= x1 or y0 >= y1:
            continue
        dx = np.arange(x0, x1) + 0.5 - u[i]
        dy = np.arange(y0, y1) + 0.5 - v[i]
        g = opacity * np.exp(-0.5 * (dy[:, None] ** 2 + dx[None] ** 2)
                             / sig[i] ** 2)
        a = np.where(g >= 1 / 255, np.minimum(g, 0.99), 0.0)
        img[:, y0:y1, x0:x1] += cols[i][:, None, None] * a * T[y0:y1, x0:x1]
        T[y0:y1, x0:x1] *= 1 - a
    return img.astype(np.float32)


def make_sequence(translations, depth=True, seed=0):
    """Frames of the textured plane from world->camera translations."""
    world = textured_world(seed=seed)
    frames, gt = [], []
    for i, t in enumerate(translations):
        T = np.eye(4)
        T[:3, 3] = t
        frames.append(Frame(
            image=splat_render(world, np.eye(3), t),
            quat_wxyz=np.array([1.0, 0, 0, 0]),
            trans=np.asarray(t, np.float64),
            depth=np.full((H, W), PLANE_Z, np.float32) if depth else None,
            filename=f"f{i}"))
        gt.append(T)
    return make_camera(), frames, np.array(gt)


def yaw(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]])


def cylinder_depth(R):
    """Analytic z-depth of the cylinder seen from the origin."""
    u, v = np.meshgrid(np.arange(W), np.arange(H))
    d_w = np.stack([(u - W / 2) / F, (v - H / 2) / F, np.ones_like(
        u, np.float64)], -1) @ R
    a = np.sqrt(d_w[..., 0] ** 2 + d_w[..., 2] ** 2)
    return (CYL_R / np.maximum(a, 1e-9)).astype(np.float32)


@pytest.fixture(scope="module")
def rgbd_sequence():
    return make_sequence([np.array([0.05 * i, 0.015 * i, 0.0])
                          for i in range(10)])


@pytest.fixture(scope="module")
def mono_sequence():
    return make_sequence([np.array([0.06 * i, 0.0, 0.0]) for i in range(8)],
                         depth=False)


@pytest.fixture(scope="module")
def pan_loop():
    """tests/test_loop_closing.py's yaw pan out (0 -> 1.15 rad) and back."""
    world = cylinder_world()
    yaws = list(np.linspace(0.0, 1.15, 9)) + list(np.linspace(1.0, 0.0, 8))
    frames, gt = [], []
    for i, a in enumerate(yaws):
        R = yaw(a)
        T = np.eye(4)
        T[:3, :3] = R
        frames.append(Frame(image=splat_render(world, R, np.zeros(3)),
                            quat_wxyz=np.array([1.0, 0, 0, 0]),
                            trans=np.zeros(3), depth=cylinder_depth(R),
                            filename=f"f{i}"))
        gt.append(T)
    return make_camera(), frames, np.array(gt)


# ---------------------------------------------------------------------------
# OpenCV's functions in vision.py (the JAX frontend's calls)
# ---------------------------------------------------------------------------

def cv2_orb(gray, nfeatures, device):
    kps, desc = cv2.ORB_create(nfeatures=nfeatures).detectAndCompute(gray,
                                                                     None)
    if desc is None or len(kps) == 0:
        return vision.OrbFeatures(
            np.zeros((0, 2), np.float32), np.zeros((0, 32), np.uint8),
            np.zeros(0, np.float32), np.zeros(0, np.float32),
            np.zeros(0, np.int32))
    return vision.OrbFeatures(
        np.array([k.pt for k in kps], np.float32), desc,
        np.array([k.response for k in kps], np.float32),
        np.array([k.angle for k in kps], np.float32),
        np.array([k.octave for k in kps], np.int32))


def cv2_pnp(obj, img, K, rvec0=None, tvec0=None, use_guess=False,
            reproj_err=8.0, iters=100, seed=0):
    if use_guess:
        return cv2.solvePnPRansac(
            obj, img, K, None, rvec=rvec0.copy(), tvec=tvec0.copy(),
            useExtrinsicGuess=True, reprojectionError=reproj_err,
            iterationsCount=iters, flags=cv2.SOLVEPNP_ITERATIVE)
    return cv2.solvePnPRansac(obj, img, K, None, reprojectionError=reproj_err,
                              iterationsCount=iters,
                              flags=cv2.SOLVEPNP_ITERATIVE)


@pytest.fixture
def cv2_vision(monkeypatch):
    for name, fn in {
            "rgb_to_gray": lambda u8: cv2.cvtColor(u8, cv2.COLOR_RGB2GRAY),
            "orb_detect_and_compute": cv2_orb,
            "rodrigues": lambda r: cv2.Rodrigues(
                np.asarray(r, np.float64).reshape(3, 1))[0],
            "rodrigues_inverse": lambda R: cv2.Rodrigues(
                np.asarray(R, np.float64))[0],
            "solve_pnp_ransac": cv2_pnp,
            "find_essential_mat": lambda p0, p1, K, prob, threshold:
                cv2.findEssentialMat(p0, p1, K, cv2.RANSAC, prob, threshold),
            "recover_pose": lambda E, p0, p1, K, mask=None: cv2.recoverPose(
                E, p0, p1, K, mask=mask),
            "triangulate_points": cv2.triangulatePoints}.items():
        monkeypatch.setattr(vision, name, fn)


# ---------------------------------------------------------------------------
# Held against the JAX frontend
# ---------------------------------------------------------------------------

def drift_late_keyframes(fe, from_kfid, drift_xi, scale=1.0):
    """tests/test_loop_closing.py::_drift_late_keyframes: move keyframes
    >= from_kfid and their points by a world similarity, severing the
    observations that cross the boundary."""
    T_w = se3_exp_numpy(drift_xi)
    Wd = Sim3(scale, T_w[:3, :3], T_w[:3, 3])
    W_inv = se3_inverse(T_w)

    def drift_pose(tcw):
        if scale == 1.0:
            return tcw @ W_inv
        d = Sim3(scale, tcw[:3, :3], scale * tcw[:3, 3]).compose(
            Wd.inverse())
        out = np.eye(4)
        out[:3, :3], out[:3, 3] = d.R, d.t
        return out

    m = fe.map
    n = m._n
    sel = (m.first_kf[:n] >= from_kfid) & m.alive[:n]
    m.xyz[:n][sel] = Wd.apply(m.xyz[:n][sel])
    for kfid, kf in m.keyframes.items():
        late = kfid >= from_kfid
        if late:
            kf.tcw = drift_pose(kf.tcw)
        for kp, mp in enumerate(kf.mp_ids):
            if mp >= 0 and (m.first_kf[mp] < from_kfid) == late:
                m.obs[mp].pop(kfid, None)
                m.n_obs[mp] = len(m.obs[mp])
                kf.mp_ids[kp] = -1
    fe.tcw = drift_pose(fe.tcw)


def run_loop_scenario(fe, frames, async_=False):
    """Outbound sweep without loop closing, drift at the turnaround, the
    return sweep with it. Returns the ops of the return sweep."""
    fe.enable_loop_closing = False
    for fr in frames[:9]:
        fe.process_frame(fr)
    if async_:
        fe.flush()
    mid = sorted(fe.map.keyframes)[len(fe.map.keyframes) - 2]
    drift_late_keyframes(fe, mid, np.array([0.5, -0.3, 0.4, 0, 0, 0.08]))
    fe.enable_loop_closing = True
    ops = []
    for fr in frames[9:]:
        ops.extend(fe.process_frame(fr))
    if async_:
        fe.flush()
        ops.extend(fe._apply_pending())
    return ops


def both_frontends(frames, kw, drive):
    """Run the JAX and the port's SlamFrontend (OpenCV's RNG seeded alike)
    through `drive(fe, frames)` -> ([jax ops], [port ops], jax, port)."""
    out = []
    for cls, cam, extra in ((JFrontend, make_camera(JCamera), {}),
                            (SlamFrontend, make_camera(), {"device": "cpu"})):
        cv2.setRNGSeed(7)
        fe = cls(cam, **kw, **extra)
        out.append((drive(fe, frames), fe))
    return out[0][0], out[1][0], out[0][1], out[1][1]


def assert_same_stream(tmp_path, jax_ops, port_ops):
    """The port's ops, written by its save_stream and read by the JAX
    load_stream, equal the JAX ops field by field (and the other way)."""
    assert [o.kind.value for o in port_ops] == [o.kind.value for o in jax_ops]
    mapping_ops.save_stream(tmp_path / "port.npz", port_ops)
    jops.save_stream(tmp_path / "jax.npz", jax_ops)
    for got, want in ((jops.load_stream(tmp_path / "port.npz"), jax_ops),
                      (mapping_ops.load_stream(tmp_path / "jax.npz"),
                       port_ops)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.kind.value == b.kind.value and a.scale == b.scale
            np.testing.assert_array_equal(a.points, b.points)
            np.testing.assert_array_equal(a.colors, b.colors)
            np.testing.assert_array_equal(a.transform, b.transform)
            assert [k.kfid for k in a.keyframes] == [k.kfid
                                                     for k in b.keyframes]
            for ka, kb in zip(a.keyframes, b.keyframes):
                assert (ka.is_loop_kf, ka.scale, ka.camera_id) == (
                    kb.is_loop_kf, kb.scale, kb.camera_id)
                np.testing.assert_allclose(ka.quat_wxyz, kb.quat_wxyz,
                                           rtol=0, atol=TRAJ_TOL)
                np.testing.assert_allclose(ka.trans, kb.trans, rtol=0,
                                           atol=TRAJ_TOL)
                for f in ("image", "aux_image", "kps_pixel",
                          "kps_point_local"):
                    x, y = getattr(ka, f), getattr(kb, f)
                    assert (x is None) == (y is None), f
                    if x is not None:
                        np.testing.assert_array_equal(x, y, err_msg=f)


def assert_same_run(jfe, tfe):
    assert len(jfe.trajectory) == len(tfe.trajectory)
    for a, b in zip(jfe.trajectory, tfe.trajectory):
        np.testing.assert_allclose(b, a, rtol=0, atol=TRAJ_TOL)
    assert sorted(tfe.map.keyframes) == sorted(jfe.map.keyframes)
    assert tfe.map.num_points == jfe.map.num_points
    assert tfe.num_loops_closed == jfe.num_loops_closed


def drive_all(fe, frames):
    return [op for fr in frames for op in fe.process_frame(fr)]


@pytest.mark.parametrize("sensor", ["rgbd", "mono"])
def test_parity_with_jax(sensor, rgbd_sequence, mono_sequence, cv2_vision,
                         tmp_path):
    _, frames, _ = rgbd_sequence if sensor == "rgbd" else mono_sequence
    kw = dict(sensor=sensor, kf_min_interval=1, kf_tracked_ratio=2.0)
    jops_, tops, jfe, tfe = both_frontends(frames, kw, drive_all)
    assert len(tops) >= 4 and len(tfe.map.keyframes) >= 4
    assert_same_run(jfe, tfe)
    assert_same_stream(tmp_path, jops_, tops)


def test_parity_with_jax_loop_closing(pan_loop, cv2_vision, tmp_path):
    _, frames, _ = pan_loop
    kw = dict(sensor="rgbd", kf_min_interval=1, kf_tracked_ratio=2.0,
              ba_window=4, loop_min_score=40, loop_min_inliers=20)
    jops_, tops, jfe, tfe = both_frontends(frames, kw, run_loop_scenario)
    assert tfe.num_loops_closed >= 1
    assert any(o.kind == OprType.LOOP_CLOSING_BA for o in tops)
    assert_same_run(jfe, tfe)
    assert_same_stream(tmp_path, jops_, tops)


# ---------------------------------------------------------------------------
# The JAX tests' scenarios with the port's own vision
# ---------------------------------------------------------------------------

def frontend(cam, **kw):
    return SlamFrontend(cam, device="cpu", **kw)


def max_pose_error(traj, gt):
    return max(np.abs(se3_log_numpy(traj[i] @ se3_inverse(gt[i]))).max()
               for i in range(len(gt)))


def test_match_descriptors():
    rng = np.random.RandomState(0)
    d = rng.randint(0, 256, (50, 32), dtype=np.uint8)
    ia, ib = match_descriptors(d, d, max_dist=10, ratio=0.9)
    assert len(ia) == 50
    np.testing.assert_array_equal(ia, ib)
    rng = np.random.RandomState(1)
    a = rng.randint(0, 256, (40, 32), dtype=np.uint8)
    b = rng.randint(0, 256, (40, 32), dtype=np.uint8)
    assert len(match_descriptors(a, b, max_dist=40, ratio=0.8)[0]) < 5


def test_refuses_what_waits_for_the_next_slice():
    cam = make_camera()
    for kw in ({"sensor": "stereo"}, {"use_imu": True}):
        with pytest.raises(NotImplementedError, match="stereo-inertial"):
            frontend(cam, **kw)
    cam.dist_coeffs = np.array([0.1, 0, 0, 0, 0], np.float32)
    with pytest.raises(NotImplementedError, match="stereo-inertial"):
        frontend(cam)


def test_pose_recovery(rgbd_sequence):
    cam, frames, gt = rgbd_sequence
    fe = frontend(cam, sensor="rgbd", kf_min_interval=1,
                  enable_loop_closing=False)
    for fr in frames:
        fe.process_frame(fr)
    assert len(fe.trajectory) == len(frames)
    assert max_pose_error(fe.trajectory, gt) < 0.03
    assert fe.tracked_frames == len(frames) - 1
    assert fe.lost_frames == 0 and fe.num_relocalizations == 0
    n = len(frames)
    for stage in ("orb", "match", "pnp"):
        assert len(fe.stage_times[stage]) == n
    assert all(t > 0 for t in fe.stage_times["orb"])
    assert len(fe.track_times) == n


def test_ops_map_growth_and_covisibility(rgbd_sequence):
    cam, frames, _ = rgbd_sequence
    fe = frontend(cam, sensor="rgbd", kf_min_interval=1,
                  kf_tracked_ratio=2.0, enable_loop_closing=False)
    ops = []
    fe.run(iter(frames), ops.append)
    assert fe.done and len(ops) >= 3
    for op in ops:
        assert op.kind == OprType.LOCAL_MAPPING_BA
        new_kfs = [k for k in op.keyframes if k.image is not None]
        assert len(new_kfs) == 1
        assert new_kfs[0].kps_pixel is not None
        assert new_kfs[0].kps_point_local is not None
    assert len(ops[0].points) > 50
    assert ops[0].points.shape == ops[0].colors.shape
    assert fe.map.num_points > 200 and len(fe.map.keyframes) >= 3
    kfs = sorted(fe.map.keyframes)
    assert kfs[-2] in fe.map.covisible_kfs(kfs[-1])
    assert fe.stage_times["ba"]


def test_mono_two_view_init_and_tracking(mono_sequence):
    cam, frames, gt = mono_sequence
    fe = frontend(cam, sensor="mono", kf_min_interval=1,
                  enable_loop_closing=False)
    ops = []
    for fr in frames:
        ops.extend(fe.process_frame(fr))
    assert fe.map.num_points > 50, "mono init failed"
    assert len(fe.map.keyframes) >= 2 and len(ops) >= 2
    for op in ops:
        assert all(kf.aux_image is None for kf in op.keyframes)
    est = np.array([se3_inverse(T)[:3, 3] for T in fe.trajectory])
    g = np.array([se3_inverse(T)[:3, 3] for T in gt])
    nonzero = np.linalg.norm(est, axis=1) > 1e-9
    assert nonzero.sum() >= 4
    assert ate_rmse(est[nonzero], g[nonzero]) < 0.05


def test_async_local_mapping_matches_sync_accuracy(rgbd_sequence):
    cam, frames, gt = rgbd_sequence
    fe = frontend(cam, sensor="rgbd", kf_min_interval=1,
                  kf_tracked_ratio=2.0, enable_loop_closing=False,
                  async_local_mapping=True)
    ops = []
    try:
        fe.run(iter(frames), ops.append)
    finally:
        fe.close()
    assert fe.done and len(ops) >= 3
    for op in ops:
        assert op.kind == OprType.LOCAL_MAPPING_BA
        assert len([k for k in op.keyframes if k.image is not None]) == 1
    assert len(ops[0].points) > 50
    assert max_pose_error(fe.trajectory, gt) < 0.03


def test_async_worker_exception_surfaces(rgbd_sequence):
    cam, frames, _ = rgbd_sequence
    fe = frontend(cam, sensor="rgbd", kf_min_interval=1,
                  kf_tracked_ratio=2.0, enable_loop_closing=False,
                  async_local_mapping=True)
    try:
        fe.process_frame(frames[0])
        fe.flush()
        fe._run_local_ba = None
        fe.process_frame(frames[1])
        fe.process_frame(frames[2])
        with pytest.raises(TypeError):
            fe.flush()
    finally:
        fe.close()


def test_relocalization_after_blackout(rgbd_sequence):
    cam, frames, gt = rgbd_sequence
    fe = frontend(cam, sensor="rgbd", kf_min_interval=1,
                  enable_loop_closing=False)
    for fr in frames[:5]:
        fe.process_frame(fr)
    black = Frame(image=np.zeros_like(frames[0].image),
                  quat_wxyz=np.array([1.0, 0, 0, 0]), trans=np.zeros(3),
                  depth=frames[0].depth, filename="black")
    for _ in range(3):
        fe.process_frame(black)
    fe.process_frame(frames[4])
    fe.process_frame(frames[5])
    assert np.abs(se3_log_numpy(fe.tcw @ se3_inverse(gt[5]))).max() < 0.05


def test_loop_detects_and_corrects_drift(pan_loop):
    cam, frames, _ = pan_loop
    fe = frontend(cam, sensor="rgbd", kf_min_interval=1,
                  kf_tracked_ratio=2.0, ba_window=4, loop_min_score=40,
                  loop_min_inliers=20)
    ops = run_loop_scenario(fe, frames)
    loop_ops = [o for o in ops if o.kind == OprType.LOOP_CLOSING_BA]
    assert fe.num_loops_closed >= 1 and loop_ops
    op = loop_ops[0]
    assert len(op.keyframes) <= len(fe.map.keyframes)
    assert any(k.is_loop_kf for k in op.keyframes)
    first = sorted(fe.map.keyframes)[0]
    loop_kf = max(k.kfid for k in op.keyframes if k.is_loop_kf)
    xi = se3_log_numpy(fe.map.keyframes[loop_kf].tcw
                       @ se3_inverse(fe.map.keyframes[first].tcw))
    assert np.abs(xi[:3]).max() < 0.15, f"loop not closed: residual {xi}"


@pytest.mark.slow
def test_submap_spawn_and_merge_on_revisit():
    """tests/test_multimap.py's scenario (slow there too)."""
    cam = make_camera()
    world = textured_world(seed=7)

    def frame(t, gt_pose, name):
        return Frame(image=splat_render(world, np.eye(3), t),
                     quat_wxyz=np.array([1.0, 0, 0, 0]) if gt_pose else None,
                     trans=t if gt_pose else None,
                     depth=np.full((H, W), PLANE_Z, np.float32),
                     filename=name)

    frames_a = [frame(np.array([0.06 * i, 0, 0]), True, f"a{i}")
                for i in range(6)]
    gts_b = [np.array([0.03 + 0.06 * i, 0, 0]) for i in range(5)]
    frames_b = [frame(t, False, f"b{i}") for i, t in enumerate(gts_b)]
    fe = frontend(cam, sensor="rgbd", kf_min_interval=1,
                  kf_tracked_ratio=2.0, ba_window=4, loop_min_score=40,
                  loop_min_inliers=20)
    fe.submap_after_lost = 5
    for fr in frames_a:
        fe.process_frame(fr)
    n_main = len(fe.map.keyframes)
    assert n_main >= 4
    for i in range(7):
        fe.process_frame(Frame(image=np.zeros((3, H, W), np.float32),
                               quat_wxyz=None, trans=None,
                               depth=np.full((H, W), PLANE_Z, np.float32),
                               filename=f"blank{i}"))
    assert len(fe._old_maps) == 1 and len(fe.map.keyframes) == 0
    ops = []
    for fr in frames_b:
        ops.extend(fe.process_frame(fr))
    assert any(o.kind == OprType.LOCAL_MAPPING_BA for o in ops)
    assert fe.num_maps_merged == 1 and not fe._old_maps
    assert len(fe.map.keyframes) > n_main
    merge_ops = [o for o in ops if o.kind == OprType.LOOP_CLOSING_BA]
    assert merge_ops
    errs = [np.linalg.norm(fe.map.keyframes[k].tcw[:3, 3] - t)
            for k, t in zip(sorted(x.kfid for x in merge_ops[0].keyframes),
                            gts_b) if k in fe.map.keyframes]
    assert errs and np.median(errs) < 0.05, errs
