"""The port's feature SLAM frontend (photo_slam_tpu_torch/tracking/
frontend.py) against the JAX package's, and the JAX tests' scenarios with
the port's own vision functions.

Held against JAX through the shared op stream: with OpenCV's functions
swapped into photo_slam_tpu_torch.tracking.vision and OpenCV's SGBM into
photo_slam_tpu_torch.ops.stereo (cv2_vision), the port's and the JAX
package's SlamFrontend see the same rendered sequences (RGB-D, mono, the
out-and-back pan with injected drift that closes a loop, a stereo-inertial
sequence with an exact 200 Hz IMU whose initialization emits a
SCALE_REFINEMENT, and the RGB-D sequence through a distorted camera) and
must give trajectories within 1e-9, the same keyframe ids and the same
MappingOperation stream: kinds, keyframes, point counts and payloads,
compared after the port's save_stream and the JAX load_stream.

With nothing of OpenCV swapped into the port (its own gray, ORB,
Rodrigues, PnP, SGM, essential matrix, recoverPose and triangulation, each
equal to OpenCV's), the RGB-D, monocular, distorted, loop-closing and
stereo-inertial runs and the OrbVoTracker on tests/test_tracking.py's
frames equal JAX's the same way, the JAX side on its own OpenCV run with
nothing reordered (test_parity_with_jax_own_vision,
test_vo_tracker_parity_with_jax_own_vision). With the port's
own vision.py, the scenarios of tests/test_frontend.py,
tests/test_loop_closing.py and tests/test_multimap.py hold at their
thresholds. The port's own ORB equals OpenCV's, in OpenCV's order: with it
and OpenCV's other functions, the port runs as the JAX frontend does on
cv2.ORB_create's features (test_parity_with_jax_own_orb). The
sequences are rendered once per module at 320x240 by splat_render, a numpy
front-to-back blend of the JAX tests' splat worlds."""
import numpy as np
import pytest

from photo_slam_tpu.mapper import mapping_ops as jops
from photo_slam_tpu.models.camera import Camera as JCamera
from photo_slam_tpu.tracking.frontend import SlamFrontend as JFrontend
from photo_slam_tpu_torch.io.datasets import imu_span
from photo_slam_tpu_torch.mapper import mapping_ops
from photo_slam_tpu_torch.mapper.mapping_ops import OprType
from photo_slam_tpu_torch.models.camera import PINHOLE, Camera
from photo_slam_tpu_torch.ops import stereo
from photo_slam_tpu_torch.tools import synth_euroc
from photo_slam_tpu_torch.tracking import vision
from photo_slam_tpu_torch.tracking.frontend import (SlamFrontend,
                                                    match_descriptors)
from photo_slam_tpu_torch.tracking.gt_tracker import Frame
from photo_slam_tpu_torch.tracking.imu import ImuCalib
from photo_slam_tpu_torch.utils.evaluate import ate_rmse
from photo_slam_tpu_torch.utils.math import (rotmat_to_quat_numpy,
                                             se3_exp_numpy, se3_inverse,
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


STEREO_B = 0.11       # stereo baseline (m): ~5.7 px of disparity on the plane
STEREO_HZ = 8         # frames 1/8 s apart: 10 keyframes span the 1 s the
#                       stereo-inertial initialization waits for


def stereo_pose(t):
    """(R world->camera, camera centre) at t seconds: a sway in front of
    the textured plane with a small yaw and pitch."""
    R = yaw(0.06 * np.sin(1.5 * t)) @ np.array(
        [[1, 0, 0], [0, np.cos(0.04 * np.sin(2.3 * t)),
                     -np.sin(0.04 * np.sin(2.3 * t))],
         [0, np.sin(0.04 * np.sin(2.3 * t)),
          np.cos(0.04 * np.sin(2.3 * t))]])
    c = np.array([0.3 * np.sin(1.2 * t), 0.1 * np.sin(2.1 * t),
                  0.15 * np.sin(0.9 * t)])
    return R, c


@pytest.fixture(scope="module")
def stereo_inertial_sequence():
    return stereo_inertial_frames()


def stereo_inertial_frames(n=14):
    """Stereo frames of the textured plane (right eye STEREO_B along the
    left's x axis) at STEREO_HZ with tools/synth_euroc.py's exact 200 Hz
    IMU along the same trajectory and EurocDataset's per-frame spans."""
    world = textured_world(seed=4)
    cam = make_camera()
    cam.stereo_bf = F * STEREO_B
    times_ns = [synth_euroc.T0_NS + int(round(i / STEREO_HZ * 1e9))
                for i in range(n)]
    stamps, gyro, acc = synth_euroc.imu_samples((n - 1) / STEREO_HZ,
                                                stereo_pose)
    frames, gt = [], []
    for i, ts in enumerate(times_ns):
        imu = imu_span(stamps * 1e-9, acc, gyro,
                       times_ns[i - 1] * 1e-9 if i else None, ts * 1e-9,
                       synth_euroc.IMU_HZ)
        R, c = stereo_pose(i / STEREO_HZ)
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = R, -R @ c
        frames.append(Frame(
            image=splat_render(world, R, -R @ c),
            quat_wxyz=rotmat_to_quat_numpy(R), trans=-R @ c,
            right=splat_render(world, R, -R @ (c + R.T @ [STEREO_B, 0, 0])),
            filename=f"f{i}", timestamp=ts * 1e-9, imu=imu))
        gt.append(T)
    return cam, frames, np.array(gt)


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
            reproj_err=8.0, iters=100):
    if use_guess:
        return cv2.solvePnPRansac(
            obj, img, K, None, rvec=rvec0.copy(), tvec=tvec0.copy(),
            useExtrinsicGuess=True, reprojectionError=reproj_err,
            iterationsCount=iters, flags=cv2.SOLVEPNP_ITERATIVE)
    return cv2.solvePnPRansac(obj, img, K, None, reprojectionError=reproj_err,
                              iterationsCount=iters,
                              flags=cv2.SOLVEPNP_ITERATIVE)


def swap_in_opencv(monkeypatch, orb=True):
    """OpenCV's functions in vision.py and its SGBM in stereo.py, as the
    JAX frontend calls them; with orb=False the port keeps its own ORB."""
    fns = {
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
        "triangulate_points": cv2.triangulatePoints}
    if not orb:
        del fns["orb_detect_and_compute"]
    for name, fn in fns.items():
        monkeypatch.setattr(vision, name, fn)
    monkeypatch.setattr(
        stereo, "disparity_u8", lambda left, right, device:
        cv2.StereoSGBM_create(minDisparity=0, numDisparities=128,
                              blockSize=5).compute(left, right).astype(
                                  np.float32) / 16.0)


@pytest.fixture
def cv2_vision(monkeypatch):
    swap_in_opencv(monkeypatch)


@pytest.fixture
def cv2_vision_own_orb(monkeypatch):
    swap_in_opencv(monkeypatch, orb=False)


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


def both_frontends(frames, kw, drive, cam_kw=None, calib=None):
    """Run the JAX and the port's SlamFrontend (OpenCV's RNG seeded alike)
    through `drive(fe, frames)` -> ([jax ops], [port ops], jax, port).
    `cam_kw` sets camera fields, `calib` an ImuCalib's fields."""
    from photo_slam_tpu.tracking.imu import ImuCalib as JImuCalib

    out = []
    for cls, cam, imu_cls, extra in (
            (JFrontend, make_camera(JCamera), JImuCalib, {}),
            (SlamFrontend, make_camera(), ImuCalib, {"device": "cpu"})):
        for k, v in (cam_kw or {}).items():
            setattr(cam, k, v)
        if calib is not None:
            extra = dict(extra, imu_calib=imu_cls(**calib))
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


@pytest.mark.parametrize("sensor", ["rgbd", "mono"])
def test_parity_with_jax_own_orb(sensor, rgbd_sequence, mono_sequence,
                                 cv2_vision_own_orb, tmp_path):
    """The port with its own ORB (OpenCV's other functions) against the JAX
    frontend on its own cv2.ORB_create, nothing reordered: the same run
    and the same op stream."""
    _, frames, _ = rgbd_sequence if sensor == "rgbd" else mono_sequence
    kw = dict(sensor=sensor, kf_min_interval=1, kf_tracked_ratio=2.0)
    jops_, tops, jfe, tfe = both_frontends(frames, kw, drive_all)
    assert type(jfe.orb).__name__ == "ORB"
    assert vision.orb_detect_and_compute.__module__ == vision.__name__
    assert len(tops) >= 4 and len(tfe.map.keyframes) >= 4
    assert_same_run(jfe, tfe)
    assert_same_stream(tmp_path, jops_, tops)


def test_parity_with_jax_stereo_inertial(stereo_inertial_sequence,
                                         cv2_vision, tmp_path):
    """sensor="stereo" with the IMU: depth from SGBM, preintegration, the
    visual-inertial initialization and its SCALE_REFINEMENT op (scale and
    gravity rotation), then IMU-predicted tracking."""
    cam, frames, _ = stereo_inertial_sequence
    kw = dict(sensor="stereo", kf_min_interval=1, kf_tracked_ratio=2.0,
              enable_loop_closing=False, use_imu=True)
    calib = dict(Tbc=np.eye(4), freq=200.0, **synth_euroc.IMU_NOISE)
    jops_, tops, jfe, tfe = both_frontends(
        frames, kw, drive_all, {"stereo_bf": cam.stereo_bf}, calib)
    assert tfe.imu_initialized and jfe.imu_initialized
    assert tfe.num_scale_refinements == jfe.num_scale_refinements >= 1
    refine = [o for o in tops if o.kind == OprType.SCALE_REFINEMENT]
    jrefine = [o for o in jops_
               if o.kind.value == OprType.SCALE_REFINEMENT.value]
    assert len(refine) == len(jrefine) >= 1
    for a, b in zip(refine, jrefine):
        assert abs(a.scale - b.scale) <= TRAJ_TOL
        np.testing.assert_allclose(a.transform, b.transform, rtol=0,
                                   atol=TRAJ_TOL)
    np.testing.assert_allclose(tfe.imu_bias.bg, jfe.imu_bias.bg, rtol=0,
                               atol=TRAJ_TOL)
    assert_same_run(jfe, tfe)
    assert_same_stream(tmp_path, jops_, tops)


def test_parity_with_jax_distorted_camera(rgbd_sequence, cv2_vision,
                                          tmp_path):
    """A radial-tangential camera: each frame (and its depth) goes through
    _rectify_frame's undistortion; the ops carry the raw image."""
    _, frames, _ = rgbd_sequence
    dist = np.array([0.012, -0.004, 0.0005, -0.0003, 0.0], np.float32)
    kw = dict(sensor="rgbd", kf_min_interval=1, kf_tracked_ratio=2.0)
    jops_, tops, jfe, tfe = both_frontends(frames, kw, drive_all,
                                           {"dist_coeffs": dist})
    assert tfe.camera.has_distortion and len(tfe.map.keyframes) >= 4
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


def own_vision_scenario(name, request):
    """(frames, frontend kwargs, drive, camera fields, IMU calibration) of
    the parity scenario `name`, as the tests above set it up."""
    kw = dict(sensor="rgbd", kf_min_interval=1, kf_tracked_ratio=2.0)
    if name == "rgbd":
        return request.getfixturevalue("rgbd_sequence")[1], kw, drive_all, \
            None, None
    if name == "mono":
        kw.update(sensor="mono")
        return request.getfixturevalue("mono_sequence")[1], kw, drive_all, \
            None, None
    if name == "distorted_camera":
        dist = np.array([0.012, -0.004, 0.0005, -0.0003, 0.0], np.float32)
        return request.getfixturevalue("rgbd_sequence")[1], kw, drive_all, \
            {"dist_coeffs": dist}, None
    if name == "loop_closing":
        kw.update(ba_window=4, loop_min_score=40, loop_min_inliers=20)
        return request.getfixturevalue("pan_loop")[1], kw, \
            run_loop_scenario, None, None
    cam, frames, _ = request.getfixturevalue("stereo_inertial_sequence")
    kw.update(sensor="stereo", enable_loop_closing=False, use_imu=True)
    return frames, kw, drive_all, {"stereo_bf": cam.stereo_bf}, \
        dict(Tbc=np.eye(4), freq=200.0, **synth_euroc.IMU_NOISE)


@pytest.mark.parametrize("name", ["rgbd", "mono", "distorted_camera",
                                  "loop_closing", "stereo_inertial"])
def test_parity_with_jax_own_vision(name, request, tmp_path):
    """The parity scenarios with nothing of OpenCV in the port: its own
    gray, ORB, Rodrigues, PnP, SGM, essential matrix, recoverPose and
    triangulation against the JAX frontend on its own OpenCV run, nothing
    reordered. The same trajectories within TRAJ_TOL, keyframes, points,
    loops and op stream."""
    frames, kw, drive, cam_kw, calib = own_vision_scenario(name, request)
    jops_, tops, jfe, tfe = both_frontends(frames, kw, drive, cam_kw, calib)
    assert type(jfe.orb).__name__ == "ORB"
    for fn in ("orb_detect_and_compute", "solve_pnp_ransac", "rodrigues",
               "rodrigues_inverse", "find_essential_mat", "recover_pose",
               "triangulate_points"):
        assert getattr(vision, fn).__module__ == vision.__name__, fn
    assert stereo.disparity_u8.__module__ == stereo.__name__
    assert len(tfe.map.keyframes) >= 4
    if name == "loop_closing":
        assert tfe.num_loops_closed >= 1
    if name == "stereo_inertial":
        assert tfe.imu_initialized and jfe.imu_initialized
        assert tfe.num_scale_refinements == jfe.num_scale_refinements >= 1
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
    """Nothing of the frontend waits for a later slice any more: the
    stereo sensor, the IMU and distorted cameras are accepted; a sensor
    the JAX frontend does not know is refused as there."""
    cam = make_camera()
    for kw in ({"sensor": "stereo"}, {"use_imu": True},
               {"sensor": "stereo", "use_imu": True}):
        fe = frontend(cam, **kw)
        assert fe.use_imu == kw.get("use_imu", False)
    cam.dist_coeffs = np.array([0.1, 0, 0, 0, 0], np.float32)
    assert frontend(cam).camera.has_distortion
    with pytest.raises(AssertionError):
        frontend(cam, sensor="stereo_inertial")


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


def centres(traj):
    return np.stack([se3_inverse(T)[:3, 3] for T in traj])


def test_stereo_inertial_tracking(stereo_inertial_sequence):
    """The stereo-inertial sequence with the port's own vision and SGM:
    every frame after the first tracked, ATE within the JAX stress tests'
    5 cm, the IMU initialized with scale 1 (stereo is metric) and a
    gravity rotation within 3 degrees of the truth (the first camera's
    frame is already gravity aligned), SGM timed per frame."""
    from photo_slam_tpu_torch.tracking.imu import so3_log

    cam, frames, gt = stereo_inertial_sequence
    fe = frontend(cam, sensor="stereo", kf_min_interval=1,
                  kf_tracked_ratio=2.0, enable_loop_closing=False,
                  use_imu=True, imu_calib=ImuCalib(
                      Tbc=np.eye(4), freq=200.0, **synth_euroc.IMU_NOISE))
    ops = [op for fr in frames for op in fe.process_frame(fr)]
    assert fe.tracked_frames == len(frames) - 1 and fe.lost_frames == 0
    assert ate_rmse(centres(fe.trajectory), centres(gt)) < 0.05
    refine = [o for o in ops if o.kind == OprType.SCALE_REFINEMENT]
    assert fe.imu_initialized and len(refine) == fe.num_scale_refinements
    assert refine[0].scale == 1.0
    angle = np.linalg.norm(so3_log(refine[0].transform[:3, :3].astype(
        np.float64)))
    assert np.degrees(angle) < 3.0
    assert len(fe.stage_times["sgm"]) == len(frames)
    assert all(t > 0 for t in fe.stage_times["sgm"])


def test_vo_tracker_parity_with_jax_own_vision():
    """tests/test_tracking.py's sequence through the JAX OrbVoTracker
    (OpenCV, its own cv2.ORB_create) and the port's with nothing of
    OpenCV swapped in: the same inlier counts and poses
    within TRAJ_TOL, frame by frame."""
    import test_tracking
    from photo_slam_tpu.tracking.gt_tracker import Frame as JFrame
    from photo_slam_tpu.tracking.vo_tracker import OrbVoTracker as JVo
    from photo_slam_tpu_torch.tracking.vo_tracker import OrbVoTracker

    jcam = test_tracking.make_camera()
    world = test_tracking.textured_world()
    kw = dict(num_features=1200, min_inliers=15, kf_min_interval=1)
    jvo, vo = JVo(jcam, **kw), OrbVoTracker(make_camera(), device="cpu", **kw)
    assert type(jvo.orb).__name__ == "ORB"
    for i in range(6):
        t = np.array([0.06 * i, 0.02 * i, 0.0])
        img = test_tracking.render_frame(world, t, jcam)
        depth = np.full((H, W), PLANE_Z, np.float32)
        fr = dict(image=img, quat_wxyz=np.array([1.0, 0, 0, 0]), trans=t,
                  depth=depth, filename=f"f{i}")
        a, b = jvo.track(JFrame(**fr)), vo.track(Frame(**fr))
        assert not b.lost and b.num_inliers == a.num_inliers
        assert b.is_keyframe == a.is_keyframe
    assert len(vo.trajectory) == len(jvo.trajectory) == 6
    for a, b in zip(jvo.trajectory, vo.trajectory):
        np.testing.assert_allclose(b, a, rtol=0, atol=TRAJ_TOL)


def test_vo_tracker_on_stereo_frames(stereo_inertial_sequence):
    """OrbVoTracker takes its depth from the port's SGM on stereo frames."""
    from photo_slam_tpu_torch.tracking.vo_tracker import OrbVoTracker

    cam, frames, gt = stereo_inertial_sequence
    vo = OrbVoTracker(cam, kf_min_interval=1, device="cpu")
    ops = [op for op in map(vo.process_frame, frames) if op is not None]
    assert ops and len(vo.trajectory) == len(frames)
    assert ate_rmse(centres(vo.trajectory), centres(gt)) < 0.05
