"""The online mapper's modules in the port against the JAX package, on the
same numpy inputs: the quaternion helpers, point_ops, depth_ops and the
map transforms (with their Adam-moment resets, not_transformed and the
moved count), dataset_config for every app, the GT tracker's operations,
.npz operation streams crossing both ways, the trainer's online LR, and
the op protocol (local BA, loop closing, scale refinement) applied to one
initialized state held by both mappers; then the port-only scenarios of
tests/test_mapper.py (densify, no opacity reset on the final iterations,
keep_training, record_loop_ply, the undistort mask, capacity growth).

Tolerances: float32 results of the same arithmetic in another order
within 1e-5 (1e-6 for unit quaternions), masks, counts and integer state
exact."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photo_slam_tpu import config as jconfig
from photo_slam_tpu.mapper import mapper as jmapper
from photo_slam_tpu.mapper import mapping_ops as jops
from photo_slam_tpu.mapper import trainer as jtrainer
from photo_slam_tpu.models import gaussian_model as jgm
from photo_slam_tpu.models import optimizer as joptim
from photo_slam_tpu.models import transforms as jxf
from photo_slam_tpu.models.camera import Camera as JCamera
from photo_slam_tpu.models.keyframe import Keyframe as JKeyframe
from photo_slam_tpu.models.scene import Scene as JScene
from photo_slam_tpu.ops import depth_ops as jdepth
from photo_slam_tpu.ops import point_ops as jpoint
from photo_slam_tpu.ops.camera_math import build_camera_matrices as jcam
from photo_slam_tpu.tracking import gt_tracker as jgt
from photo_slam_tpu.utils import math as jmath
from photo_slam_tpu_torch import config as tconfig
from photo_slam_tpu_torch.mapper import mapper as tmapper
from photo_slam_tpu_torch.mapper import mapping_ops as tops
from photo_slam_tpu_torch.mapper import trainer as ttrainer
from photo_slam_tpu_torch.models import gaussian_model as tgm
from photo_slam_tpu_torch.models import optimizer as toptim
from photo_slam_tpu_torch.models import transforms as txf
from photo_slam_tpu_torch.models.camera import PINHOLE, Camera
from photo_slam_tpu_torch.models.keyframe import Keyframe
from photo_slam_tpu_torch.models.scene import Scene
from photo_slam_tpu_torch.ops import depth_ops as tdepth
from photo_slam_tpu_torch.ops import point_ops as tpoint
from photo_slam_tpu_torch.ops.camera_math import build_camera_matrices as tcam
from photo_slam_tpu_torch.ops.render import RenderSettings, render
from photo_slam_tpu_torch.tracking import gt_tracker as tgt
from photo_slam_tpu_torch.utils import math as tmath
from test_mapper import gt_world, small_cfg
from test_torch_blend import one_torch_thread  # noqa: F401

W, H, F = 64, 48, 60.0
PLANE_Z = 5.0
FIELDS = tgm.GaussianParams._fields
RTOL = 1e-5
BACKGROUND = torch.full((3,), 0.1)


def t(x):
    return torch.from_numpy(np.asarray(x))


def close(got, want, atol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


def camera(cls=Camera):
    return cls(camera_id=0, model_id=PINHOLE, width=W, height=H, fx=F, fy=F,
               cx=W / 2, cy=H / 2)


def random_rotation(rng):
    q = rng.randn(4)
    return tmath.quat_to_rotmat_numpy(q / np.linalg.norm(q))


def render_frames(num=4, step=0.08, n=400):
    """test_mapper.make_frames's plane sequence, rendered by the port's
    dense oracle (host numpy frames both packages take), with a wavy depth
    map. The background is grey: a keypoint on an exactly black pixel puts
    its Gaussian's SH colour exactly on the clamp at 0, where XLA's fused
    multiply-add rounds just below it (no gradient) and torch lands on it
    (gradient, as the reference's `clamped` test, forward.cu:63-70, has
    it), and Adam turns that tie into a full step of difference."""
    pts, scales, quats, opac, cols = (t(x) for x in gt_world(n=n))
    cam = camera()
    settings = RenderSettings(width=W, height=H,
                              tan_fovx=float(np.tan(cam.fovx / 2)),
                              tan_fovy=float(np.tan(cam.fovy / 2)),
                              mode="dense")
    frames = []
    for i in range(num):
        trans = np.array([step * (i - num / 2), 0.0, 0.0])
        mats = tcam(np.eye(3), trans, 0.01, 100.0, cam.fovx, cam.fovy,
                    device="cpu")
        img = render(pts, scales, quats, opac, mats, settings, BACKGROUND,
                     colors_precomp=cols).image.numpy()
        # Depth varies over the image (distinct depths, so no two
        # keypoints tie in the blend order), with a corner without depth.
        v, u = np.mgrid[0:H, 0:W]
        depth = (PLANE_Z + 0.4 * np.sin(u / 9.0 + i) * np.cos(v / 7.0)
                 ).astype(np.float32)
        depth[:4, :6] = 0.0
        frames.append(dict(image=img, quat_wxyz=np.array([1.0, 0, 0, 0]),
                           trans=trans, depth=depth, filename=f"f{i:03d}"))
    return frames


def frames_for(gt_mod, frames):
    return [gt_mod.Frame(**f) for f in frames]


# ---------------------------------------------------------------------------
# Quaternion helpers, point_ops, depth_ops
# ---------------------------------------------------------------------------

def test_quaternion_helpers_match_jax():
    rng = np.random.RandomState(0)
    # Rotations that take each of rotmat_to_quat's four branches (trace
    # dominant, then near-pi turns about x, y and z), and random ones.
    Rs = [np.eye(3)] + [tmath.quat_to_rotmat_numpy(q) for q in
                        ([0.05, 1, 0.1, 0.1], [0.05, 0.1, 1, 0.1],
                         [0.05, 0.1, 0.1, 1])]
    Rs += [random_rotation(rng) for _ in range(60)]
    R = np.stack(Rs).astype(np.float32)
    got = tmath.rotmat_to_quat(t(R)).numpy()
    close(got, np.asarray(jmath.rotmat_to_quat(jnp.asarray(R))), 1e-6)
    a = rng.randn(50, 4).astype(np.float32)
    b = rng.randn(50, 4).astype(np.float32)
    close(tmath.quat_multiply(t(a), t(b)).numpy(),
          np.asarray(jmath.quat_multiply(jnp.asarray(a), jnp.asarray(b))),
          1e-6)


def view_of(R, trans):
    cam = camera()
    return (tcam(R, trans, 0.01, 100.0, cam.fovx, cam.fovy, device="cpu"),
            jcam(R, trans, 0.01, 100.0, cam.fovx, cam.fovy))


def test_point_ops_match_jax():
    rng = np.random.RandomState(1)
    n = 500
    pts = rng.uniform(-4, 6, (n, 3)).astype(np.float32)
    quats = rng.randn(n, 4).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = random_rotation(rng)
    T[:3, 3] = rng.randn(3)
    mask = rng.rand(n) < 0.6
    not_tr = rng.rand(n) < 0.8
    unstable = rng.rand(n) < 0.7
    tm, jm = view_of(random_rotation(rng).astype(np.float32),
                     np.array([0.2, -0.1, 0.3]))

    np.testing.assert_array_equal(
        tpoint.mark_visible(t(pts), tm.viewmatrix, tm.full_proj).numpy(),
        np.asarray(jpoint.mark_visible(jnp.asarray(pts), jm.viewmatrix,
                                       jm.full_proj)))
    close(tpoint.transform_points(t(pts), t(T)).numpy(),
          jpoint.transform_points(jnp.asarray(pts), jnp.asarray(T)))
    got = tpoint.scale_and_transform_points(t(pts), t(quats), t(T), t(mask),
                                            1.3)
    want = jpoint.scale_and_transform_points(
        jnp.asarray(pts), jnp.asarray(quats), jnp.asarray(T),
        jnp.asarray(mask), 1.3)
    for g, w in zip(got, want):
        close(g.numpy(), w)
    got = tpoint.scale_and_transform_then_mark_visible(
        t(pts), t(quats), t(not_tr), t(unstable), t(T), tm.viewmatrix,
        tm.full_proj, 0.8)
    want = jpoint.scale_and_transform_then_mark_visible(
        jnp.asarray(pts), jnp.asarray(quats), jnp.asarray(not_tr),
        jnp.asarray(unstable), jnp.asarray(T), jm.viewmatrix, jm.full_proj,
        0.8)
    close(got[0].numpy(), want[0])
    close(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert int(got[3]) == int(want[3]) > 0


def test_depth_ops_match_jax():
    rng = np.random.RandomState(2)
    u = rng.uniform(0, W, 200).astype(np.float32)
    v = rng.uniform(0, H, 200).astype(np.float32)
    d = rng.uniform(0.5, 8, 200).astype(np.float32)
    intr = (F, F * 1.1, W / 2 - 0.3, H / 2 + 0.7)
    close(tdepth.backproject_pinhole(t(u), t(v), t(d), *intr).numpy(),
          jdepth.backproject_pinhole(jnp.asarray(u), jnp.asarray(v),
                                     jnp.asarray(d), *intr))
    depth = rng.uniform(0.5, 8, (H, W)).astype(np.float32)
    mask = rng.rand(H, W) < 0.7
    close(tdepth.reproject_depth_map(t(depth), t(mask), *intr).numpy(),
          jdepth.reproject_depth_map(jnp.asarray(depth), jnp.asarray(mask),
                                     *intr))
    pix = np.stack([u, v], 1)
    has3d = rng.rand(200) < 0.5
    local = np.where(has3d[:, None], rng.uniform(-1, 1, (200, 3)), 0.0)
    local[:, 2] = np.where(has3d, d, 0.0)
    local = local.astype(np.float32)
    pts, ok = tdepth.mono_neighbor_densify(t(pix), t(has3d), t(local), 25.0,
                                           *intr)
    jpts, jok = jdepth.mono_neighbor_densify(
        jnp.asarray(pix), jnp.asarray(has3d), jnp.asarray(local), 25.0,
        *intr)
    close(pts.numpy(), jpts)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    assert 0 < int(ok.sum()) < 200   # some borrow, some find no donor


# ---------------------------------------------------------------------------
# Map transforms on a seeded state
# ---------------------------------------------------------------------------

def seeded_state(cap=64, n_live=40, seed=3):
    """(numpy params, live, exist_since_iter, m, v) of a seeded map with
    moments: unnormalized quats, SH degree 3."""
    rng = np.random.RandomState(seed)
    shapes = dict(xyz=(3,), features_dc=(1, 3), features_rest=(15, 3),
                  opacity_logit=(1,), log_scales=(3,), quats=(4,))
    params = {k: rng.randn(cap, *s).astype(np.float32)
              for k, s in shapes.items()}
    params["xyz"][:, 2] = rng.uniform(-1, 6, cap)
    live = np.zeros(cap, bool)
    live[rng.permutation(cap)[:n_live]] = True
    exist = rng.randint(0, 6, cap).astype(np.int32)
    m = {k: rng.randn(cap, *s).astype(np.float32) for k, s in shapes.items()}
    v = {k: rng.rand(cap, *s).astype(np.float32) for k, s in shapes.items()}
    return params, live, exist, m, v


def both_states(params, live, exist, m, v, step=3):
    ts = tgm.state_from_numpy(params, live, device="cpu",
                              exist_since_iter=exist)
    to = toptim.adam_from_numpy(m, v, step, device="cpu")
    def zeros():   # one buffer each: JAX donates them
        return jnp.zeros(live.shape[0], jnp.float32)

    js = jgm.GaussianState(
        params=jgm.GaussianParams(**{k: jnp.asarray(params[k])
                                     for k in FIELDS}),
        live=jnp.asarray(live), max_radii2d=zeros(), xyz_grad_accum=zeros(),
        denom=zeros(), exist_since_iter=jnp.asarray(exist))
    jo = joptim.AdamState(
        m=jgm.GaussianParams(**{k: jnp.asarray(m[k]) for k in FIELDS}),
        v=jgm.GaussianParams(**{k: jnp.asarray(v[k]) for k in FIELDS}),
        step=jnp.int32(step))
    return (ts, to), (js, jo)


def assert_maps_close(ts, to, js, jo, atol=RTOL):
    for k in FIELDS:
        close(getattr(ts.params, k).numpy(), getattr(js.params, k), atol)
        close(getattr(to.m, k).numpy(), getattr(jo.m, k), atol)
        close(getattr(to.v, k).numpy(), getattr(jo.v, k), atol)
    np.testing.assert_array_equal(ts.live.numpy(), np.asarray(js.live))


def test_apply_scaled_transformation_matches_jax():
    params, live, exist, m, v = seeded_state()
    (ts, to), (js, jo) = both_states(params, live, exist, m, v)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = random_rotation(np.random.RandomState(4))
    T[:3, 3] = [0.1, -0.2, 0.3]
    ts2, to2 = txf.apply_scaled_transformation(ts, to, t(T), 1.7)
    js2, jo2 = jxf.apply_scaled_transformation(js, jo, jnp.asarray(T),
                                               jnp.float32(1.7))
    assert ts2.params.xyz is ts.params.xyz   # updated in place
    assert_maps_close(ts2, to2, js2, jo2)
    # Live rows moved and their xyz, log_scales and quats moments are zero;
    # dead rows and the other groups' moments are untouched.
    assert not np.allclose(ts2.params.xyz.numpy()[live], params["xyz"][live])
    np.testing.assert_array_equal(ts2.params.xyz.numpy()[~live],
                                  params["xyz"][~live])
    for k in ("xyz", "log_scales", "quats"):
        assert not getattr(to2.m, k).numpy()[live].any()
        np.testing.assert_array_equal(getattr(to2.m, k).numpy()[~live],
                                      m[k][~live])
    np.testing.assert_array_equal(to2.m.features_dc.numpy(), m["features_dc"])


def test_scaled_transform_visible_points_matches_jax():
    params, live, exist, m, v = seeded_state(seed=5)
    (ts, to), (js, jo) = both_states(params, live, exist, m, v)
    rng = np.random.RandomState(6)
    not_tr = rng.rand(64) < 0.8
    diff = np.eye(4, dtype=np.float32)
    diff[:3, :3] = random_rotation(rng)
    diff[:3, 3] = [0.3, 0.0, -0.1]
    tm, jm = view_of(np.eye(3), np.zeros(3))
    ts2, to2, t_nt, t_num = txf.scaled_transform_visible_points_of_keyframe(
        ts, to, t(not_tr), t(diff), tm.viewmatrix, tm.full_proj, 2, 2, 1.1)
    js2, jo2, j_nt, j_num = jxf.scaled_transform_visible_points_of_keyframe(
        js, jo, jnp.asarray(not_tr), jnp.asarray(diff), jm.viewmatrix,
        jm.full_proj, jnp.int32(2), jnp.int32(2), jnp.float32(1.1))
    assert_maps_close(ts2, to2, js2, jo2)
    np.testing.assert_array_equal(t_nt.numpy(), np.asarray(j_nt))
    assert int(t_num) == int(j_num) > 0
    moved = not_tr & ~t_nt.numpy() & live
    assert moved.sum() == int(t_num)
    # Moved rows: xyz and rotation moments zeroed, the scales' kept.
    assert not to2.m.xyz.numpy()[moved].any()
    assert not to2.m.quats.numpy()[moved].any()
    np.testing.assert_array_equal(to2.m.log_scales.numpy(), m["log_scales"])


# ---------------------------------------------------------------------------
# Config, trainer LR, GT tracker, streams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("app", ["replica_rgbd", "replica_mono", "tum_rgbd",
                                 "tum_mono", "realsense_rgbd",
                                 "euroc_stereo", "colmap"])
def test_dataset_config_matches_jax(app):
    got, want = tconfig.dataset_config(app), jconfig.dataset_config(app)
    for group in ("model", "pipeline", "opt", "mapper", "record", "viewer",
                  "renderer"):
        assert (dataclasses.asdict(getattr(got, group))
                == dataclasses.asdict(getattr(want, group))), group


@pytest.mark.parametrize("online", [False, True])
def test_current_lrs_match_jax(online):
    cfg, jcfg = tconfig.Config(), jconfig.Config()
    for c in (cfg, jcfg):
        c.opt.position_lr_max_steps = 40
    tr = ttrainer.GaussianTrainer(cfg, Scene(), device="cpu")
    jt = jtrainer.GaussianTrainer(jcfg, JScene())
    kf, jkf = Keyframe(fid=3, camera=camera()), JKeyframe(
        fid=3, camera=camera(JCamera))
    for trainer in (tr, jt):
        trainer.online_lr = online
        trainer.spatial_lr_scale = 2.5
    for used, it in ((0, 7), (5, 100), (60, 3)):
        tr.sampler.use_counts[3] = jt.sampler.use_counts[3] = used
        tr.iteration = jt.iteration = it
        got, want = tr._current_lrs(kf), jt._current_lrs(jkf)
        for k in FIELDS:
            assert getattr(got, k) == pytest.approx(
                float(getattr(want, k)), rel=1e-6), (k, used, it)


def test_drop_keyframe_cache():
    tr = ttrainer.GaussianTrainer(tconfig.Config(), Scene(), device="cpu")
    kfs = []
    for fid in (0, 1):
        kf = Keyframe(fid=fid, camera=camera())
        kf.set_image(np.zeros((3, H, W), np.float32), 2, 1)
        kfs.append(kf)
        tr._device_gt(kf, 0)
        tr._device_gt(kf, 2)
    before = tr._gt_cache_bytes
    tr.drop_keyframe_cache(0)
    assert sorted(tr._gt_cache) == [(1, 0), (1, 2)]
    assert tr._gt_cache_bytes == before // 2


def jax_tracker_ops(frames, every=1, kps=100):
    tracker = jgt.GroundTruthTracker(camera(JCamera), keyframe_every=every,
                                     num_keypoints=kps)
    ops = []
    tracker.run(iter(frames_for(jgt, frames)), ops.append)
    return tracker, ops


def torch_tracker_ops(frames, every=1, kps=100):
    tracker = tgt.GroundTruthTracker(camera(), keyframe_every=every,
                                     num_keypoints=kps)
    ops = []
    tracker.run(iter(frames_for(tgt, frames)), ops.append)
    return tracker, ops


def assert_ops_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.kind.value == b.kind.value
        assert a.scale == b.scale
        for f in ("transform", "points", "colors"):
            close(getattr(a, f), getattr(b, f), 1e-6)
        assert len(a.keyframes) == len(b.keyframes)
        for x, y in zip(a.keyframes, b.keyframes):
            assert (x.kfid, x.camera_id, x.is_loop_kf, x.scale) == (
                y.kfid, y.camera_id, y.is_loop_kf, y.scale)
            for f in ("quat_wxyz", "trans", "image", "aux_image",
                      "kps_pixel", "kps_point_local"):
                if getattr(y, f) is None:
                    assert getattr(x, f) is None, f
                else:
                    close(getattr(x, f), getattr(y, f), 1e-6)


@pytest.fixture(scope="module")
def frames():
    return render_frames()


def test_gt_tracker_matches_jax(frames):
    (tt, t_ops), (jt, j_ops) = (torch_tracker_ops(frames, every=2, kps=90),
                                jax_tracker_ops(frames, every=2, kps=90))
    assert len(t_ops) == 2
    assert_ops_equal(t_ops, j_ops)
    assert tt.live_kf_ids == jt.live_kf_ids == {0, 1}
    assert tt.done and len(tt.track_times) == len(frames)
    # The corner without depth gives keypoints without 3D.
    kf = t_ops[0].keyframes[0]
    has3d = np.abs(kf.kps_point_local).sum(1) > 0
    assert 0 < has3d.sum() < len(has3d)
    assert len(t_ops[0].points) == has3d.sum()


def correction_ops(pkg_ops, base):
    """A LOOP_CLOSING_BA with per-keyframe Sim3 scales and a
    SCALE_REFINEMENT, built in the package of pkg_ops from base's first
    keyframe."""
    kf = base.keyframes[0]
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = tmath.quat_to_rotmat_numpy([0.99, 0.0, 0.1, 0.0])
    T[:3, 3] = [0.1, 0.0, 0.2]
    return [
        pkg_ops.MappingOperation(
            kind=pkg_ops.OprType.LOOP_CLOSING_BA, scale=1.0,
            keyframes=[pkg_ops.KeyframeData(
                kfid=kf.kfid, camera_id=0, quat_wxyz=kf.quat_wxyz,
                trans=kf.trans + [0.5, 0, 0], is_loop_kf=True, scale=1.07)],
            points=base.points[:40], colors=base.colors[:40]),
        pkg_ops.MappingOperation(kind=pkg_ops.OprType.SCALE_REFINEMENT,
                                 scale=2.0, transform=T),
    ]


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_streams_cross_packages(frames, tmp_path, direction):
    _, t_ops = torch_tracker_ops(frames)
    _, j_ops = jax_tracker_ops(frames)
    t_ops += correction_ops(tops, t_ops[0])
    j_ops += correction_ops(jops, j_ops[0])
    path = tmp_path / "ops.npz"
    if direction == "jax_to_port":
        jops.save_stream(path, j_ops)
        assert_ops_equal(tops.load_stream(path), j_ops)
    else:
        tops.save_stream(path, t_ops)
        assert_ops_equal(jops.load_stream(path), t_ops)


# ---------------------------------------------------------------------------
# The op protocol on one initialized state
# ---------------------------------------------------------------------------

def jax_initialized(frames):
    """test_mapper's TestOpProtocol._mapped on these frames: 4 keyframes,
    the map initialized and 3 training iterations (JAX tiled)."""
    mapper = jmapper.GaussianMapper(small_cfg(), jmapper.SensorType.RGBD)
    mapper.add_camera(camera(JCamera))
    for op in jax_tracker_ops(frames)[1]:
        mapper.queue.push(op)
    mapper.combine_mapping_operations()
    mapper.initialize_mapping()
    for _ in range(3):
        mapper.trainer.train_iteration()
    return mapper


def port_twin_cfg(jcfg):
    """The port's Config with the values of a JAX Config."""
    cfg = tconfig.Config()
    for group in ("opt", "mapper", "record", "renderer"):
        for k, v in dataclasses.asdict(getattr(jcfg, group)).items():
            setattr(getattr(cfg, group), k, v)
    return cfg


def port_twin(jm):
    """The port's mapper holding the JAX mapper's map, Adam state,
    keyframes and counters."""
    mapper = tmapper.GaussianMapper(port_twin_cfg(jm.cfg),
                                    tmapper.SensorType.RGBD, device="cpu")
    mapper.add_camera(camera())
    for fid, jkf in jm.scene.keyframes.items():
        kf = Keyframe(fid=fid, camera=mapper.scene.cameras[0],
                      znear=jkf.znear, zfar=jkf.zfar)
        kf.set_pose(jkf.quat, jkf.trans, device="cpu")
        kf.creation_iter = jkf.creation_iter
        kf.remaining_times_of_use = jkf.remaining_times_of_use
        kf.image = jkf.image
        mapper.scene.add_keyframe(kf)
    js, jo = jm.trainer.state, jm.trainer.opt_state
    tr = mapper.trainer
    tr.state = tgm.state_from_numpy(
        {k: np.asarray(getattr(js.params, k)) for k in FIELDS},
        np.asarray(js.live), device="cpu",
        max_radii2d=np.asarray(js.max_radii2d),
        xyz_grad_accum=np.asarray(js.xyz_grad_accum),
        denom=np.asarray(js.denom),
        exist_since_iter=np.asarray(js.exist_since_iter))
    tr.opt_state = toptim.adam_from_numpy(
        {k: np.asarray(getattr(jo.m, k)) for k in FIELDS},
        {k: np.asarray(getattr(jo.v, k)) for k in FIELDS}, int(jo.step),
        device="cpu")
    tr.iteration = jm.trainer.iteration
    tr.spatial_lr_scale = jm.trainer.spatial_lr_scale
    mapper.initial_mapped = jm.initial_mapped
    return mapper


def protocol_ops(kind, jm):
    """(JAX ops, port ops) of one protocol case on the JAX mapper's
    keyframes."""
    kf0, kf1 = jm.scene.keyframes[0], jm.scene.keyframes[1]
    rng = np.random.RandomState(9)
    pts = (rng.uniform(-1, 1, (40, 3)) + [0, 0, PLANE_Z]).astype(np.float32)
    cols = rng.uniform(0, 1, (40, 3)).astype(np.float32)

    def build(pkg):
        KD, MO, OT = pkg.KeyframeData, pkg.MappingOperation, pkg.OprType
        if kind == "local_ba":
            return [MO(kind=OT.LOCAL_MAPPING_BA, points=pts, colors=cols,
                       keyframes=[KD(kfid=0, camera_id=0, quat_wxyz=kf0.quat,
                                     trans=kf0.trans + [0.05, 0, 0])])]
        if kind == "loop_closing":
            return [MO(kind=OT.LOOP_CLOSING_BA, scale=1.0, keyframes=[
                KD(kfid=0, camera_id=0, quat_wxyz=kf0.quat,
                   trans=kf0.trans + [0.5, 0, 0])])]
        if kind == "loop_closing_sim3":
            return [MO(kind=OT.LOOP_CLOSING_BA, scale=1.0, keyframes=[
                KD(kfid=0, camera_id=0, quat_wxyz=kf0.quat,
                   trans=kf0.trans + [0.3, 0, 0]),
                KD(kfid=1, camera_id=0, quat_wxyz=kf1.quat,
                   trans=kf1.trans, scale=1.07)])]
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = tmath.quat_to_rotmat_numpy([0.99, 0.0, 0.1, 0.0])
        T[:3, 3] = [0.1, 0.0, 0.0]
        return [MO(kind=OT.SCALE_REFINEMENT, scale=2.0, transform=T)]

    return build(jops), build(tops)


@pytest.mark.parametrize("sensor", ["RGBD", "MONOCULAR"])
def test_initial_map_matches_jax(frames, sensor):
    """Keyframe intake (the per-sensor inactive-geometry densify included)
    and initialize_mapping give the JAX package's initial map."""
    jm = jmapper.GaussianMapper(small_cfg(), jmapper.SensorType[sensor])
    jm.add_camera(camera(JCamera))
    tm = tmapper.GaussianMapper(port_twin_cfg(jm.cfg),
                                tmapper.SensorType[sensor], device="cpu")
    tm.add_camera(camera())
    for op in jax_tracker_ops(frames)[1]:
        jm.queue.push(op)
    for op in torch_tracker_ops(frames)[1]:
        tm.queue.push(op)
    for m in (jm, tm):
        m.combine_mapping_operations()
        m.initialize_mapping()
    ts, js = tm.trainer.state, jm.trainer.state
    np.testing.assert_array_equal(ts.live.numpy(), np.asarray(js.live))
    assert int(ts.live.sum()) > 4 * 90   # sparse + densified points
    for k in FIELDS:
        close(getattr(ts.params, k).numpy(), getattr(js.params, k), 1e-6)
    assert all(kf.done_inactive_geo_densify
               for kf in tm.scene.keyframes.values())
    assert tm.scene.cameras_extent == pytest.approx(
        jm.scene.cameras_extent, rel=1e-6)


@pytest.mark.parametrize("kind", ["local_ba", "loop_closing",
                                  "loop_closing_sim3", "scale_refinement"])
def test_op_protocol_matches_jax(frames, kind):
    jm = jax_initialized(frames)
    tm = port_twin(jm)
    xyz0 = tm.trainer.state.params.xyz.clone()
    live0 = int(tm.trainer.state.live.sum())
    j_ops, t_ops = protocol_ops(kind, jm)
    for op in j_ops:
        jm.queue.push(op)
    for op in t_ops:
        tm.queue.push(op)
    jm.combine_mapping_operations()
    tm.combine_mapping_operations()
    assert_maps_close(tm.trainer.state, tm.trainer.opt_state,
                      jm.trainer.state, jm.trainer.opt_state)
    np.testing.assert_array_equal(
        tm.trainer.state.exist_since_iter.numpy(),
        np.asarray(jm.trainer.state.exist_since_iter))
    assert tm.loop_closure_iteration == jm.loop_closure_iteration
    for fid, jkf in jm.scene.keyframes.items():
        kf = tm.scene.keyframes[fid]
        close(kf.quat, jkf.quat, 1e-12)
        close(kf.trans, jkf.trans, 1e-12)
        close(kf.matrices.viewmatrix.numpy(), jkf.matrices.viewmatrix, 1e-6)
        assert kf.remaining_times_of_use == jkf.remaining_times_of_use
    live = tm.trainer.state.live.numpy()
    if kind == "local_ba":   # the op's 40 points were inserted
        assert live.sum() == live0 + 40
    else:
        moved = (tm.trainer.state.params.xyz != xyz0).any(1).numpy()
        assert moved[live].any(), kind


# ---------------------------------------------------------------------------
# The port-only scenarios of tests/test_mapper.py
# ---------------------------------------------------------------------------

def port_cfg(**opt):
    """tests/test_mapper.py::small_cfg for the port, with 256 entries a
    tile (the plain blend versions loop over them on the CPU)."""
    cfg = port_twin_cfg(small_cfg())
    cfg.renderer.pallas_max_per_tile = 256
    for k, v in opt.items():
        setattr(cfg.opt, k, v)
    return cfg


def tracked(cfg, cam, frames, kps=64, result_dir=None):
    mapper = tmapper.GaussianMapper(cfg, tmapper.SensorType.RGBD,
                                    result_dir=result_dir, device="cpu")
    mapper.add_camera(cam)
    tracker = tgt.GroundTruthTracker(cam, keyframe_every=1,
                                     num_keypoints=kps)
    tracker.run(iter(frames_for(tgt, frames)), mapper.queue.push)
    return mapper, tracker


@pytest.fixture(scope="module")
def densify_run(tmp_path_factory):
    """tests/test_mapper.py::run_result on the port: 5 keyframes, 30
    iterations, densify from 5 every 10."""
    out = tmp_path_factory.mktemp("mapper_out")
    cfg = port_cfg(densify_from_iter=5, densification_interval=10,
                   densify_until_iter=30)
    mapper, tracker = tracked(cfg, camera(), render_frames(num=5),
                              result_dir=out)
    events = []
    saved = ttrainer.densify_step

    def densify(*a, **k):
        events.append(1)
        return saved(*a, **k)

    ttrainer.densify_step = densify
    try:
        mapper.run(is_tracker_done=lambda: tracker.done,
                   live_kf_ids=lambda: tracker.live_kf_ids,
                   max_iterations=30)
    finally:
        ttrainer.densify_step = saved
    return mapper, out, len(events)


def test_online_densify_run(densify_run):
    mapper, out, densified = densify_run
    assert mapper.initial_mapped
    assert mapper.trainer.iteration == 30
    assert len(mapper.scene.keyframes) == 5
    assert densified == 2
    assert mapper.trainer.metrics.num_live > 0
    psnrs = np.loadtxt(out / "psnr_shutdown.txt")[:, 1]
    assert len(psnrs) == 5 and psnrs.mean() > 15.0, psnrs.mean()
    for f in ("dssim_shutdown.txt", "psnr_gaussian_splatting_shutdown.txt",
              "render_time_shutdown.txt", "cameras.json", "cfg_args",
              "used_times/used_times.txt"):
        assert (out / f).exists(), f
    assert len(list((out / "point_cloud").rglob("point_cloud.ply"))) == 1
    img = mapper.render_from_pose(np.array([1.0, 0, 0, 0]), np.zeros(3), W,
                                  H)
    assert img.shape == (3, H, W) and np.isfinite(img).all()
    assert img.max() > 0.05


def test_no_opacity_reset_on_final_iterations():
    """A run whose last iterations fall on the opacity-reset interval does
    not end with a just-reset map (reset_margin)."""
    cfg = port_cfg(densify_from_iter=10000, densify_until_iter=10000,
                   opacity_reset_interval=10)
    cfg.renderer.initial_capacity = 2048
    cfg.mapper.min_num_initial_map_kfs = 2
    cfg.mapper.max_depth_cached = 10
    mapper, _ = tracked(cfg, camera(), render_frames())
    mapper.run(is_tracker_done=lambda: True, max_iterations=20)
    assert mapper.trainer.iteration == 20
    st = mapper.trainer.state
    opac = torch.sigmoid(st.params.opacity_logit[:, 0])[st.live]
    assert float(opac.mean()) > 0.05


def test_keep_training_extends_phase3():
    cfg = port_cfg(densify_from_iter=10000, densify_until_iter=5)
    mapper, _ = tracked(cfg, camera(), render_frames())
    mapper.run(is_tracker_done=lambda: True, max_iterations=50)
    assert mapper.trainer.iteration <= 6
    orig = mapper.combine_mapping_operations

    def hook():
        if mapper.trainer.iteration >= 12:
            mapper.set_variable_parameters({"keep_training": False})
        orig()

    mapper.set_variable_parameters({"keep_training": True})
    assert mapper.get_variable_parameters()["keep_training"] is True
    mapper.combine_mapping_operations = hook
    mapper.run(is_tracker_done=lambda: True, max_iterations=50)
    assert 12 <= mapper.trainer.iteration < 50
    assert mapper.get_variable_parameters()["keep_training"] is False


@pytest.mark.parametrize("record", [True, False])
def test_record_loop_ply_snapshots(tmp_path, record):
    cfg = port_cfg()
    cfg.record.record_loop_ply = record
    mapper, _ = tracked(cfg, camera(), render_frames())
    mapper.combine_mapping_operations()
    mapper.initialize_mapping()
    mapper.result_dir = tmp_path
    kf = mapper.scene.keyframes[0]
    mapper.queue.push(tops.MappingOperation(
        kind=tops.OprType.LOOP_CLOSING_BA, scale=1.0,
        keyframes=[tops.KeyframeData(kfid=0, camera_id=0,
                                     quat_wxyz=kf.quat.copy(),
                                     trans=kf.trans + [0.5, 0, 0])]))
    mapper.combine_mapping_operations()
    it = mapper.trainer.iteration
    for d in (f"{it}_0_before_loop_correction",
              f"{it}_1_after_loop_correction"):
        assert bool(list((tmp_path / d).rglob("point_cloud.ply"))) == record


def test_render_from_pose_undistort_mask():
    cam = Camera(camera_id=0, model_id=PINHOLE, width=W, height=H, fx=60.0,
                 fy=60.0, cx=W / 2, cy=H / 2,
                 dist_coeffs=np.array([0.5, 0.1, 0, 0, 0], np.float32))
    mask = cam.undistort_mask()
    dead = mask < 0.5
    assert dead.any() and not dead.all()
    mapper, _ = tracked(port_cfg(), cam, render_frames())
    mapper.run(is_tracker_done=lambda: True, max_iterations=10)
    img = mapper.render_from_pose(np.array([1.0, 0, 0, 0]), np.zeros(3), W,
                                  H)
    assert img.shape == (3, H, W)
    assert np.abs(img[:, dead]).max() == 0.0
    assert np.abs(img[:, ~dead]).max() > 0.0


def test_capacity_grows_mid_run():
    """increase_pcd past the capacity grows the map and its moments."""
    cfg = port_cfg()
    mapper, _ = tracked(cfg, camera(), render_frames())
    mapper.run(is_tracker_done=lambda: True, max_iterations=3)
    tr = mapper.trainer
    cap = tr.state.capacity
    rng = np.random.RandomState(0)
    n = cap
    pts = (rng.uniform(-1, 1, (n, 3)) + [0, 0, 5]).astype(np.float32)
    inserted = tr.increase_pcd(pts, rng.uniform(0, 1, (n, 3)).astype(
        np.float32))
    assert inserted == n and tr.state.capacity > cap
    assert all(m.shape[0] == tr.state.capacity for m in tr.opt_state.m)
    tr.train_iteration()
    assert all(bool(torch.isfinite(p).all()) for p in tr.state.params)
    assert int(tgm.num_live(tr.state)) == tr.metrics.num_live
