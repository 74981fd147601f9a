"""The online slice as a whole: the port's GaussianMapper against the JAX
package's (JAX in "tiled" mode, its CPU default: f32 like the port's
kernel path) through run_online with the GT frontend, threaded=False and
densify off, on the same frames; the online_slam CLI of both packages on
the same Replica-layout sequence; and what the CLI now accepts (batch > 1,
the viewer, the stereo sensor). The port-only scenarios of
tests/test_mapper.py are in test_torch_mapper.py.

Tolerances: after 10 iterations, 99 % of each parameter group's live
entries within 6e-3 of the largest change JAX made to it since
initialization (the train step's tolerance over 5 steps,
tests/test_torch_trainer.py), every entry within a quarter of it; the
render_from_pose image within 1e-2 (max abs) and its mean abs difference
within 1e-3; the recorder's PSNR within 0.1 dB; keyframe poses, use
counts, the live mask and the trajectory files exact."""
import json

import numpy as np
import pytest
import torch

from photo_slam_tpu import config as jconfig
from photo_slam_tpu.apps import online_slam as jonline
from photo_slam_tpu.mapper import mapper as jmapper
from photo_slam_tpu.models.camera import Camera as JCamera
from photo_slam_tpu.tracking import gt_tracker as jgt
from photo_slam_tpu_torch import config as tconfig
from photo_slam_tpu_torch.apps import online_slam as tonline
from photo_slam_tpu_torch.mapper import mapper as tmapper
from photo_slam_tpu_torch.ops.preprocess import compute_cov3d
from photo_slam_tpu_torch.tools.synth_replica import SynthReplica
from photo_slam_tpu_torch.tools.synth_replica import replica_camera
from photo_slam_tpu_torch.tracking import gt_tracker as tgt
from test_mapper import small_cfg
from test_torch_blend import one_torch_thread  # noqa: F401
from test_torch_mapper import (FIELDS, H, W, camera, frames_for,
                               port_twin_cfg, render_frames)

ITERS = 10
TRAJECTORIES = ("CameraTrajectory_TUM.txt", "KeyFrameTrajectory_TUM.txt",
                "CameraTrajectory_EuRoC.txt", "KeyFrameTrajectory_EuRoC.txt",
                "CameraTrajectory_KITTI.txt")


class Sequence:
    """A dataset for run_online: a camera and in-memory frames."""

    def __init__(self, camera, frames):
        self.camera = camera
        self._frames = frames

    def frames(self):
        return iter(self._frames)


def parity_cfg(pkg_config):
    """tests/test_mapper.py::small_cfg with densify off (JAX's densify
    draws from jax.random, which torch cannot reproduce) and no inactive-
    geometry densify: in RGBD it backprojects the tracker's own keypoints
    again, and the exact duplicates tie in the blend order, which both
    sorts leave unspecified (test_torch_mapper.py holds the densified
    initial map against JAX)."""
    cfg = small_cfg()
    cfg.opt.densify_from_iter = 1000
    cfg.opt.densify_until_iter = 1000
    cfg.mapper.inactive_geo_densify = False
    return cfg if pkg_config is jconfig else port_twin_cfg(cfg)


def snapshot_at_init(cls, store, to_numpy):
    """Wrap cls.initialize_mapping to keep the map right after it."""
    orig = cls.initialize_mapping

    def initialize_mapping(self):
        orig(self)
        store.update({k: to_numpy(getattr(self.trainer.state.params, k))
                      for k in FIELDS})
    return orig, initialize_mapping


@pytest.fixture(scope="module")
def both_runs(tmp_path_factory):
    frames = render_frames()
    init = {"jax": {}, "port": {}}
    saved = []
    for cls, key, conv in (
            (jmapper.GaussianMapper, "jax", lambda x: np.array(x)),
            (tmapper.GaussianMapper, "port", lambda x: x.numpy().copy())):
        orig, wrapped = snapshot_at_init(cls, init[key], conv)
        saved.append((cls, orig))
        cls.initialize_mapping = wrapped
    out = {k: tmp_path_factory.mktemp(k) for k in ("jax", "port")}
    try:
        jm = jonline.run_online(
            Sequence(camera(JCamera), frames_for(jgt, frames)),
            jmapper.SensorType.RGBD, parity_cfg(jconfig), out["jax"],
            keyframe_every=1, num_keypoints=100, max_iterations=ITERS,
            threaded=False, frontend="gt")
        tm = tonline.run_online(
            Sequence(camera(), frames_for(tgt, frames)),
            tmapper.SensorType.RGBD, parity_cfg(tconfig), out["port"],
            keyframe_every=1, num_keypoints=100, max_iterations=ITERS,
            threaded=False, frontend="gt", device="cpu")
    finally:
        for cls, orig in saved:
            cls.initialize_mapping = orig
    return jm, tm, init, out


def test_slice_keyframes_and_schedule_match_jax(both_runs):
    jm, tm, _, _ = both_runs
    assert tm.trainer.iteration == jm.trainer.iteration == ITERS
    assert sorted(tm.scene.keyframes) == sorted(jm.scene.keyframes) == [
        0, 1, 2, 3]
    for fid, jkf in jm.scene.keyframes.items():
        kf = tm.scene.keyframes[fid]
        np.testing.assert_array_equal(kf.quat, jkf.quat)
        np.testing.assert_array_equal(kf.trans, jkf.trans)
        assert kf.creation_iter == jkf.creation_iter
        assert kf.remaining_times_of_use == jkf.remaining_times_of_use
    assert tm.trainer.sampler.use_counts == jm.trainer.sampler.use_counts
    assert tm.trainer.spatial_lr_scale == pytest.approx(
        jm.trainer.spatial_lr_scale, rel=1e-6)


def covariance(params):
    """World covariances [N, 6] of numpy log_scales and quats: what a
    splat renders, whatever rotation an isotropic one carries."""
    q = torch.from_numpy(np.array(params["quats"]))
    return compute_cov3d(torch.exp(torch.from_numpy(np.array(
        params["log_scales"]))), q / torch.linalg.norm(q, dim=-1,
                                                      keepdim=True)).numpy()


def test_slice_map_matches_jax(both_runs):
    """Each group after 10 iterations: 99 % of the live entries within
    6e-3 of the largest change JAX made to the group, and every entry
    within a quarter of it. The tail comes from Gaussians at the image
    border, seen by a few pixels, whose small gradients Adam normalizes
    into full steps. The rotations are held through the covariances: the
    mapper starts every splat isotropic, so its quaternion gradient is
    rounding noise until the scales part."""
    jm, tm, init, _ = both_runs
    ts, js = tm.trainer.state, jm.trainer.state
    live = ts.live.numpy()
    np.testing.assert_array_equal(live, np.asarray(js.live))
    np.testing.assert_array_equal(ts.exist_since_iter.numpy(),
                                  np.asarray(js.exist_since_iter))
    got = {k: getattr(ts.params, k).numpy() for k in FIELDS}
    want = {k: np.asarray(getattr(js.params, k)) for k in FIELDS}
    for k in FIELDS:
        np.testing.assert_allclose(init["port"][k], init["jax"][k],
                                   atol=1e-6, err_msg=f"initial {k}")
    # SH degree 0 for the first 1000 iterations: features_rest untouched.
    np.testing.assert_array_equal(got["features_rest"],
                                  want["features_rest"])
    groups = {k: (got[k], want[k], init["jax"][k]) for k in
              ("xyz", "features_dc", "opacity_logit", "log_scales")}
    groups["covariance"] = (covariance(got), covariance(want),
                            covariance(init["jax"]))
    for k, (a, b, b0) in groups.items():
        a, b, b0 = a[live], b[live], b0[live]
        scale = np.abs(b - b0).max()
        diff = np.abs(a - b)
        assert scale > 0, k
        p99, worst = np.percentile(diff, 99) / scale, diff.max() / scale
        assert p99 <= 6e-3 and worst <= 0.25, (k, p99, worst)


def test_slice_render_from_pose_matches_jax(both_runs):
    jm, tm, _, _ = both_runs
    for q, t, w, h in (([1.0, 0, 0, 0], [0.0, 0, 0], W, H),
                       ([0.99, 0.0, 0.05, 0.0], [0.1, 0, 0.2], 100, 60)):
        got = tm.render_from_pose(np.array(q), np.array(t), w, h)
        want = jm.render_from_pose(np.array(q), np.array(t), w, h)
        assert got.shape == want.shape == (3, h, w)
        diff = np.abs(got - want)
        assert diff.max() <= 1e-2 and diff.mean() <= 1e-3, (
            diff.max(), diff.mean())
        assert got.max() > 0.05


def test_slice_outputs_match_jax(both_runs):
    _, _, _, out = both_runs
    for name in TRAJECTORIES:
        assert ((out["port"] / name).read_text()
                == (out["jax"] / name).read_text()), name
    assert (json.loads((out["port"] / "cameras.json").read_text())
            == json.loads((out["jax"] / "cameras.json").read_text()))
    for name in ("psnr_shutdown.txt", "psnr_gaussian_splatting_shutdown.txt",
                 "dssim_shutdown.txt"):
        got = np.loadtxt(out["port"] / name)
        want = np.loadtxt(out["jax"] / name)
        np.testing.assert_array_equal(got[:, 0], want[:, 0])
        tol = 0.1 if name.startswith("psnr") else 1e-3
        np.testing.assert_allclose(got[:, 1], want[:, 1], atol=tol,
                                   err_msg=name)
    ps = json.loads((out["port"] / "run_summary.json").read_text())
    js = json.loads((out["jax"] / "run_summary.json").read_text())
    assert set(js) <= set(ps)
    for k in ("iterations", "num_keyframes", "num_gaussians", "frontend"):
        assert ps[k] == js[k], k
    assert (out["port"] / "GpuPeakUsageMB.txt").read_text() == "0.0\n"
    for name in ("used_times/used_times.txt", "input.ply", "cfg_args"):
        assert (out["port"] / name).exists(), name
    assert list((out["port"] / "point_cloud").rglob("point_cloud.ply"))


def test_online_slam_cli_matches_jax(tmp_path):
    """`online_slam replica_rgbd --frontend gt` of both packages on one
    Replica-layout sequence (written by tools/synth_replica.py): the same
    trajectory files and cameras, the same keyframes recorded."""
    data = SynthReplica(6, 64, 36, device="cpu", n_splats=4000).write(
        tmp_path / "room")
    args = ["--data", str(data), "--iters", "5", "--frontend", "gt",
            "--keyframe-every", "2"]
    jonline.replica_rgbd(args + ["--out", str(tmp_path / "jax")])
    mapper = tonline.replica_rgbd(args + ["--out", str(tmp_path / "port"),
                                          "--device", "cpu"])
    assert mapper.device == torch.device("cpu")
    assert mapper.trainer.iteration == 5
    for name in TRAJECTORIES + ("cameras.json",):
        assert ((tmp_path / "port" / name).read_text()
                == (tmp_path / "jax" / name).read_text()), name
    got = np.loadtxt(tmp_path / "port" / "psnr_shutdown.txt")
    want = np.loadtxt(tmp_path / "jax" / "psnr_shutdown.txt")
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    assert len(list((tmp_path / "port" / "image_rendered").glob("*.png"))) \
        == 3


def test_cli_refuses_what_is_not_ported(tmp_path):
    """Nothing of the CLI's is refused any more: the live viewer and
    batched training are ported (tests/test_torch_viewer.py,
    test_torch_batched_training.py, test_torch_apps.py), and so are the
    stereo sensor, --imu and euroc_stereo."""
    seq = Sequence(camera(), [])
    mapper = tmapper.GaussianMapper(tconfig.Config(),
                                    tmapper.SensorType.RGBD, device="cpu")
    mapper.run(is_tracker_done=lambda: True, batch=2)
    assert not mapper.initial_mapped and mapper.trainer.iteration == 0
    # An empty stereo sequence, with the viewer on, reaches the run's own
    # check that tracking produced keyframes.
    with pytest.raises(SystemExit, match="no keyframes"):
        tonline.run_online(seq, tmapper.SensorType.STEREO, tconfig.Config(),
                           tmp_path, frontend="slam", device="cpu",
                           viewer=True, viewer_port=0)
    # euroc_stereo parses and loads (a missing sequence is the loader's
    # FileNotFoundError, not a refusal).
    with pytest.raises(FileNotFoundError, match="EuRoC"):
        tonline.APPS["euroc_stereo"](["--data", str(tmp_path), "--out",
                                      str(tmp_path), "--device", "cpu"])


def test_imu_needs_the_imu_channel(tmp_path):
    """--imu on a EuRoC sequence without mav0/imu0 raises ValueError, as
    the JAX app does."""
    from test_euroc import write_euroc_like

    root = write_euroc_like(tmp_path / "MH_noimu", num=3)
    with pytest.raises(ValueError, match="no IMU"):
        tonline.euroc_stereo(["--data", str(root), "--out",
                              str(tmp_path / "out"), "--imu", "--device",
                              "cpu"])


def test_euroc_stereo_cli_runs_on_the_cpu(tmp_path):
    """`online_slam euroc_stereo --imu --device cpu` end to end on a tiny
    tree written by tools/synth_euroc.py: the slam frontend on SGM depth
    with the IMU, the mapper, the five trajectory files and the inertial
    fields of run_summary.json."""
    from photo_slam_tpu_torch.tools.synth_euroc import SynthEuroc

    data = SynthEuroc(12, 256, 160, device="cpu", n_splats=6000).write(
        tmp_path / "MH")
    out = tmp_path / "out"
    mapper = tonline.euroc_stereo(["--data", str(data), "--out", str(out),
                                   "--imu", "--iters", "3", "--device",
                                   "cpu"])
    assert mapper.device == torch.device("cpu")
    assert mapper.sensor == tmapper.SensorType.STEREO
    for name in TRAJECTORIES:
        assert len((out / name).read_text().splitlines()) >= 1, name
    assert len((out / "CameraTrajectory_TUM.txt").read_text()
               .splitlines()) == 12
    summary = json.loads((out / "run_summary.json").read_text())
    assert summary["frontend"] == "slam" and summary["iterations"] == 3
    assert isinstance(summary["imu_initialized"], bool)
    assert isinstance(summary["scale_refinements"], int)
    assert summary["ate_rmse"] is not None


def write_textured_replica(root, num=12):
    """A Replica-layout sequence (PNG frames, 16-bit depth, traj.txt) of
    test_torch_frontend's textured plane through the Replica camera scaled
    to 320x181, the camera sliding sideways."""
    import cv2
    from photo_slam_tpu_torch.io.datasets import REPLICA_DEPTH_SCALE
    from test_torch_frontend import splat_render, textured_world

    cam = replica_camera(320, 181)
    world = textured_world(seed=2)
    results = root / "results"
    results.mkdir(parents=True)
    c2w = []
    for i in range(num):
        t = np.array([0.04 * i, 0.01 * i, 0.0])    # world->camera
        img = splat_render(world, np.eye(3), t, cam)
        cv2.imwrite(str(results / f"frame{i:06d}.png"), cv2.cvtColor(
            (np.transpose(img, (1, 2, 0)) * 255).round().astype(np.uint8),
            cv2.COLOR_RGB2BGR))
        depth = np.full((cam.height, cam.width), 5.0 * REPLICA_DEPTH_SCALE)
        cv2.imwrite(str(results / f"depth{i:06d}.png"),
                    depth.round().astype(np.uint16))
        T = np.eye(4)
        T[:3, 3] = -t
        c2w.append(T.reshape(-1))
    np.savetxt(root / "traj.txt", np.stack(c2w))
    return root


@pytest.fixture(scope="module")
def textured_replica(tmp_path_factory):
    return write_textured_replica(tmp_path_factory.mktemp("textured"))


@pytest.mark.parametrize("frontend", ["slam", "vo"])
def test_online_slam_cli_feature_frontends(frontend, textured_replica,
                                           tmp_path):
    """`online_slam replica_rgbd --frontend slam|vo --device cpu` tracks the
    sequence with the port's ORB and writes the JAX artifact set (with the
    slam frontend's per-frame TrackingTime.txt) and a finite ATE against
    the sequence's poses in run_summary.json."""
    out = tmp_path / frontend
    mapper = tonline.replica_rgbd([
        "--data", str(textured_replica), "--out", str(out), "--iters", "3",
        "--frontend", frontend, "--device", "cpu"])
    assert mapper.trainer.iteration == 3 and len(mapper.scene.keyframes) >= 2
    for name in TRAJECTORIES + ("cameras.json", "run_summary.json",
                                "GpuPeakUsageMB.txt", "psnr_shutdown.txt"):
        assert (out / name).exists(), name
    # The VO tracker keeps no per-frame times, in JAX neither.
    assert (out / "TrackingTime.txt").exists() == (frontend == "slam")
    summary = json.loads((out / "run_summary.json").read_text())
    assert summary["frontend"] == frontend
    assert np.isfinite(summary["ate_rmse"]) and summary["ate_rmse"] < 0.05
    assert len((out / "CameraTrajectory_TUM.txt").read_text().splitlines()) \
        == 12
    if frontend == "slam":
        times = np.loadtxt(out / "TrackingTime.txt")
        assert len(times) == 12 and (times > 0).all()
        assert summary["mean_tracking_ms"] > 0
        assert summary["loops_closed"] == 0
