"""The monocular sensor and the TUM RGB-D layout, held against the JAX
package: the TUM list reader and association, a `write_tum` tree
(tools/synth_replica.py) read by both packages' TumDataset, the port's PNG
decoder on TUM's 640x480 frames with neither cv2 nor PIL, the
`replica_mono`, `tum_rgbd` and `tum_mono` apps with the GT frontend in
both packages, `replica_mono --frontend slam` against the JAX frontend,
with OpenCV's functions swapped into the port's vision (cv2_vision) and
with the port's own vision (its ORB, essential matrix, recoverPose,
triangulation and PnP, each equal to OpenCV's, its ORB in OpenCV's order
too) against JAX's own OpenCV run, and what the apps refuse.

Tolerances: the lists, associations, images, depth maps, trajectory files
and cameras.json exact; GT poses within 1e-12 of SynthReplica's own; the
slam frontend's trajectory and op stream within TRAJ_TOL (1e-9) of JAX's,
as tests/test_torch_frontend.py holds them; the app's ATE within 1e-9 of
JAX's ate_rmse on JAX's trajectory."""
import json
import threading

import numpy as np
import pytest
import torch

from photo_slam_tpu.apps import online_slam as jonline
from photo_slam_tpu.io import datasets as jdatasets
from photo_slam_tpu.mapper.mapper import SensorType as JSensorType
from photo_slam_tpu.models.camera import Camera as JCamera
from photo_slam_tpu.utils.evaluate import ate_rmse as jate_rmse
from photo_slam_tpu_torch.apps import online_slam as tonline
from photo_slam_tpu_torch.io import datasets as tdatasets
from photo_slam_tpu_torch.io import images
from photo_slam_tpu_torch.mapper import mapping_ops
from photo_slam_tpu_torch.models.camera import PINHOLE
from photo_slam_tpu_torch.tools import synth_replica
from photo_slam_tpu_torch.tools.synth_replica import (SynthReplica,
                                                      tum_camera_flags)
from photo_slam_tpu_torch.utils.math import se3_inverse, se3_matrix
from test_torch_blend import one_torch_thread  # noqa: F401
from test_torch_frontend import (assert_same_run, assert_same_stream,
                                 cv2_vision)  # noqa: F401

cv2 = pytest.importorskip("cv2")

POSE_TOL = 1e-12
TRAJ_TOL = 1e-9
TRAJECTORIES = ("CameraTrajectory_TUM.txt", "KeyFrameTrajectory_TUM.txt",
                "CameraTrajectory_EuRoC.txt", "KeyFrameTrajectory_EuRoC.txt",
                "CameraTrajectory_KITTI.txt")
# replica_mono --frontend slam: the first SLAM_FRAMES frames of the
# 120-frame trajectory at SLAM_SIZE, so that the motion a frame is the
# full-width run's.
SLAM_FRAMES, SLAM_OF = 18, 120
SLAM_SIZE = (320, 181)


@pytest.fixture(scope="module")
def room():
    """Eight frames of the synthetic room at 64x48, in memory."""
    return SynthReplica(8, 64, 48, device="cpu", n_splats=6000)


@pytest.fixture(scope="module")
def tum_root(room, tmp_path_factory):
    return room.write_tum(tmp_path_factory.mktemp("tum") / "fr1_synth")


# ---------------------------------------------------------------------------
# (a) The TUM lists and their association
# ---------------------------------------------------------------------------

def write_lists(root, case):
    """rgb.txt and depth.txt of a case: tests/test_apps.py::
    test_tum_association's, or a generated one with jittered stamps,
    dropped and late depth frames, comments and blank lines."""
    if case == "jax_scenario":
        rgb = "# comment\n1.00 rgb/a.png\n1.05 rgb/b.png\n"
        depth = "1.01 depth/a.png\n1.06 depth/b.png\n"
    else:
        rng = np.random.RandomState(5)
        t = 1305031102.0 + np.arange(40) / 30.0 + rng.uniform(-3e-3, 3e-3,
                                                               40)
        rgb = "# color images\n# file: 'synth.bag'\n# timestamp filename\n"
        rgb += "".join(f"{s:.6f} rgb/{s:.6f}.png\n" + ("\n" if i % 9 == 4
                                                       else "")
                       for i, s in enumerate(t))
        depth = "# depth maps\n"
        for i, s in enumerate(t):
            if i % 5 == 3:
                continue        # dropped
            d = s + rng.uniform(-0.015, 0.03)   # some past the 20 ms window
            depth += f"{d:.6f}  depth/{d:.6f}.png \n"
    (root / "rgb.txt").write_text(rgb)
    (root / "depth.txt").write_text(depth)


@pytest.mark.parametrize("case", ["jax_scenario", "generated"])
def test_tum_lists_and_association_match_jax(case, tmp_path):
    write_lists(tmp_path, case)
    lists = {}
    for name in ("rgb", "depth"):
        got = tdatasets._read_tum_list(tmp_path / f"{name}.txt")
        assert got == jdatasets._read_tum_list(tmp_path / f"{name}.txt")
        lists[name] = got
    assoc = tdatasets._associate(lists["rgb"], lists["depth"])
    assert assoc == jdatasets._associate(lists["rgb"], lists["depth"])
    assert all(abs(tr - td) <= 0.02 for tr, _, td, _ in assoc)
    if case == "jax_scenario":
        assert len(assoc) == 2 and assoc[0][3][0] == "depth/a.png"
    else:
        assert len(lists["rgb"]) == 40 and len(lists["depth"]) == 32
        assert 0 < len(assoc) < 40


# ---------------------------------------------------------------------------
# (b) write_tum read back by both packages; the PNG decoder on TUM's frames
# ---------------------------------------------------------------------------

def same_rotation(qa, qb):
    """Two wxyz quaternions of one rotation (q and -q alike)."""
    return min(np.abs(qa - qb).max(), np.abs(qa + qb).max())


@pytest.mark.parametrize("codec", ["cv2", "own"])
@pytest.mark.parametrize("with_depth", [True, False])
def test_write_tum_read_by_both_packages(with_depth, codec, room, tum_root,
                                         monkeypatch):
    """Both TumDatasets give the same frames: images and depth maps
    bit-equal (the port through cv2 or, with cv2 and PIL hidden, its own
    PNG decoder), the depth equal to the 16-bit units written, poses
    within POSE_TOL of SynthReplica's own."""
    assert tdatasets.TUM_DEPTH_SCALE == jdatasets.TUM_DEPTH_SCALE
    if codec == "own":
        monkeypatch.setattr(images, "cv2", None)
        monkeypatch.setattr(images, "Image", None)
    cam = room.camera
    jcam = JCamera(camera_id=0, model_id=PINHOLE, width=cam.width,
                   height=cam.height, fx=cam.fx, fy=cam.fy, cx=cam.cx,
                   cy=cam.cy)
    port = tdatasets.TumDataset(tum_root, cam, with_depth=with_depth)
    ref = jdatasets.TumDataset(tum_root, jcam, with_depth=with_depth)
    assert len(port) == len(ref) == len(room)
    assert port.assoc == ref.assoc
    for mine, theirs, truth in zip(port.frames(), ref.frames(),
                                   room.frames()):
        np.testing.assert_array_equal(mine.image, theirs.image)
        assert mine.image.shape == (3, cam.height, cam.width)
        assert mine.filename == theirs.filename
        if with_depth:
            np.testing.assert_array_equal(mine.depth, theirs.depth)
            units = synth_replica.depth_units(truth.depth,
                                              tdatasets.TUM_DEPTH_SCALE)
            np.testing.assert_array_equal(
                np.rint(mine.depth * tdatasets.TUM_DEPTH_SCALE), units)
        else:
            assert mine.depth is None and theirs.depth is None
        for got in (mine, theirs):
            assert same_rotation(got.quat_wxyz, truth.quat_wxyz) <= POSE_TOL
            np.testing.assert_allclose(got.trans, truth.trans, rtol=0,
                                       atol=POSE_TOL)


def test_write_tum_stamps_need_the_association(tum_root):
    """Every depth stamp lies 2-8 ms after its RGB stamp, and each frame
    associates with its own depth map."""
    rgb = tdatasets._read_tum_list(tum_root / "rgb.txt")
    depth = tdatasets._read_tum_list(tum_root / "depth.txt")
    offsets = np.array([d[0] - r[0] for r, d in zip(rgb, depth)])
    assert (offsets > 1.5e-3).all() and (offsets < 8.5e-3).all()
    assoc = tdatasets._associate(rgb, depth)
    assert [a[3] for a in assoc] == [d[1] for d in depth]


@pytest.mark.parametrize("kind", ["rgb8", "gray16"])
def test_png_decoder_on_tum_frames(kind, tmp_path, monkeypatch):
    """640x480 PNGs as TUM ships them, written by OpenCV (which picks a
    row filter per row): with cv2 and PIL hidden, read_png and
    load_image_chw (and load_depth on the depth map) give what cv2.imread
    gives, bit for bit."""
    rng = np.random.RandomState(7)
    yy, xx = np.mgrid[:480, :640]
    smooth = np.stack([np.sin(xx / 37.0 + c) * np.cos(yy / 23.0 - c)
                       for c in range(3)], -1)
    if kind == "rgb8":
        img = np.clip(127.5 * (smooth + 1) + rng.randint(-9, 10, smooth.shape),
                      0, 255).astype(np.uint8)
        cv2.imwrite(str(tmp_path / "f.png"), cv2.cvtColor(img,
                                                          cv2.COLOR_RGB2BGR))
    else:
        img = (5000 * (2.5 + smooth[..., 0])).astype(np.uint16)
        img[rng.rand(480, 640) < 0.05] = 0      # holes, as a sensor leaves
        cv2.imwrite(str(tmp_path / "f.png"), img)
    path = tmp_path / "f.png"
    want = {"load_image_chw": images.load_image_chw(path)}
    if kind == "gray16":
        want["load_depth"] = images.load_depth(path,
                                               tdatasets.TUM_DEPTH_SCALE)
    monkeypatch.setattr(images, "cv2", None)
    monkeypatch.setattr(images, "Image", None)
    np.testing.assert_array_equal(images.read_png(path), img)
    np.testing.assert_array_equal(images.load_image_chw(path),
                                  want["load_image_chw"])
    if kind == "gray16":
        np.testing.assert_array_equal(
            images.load_depth(path, tdatasets.TUM_DEPTH_SCALE),
            want["load_depth"])


# ---------------------------------------------------------------------------
# (c) The three apps with the GT frontend, both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("app", ["replica_mono", "tum_rgbd", "tum_mono"])
def test_apps_with_gt_frontend_match_jax(app, room, tum_root, tmp_path):
    """`online_slam <app> --frontend gt` of both packages on one sequence
    (the Replica layout for replica_mono, write_tum's for the TUM apps,
    the synthetic camera as flags): the trajectory files and cameras.json
    byte-equal, the same keyframes recorded, the monocular mapper on GT
    depth's sparse keypoints."""
    if app == "replica_mono":
        data = room.write(tmp_path / "room")
        extra = []
    else:
        data = tum_root
        extra = tum_camera_flags(room.camera)
    args = ["--data", str(data), "--iters", "5", "--frontend", "gt",
            "--keyframe-every", "2"] + extra
    getattr(jonline, app)(args + ["--out", str(tmp_path / "jax")])
    mapper = getattr(tonline, app)(args + ["--out", str(tmp_path / "port"),
                                           "--device", "cpu"])
    assert mapper.device == torch.device("cpu")
    assert mapper.sensor.name == ("RGBD" if app == "tum_rgbd"
                                  else "MONOCULAR")
    assert mapper.trainer.iteration == 5 and len(mapper.scene.keyframes) == 4
    for name in TRAJECTORIES + ("cameras.json",):
        assert ((tmp_path / "port" / name).read_text()
                == (tmp_path / "jax" / name).read_text()), name
    got = np.loadtxt(tmp_path / "port" / "psnr_shutdown.txt")
    want = np.loadtxt(tmp_path / "jax" / "psnr_shutdown.txt")
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    cams = json.loads((tmp_path / "port" / "cameras.json").read_text())
    assert {c["width"] for c in cams} == {room.camera.width}


# ---------------------------------------------------------------------------
# (d) replica_mono --frontend slam against the JAX frontend
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def slam_room(tmp_path_factory):
    """The first SLAM_FRAMES frames of the SLAM_OF-frame room at SLAM_SIZE,
    written in the Replica layout."""
    pose = synth_replica.pose
    mp = pytest.MonkeyPatch()
    mp.setattr(synth_replica, "pose", lambda i, num: pose(i, SLAM_OF))
    try:
        seq = SynthReplica(SLAM_FRAMES, *SLAM_SIZE, device="cpu",
                           n_splats=20000)
    finally:
        mp.undo()
    return seq.write(tmp_path_factory.mktemp("slam_room") / "room")


def run_on_thread(fn):
    """fn() on a fresh thread (OpenCV's RNG is per thread, and the app's
    tracker runs on one of its own)."""
    out = []
    th = threading.Thread(target=lambda: out.append(fn()))
    th.start()
    th.join(timeout=600)
    assert not th.is_alive() and out
    return out[0]


def replica_mono_against_jax(slam_room, tmp_path, monkeypatch):
    """The port's `online_slam replica_mono --frontend slam
    --no-async-mapping --device cpu` and the tracker the JAX app builds for
    it (jonline._make_tracker, its own cv2.ORB_create) on the JAX
    loader's frames, held to the same two-view initialization, trajectory
    within TRAJ_TOL, keyframes, map points and MappingOperation stream, the
    app's ATE equal to JAX's ate_rmse on JAX's trajectory."""
    trackers, pushed = [], []
    make, push = tonline._make_tracker, mapping_ops.MappingOpQueue.push

    def make_tracker(*a, **k):
        trackers.append(make(*a, **k))
        return trackers[-1]

    def record(queue, op):
        pushed.append(op)
        push(queue, op)

    monkeypatch.setattr(tonline, "_make_tracker", make_tracker)
    monkeypatch.setattr(mapping_ops.MappingOpQueue, "push", record)
    mapper = tonline.replica_mono(
        ["--data", str(slam_room), "--out", str(tmp_path / "port"),
         "--iters", "2", "--frontend", "slam", "--no-async-mapping",
         "--device", "cpu"])
    tfe = trackers[0]

    ds = jdatasets.ReplicaDataset(slam_room, load_depth_maps=False)
    jfe = jonline._make_tracker("slam", ds, JSensorType.MONOCULAR, 10, 800,
                                async_mapping=False)
    jops = []
    run_on_thread(lambda: jfe.run(ds.frames(), jops.append))

    assert mapper.sensor.name == "MONOCULAR" and tfe.sensor == "mono"
    assert len(tfe.map.keyframes) >= 3 and tfe.map.num_points > 100
    assert tfe.tracked_frames >= SLAM_FRAMES // 2
    assert_same_run(jfe, tfe)
    assert_same_stream(tmp_path, jops, pushed)
    assert tfe.num_scale_refinements == jfe.num_scale_refinements
    gt = [se3_matrix(f.quat_wxyz, f.trans) for f in ds.frames()]
    want = jate_rmse(np.stack([se3_inverse(t)[:3, 3] for t in
                               jfe.trajectory]),
                     np.stack([se3_inverse(t)[:3, 3] for t in gt]))
    summary = json.loads((tmp_path / "port" / "run_summary.json")
                         .read_text())
    assert abs(summary["ate_rmse"] - want) <= TRAJ_TOL


def test_replica_mono_slam_matches_jax(slam_room, cv2_vision, tmp_path,
                                       monkeypatch):
    """replica_mono --frontend slam with OpenCV's functions swapped into the
    port's vision, against the JAX app's tracker (replica_mono_against_jax)."""
    replica_mono_against_jax(slam_room, tmp_path, monkeypatch)


def test_replica_mono_own_vision_matches_jax(slam_room, tmp_path,
                                             monkeypatch):
    """replica_mono --frontend slam with nothing of OpenCV in the port (its
    own gray, ORB, essential matrix, recoverPose, triangulation and PnP)
    against the JAX app's tracker on OpenCV's own run, nothing reordered:
    the same run, op stream and ATE (replica_mono_against_jax)."""
    from photo_slam_tpu_torch.tracking import vision

    for fn in ("rgb_to_gray", "orb_detect_and_compute", "find_essential_mat",
               "recover_pose", "triangulate_points", "solve_pnp_ransac"):
        assert getattr(vision, fn).__module__ == vision.__name__, fn
    replica_mono_against_jax(slam_room, tmp_path, monkeypatch)


def mono_trackers(root, async_port=False):
    """The monocular slam tracker each app builds (_make_tracker, local
    mapping on the tracking thread) run on a Replica-layout sequence read
    without its depth by the package's own loader, each package with its
    own vision (JAX's OpenCV, the port's tracking/vision.py), each on a
    fresh thread: {"jax" | "port": (frontend, ground-truth world->camera
    poses)}; with async_port also "port async", the port's tracker with
    local mapping on its own thread, as the app runs it by default."""
    out = {}
    runs = [("jax", jonline, jdatasets, JSensorType, {}, False),
            ("port", tonline, tdatasets, tonline.SensorType,
             {"device": "cpu"}, False)]
    if async_port:
        runs.append(("port async",) + runs[1][1:5] + (True,))
    for name, app, datasets, sensor, kw, async_mapping in runs:
        ds = datasets.ReplicaDataset(root, load_depth_maps=False)
        fe = app._make_tracker("slam", ds, sensor.MONOCULAR, 10, 800,
                               async_mapping=async_mapping, **kw)
        run_on_thread(lambda: fe.run(ds.frames(), lambda op: None))
        out[name] = fe, [se3_matrix(f.quat_wxyz, f.trans)
                         for f in ds.frames()]
    return out


def test_replica_mono_own_vision_tracks_the_pan(slam_room):
    """The port's own vision (ORB in torch, OpenCV's five-point RANSAC, its
    PnP) initializes on the pan and tracks every later frame, as JAX's
    OpenCV does on the same frames. Their ATEs
    are not compared here: both miss 5 cm on the full pan (ROADMAP Queue
    3; `python tests/test_torch_mono_tum.py` prints them)."""
    for name, (fe, gt) in mono_trackers(slam_room).items():
        assert len(fe.trajectory) == len(gt) == SLAM_FRAMES, name
        assert len(fe.map.keyframes) >= 3 and fe.lost_frames == 0, name
        assert not fe._old_maps and fe.map.num_points > 100, name


# ---------------------------------------------------------------------------
# (e) What the apps refuse
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("app", ["tum_rgbd", "tum_mono"])
def test_tum_without_rgb_list_raises(app, tmp_path):
    """A TUM path with no rgb.txt: FileNotFoundError, as JAX's."""
    args = ["--data", str(tmp_path), "--out", str(tmp_path / "out")]
    with pytest.raises(FileNotFoundError, match="rgb.txt"):
        getattr(jonline, app)(args)
    with pytest.raises(FileNotFoundError, match="rgb.txt"):
        getattr(tonline, app)(args + ["--device", "cpu"])


@pytest.mark.parametrize("app", ["replica_mono", "tum_rgbd", "tum_mono"])
def test_apps_raise_without_a_card(app, room, tum_root, tmp_path,
                                   monkeypatch):
    """--device cuda (the default) where no card is present raises before
    any mapping, and writes nothing: there is no fallback to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = room.write(tmp_path / "room") if app == "replica_mono" \
        else tum_root
    out = tmp_path / "out"
    for argv in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            getattr(tonline, app)(["--data", str(data), "--out", str(out),
                                   "--frontend", "gt"] + argv)
    assert not out.exists()


def test_tum_camera_flags_round_trip(room):
    """tum_camera_flags gives the TUM apps' parser the camera itself."""
    args = tonline._tum_parser(1.0, 1.0, 1.0, 1.0).parse_args(
        ["--data", "d", "--out", "o"] + tum_camera_flags(room.camera))
    cam = tonline._tum_camera(args)
    for f in ("width", "height", "fx", "fy", "cx", "cy"):
        assert getattr(cam, f) == getattr(room.camera, f), f


if __name__ == "__main__":
    # The pan's monocular ATE in both packages on the CPU, and the port's
    # with local mapping on its own thread (as chip_smoke's app runs it):
    #   python tests/test_torch_mono_tum.py [frames] [width] [height]
    # (default: chip_smoke's 120 frames at 600x340, half its width). The
    # frames go through the PNG writer, as on the card's machine.
    import sys
    import tempfile
    from pathlib import Path

    from photo_slam_tpu_torch.utils.evaluate import (ate_rmse,
                                                     umeyama_alignment)

    num, width, height = (int(x) for x in (sys.argv[1:] or [120, 600, 340]))
    seq = SynthReplica(num, width, height, device="cpu")
    with tempfile.TemporaryDirectory() as tmp:
        mp = pytest.MonkeyPatch()
        mp.setattr(images, "cv2", None)
        mp.setattr(images, "Image", None)
        root = seq.write(Path(tmp) / "room")
        mp.undo()
        for name, (fe, gt) in mono_trackers(root, True).items():
            est, ref = (np.stack([se3_inverse(t)[:3, 3] for t in traj])
                        for traj in (fe.trajectory, gt))
            print(f"{name}: {num} frames at {width}x{height}, keyframes "
                  f"{len(fe.map.keyframes)}, map points "
                  f"{fe.map.num_points}, lost at the end {fe.lost_frames}, "
                  f"ATE {ate_rmse(est, ref):.5f} m similarity-aligned "
                  f"(scale {umeyama_alignment(est, ref)[0]:.4f}), "
                  f"{ate_rmse(est, ref, with_scale=False):.5f} m rigid",
                  flush=True)
