"""The port's entry points and checkpoint I/O: the view_result CLI on the
CPU against the JAX app, PLY files crossing between the packages bit for
bit, the port importing with JAX blocked, run_online with the viewer and
with batched training (against JAX's), and realsense_rgbd on captured
frames and without its SDK."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from photo_slam_tpu.config import Config as JConfig
from photo_slam_tpu.utils import ply as jply
from photo_slam_tpu_torch.apps import view_result as tview
from photo_slam_tpu_torch.config import Config
from photo_slam_tpu_torch.io.images import load_image_chw
from photo_slam_tpu_torch.utils import ply as tply
from test_torch_blend import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent


def checkpoint_arrays(n=300, k_rest=15, seed=0):
    rng = np.random.RandomState(seed)
    xyz = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1, 1, n),
                    rng.uniform(2.5, 6.0, n)], 1).astype(np.float32)
    return (xyz,
            rng.randn(n, 1, 3).astype(np.float32),
            (rng.randn(n, k_rest, 3) * 0.2).astype(np.float32),
            rng.randn(n, 1).astype(np.float32),
            np.log(rng.uniform(0.03, 0.15, (n, 3))).astype(np.float32),
            rng.randn(n, 4).astype(np.float32))


@pytest.mark.parametrize("writer,reader", [(tply, jply), (jply, tply)])
def test_ply_crosses_packages_bit_exact(tmp_path, writer, reader):
    arrays = checkpoint_arrays(k_rest=8)
    path = tmp_path / "map.ply"
    writer.save_gaussian_ply(path, *arrays)
    back = reader.load_gaussian_ply(path)
    for a, b in zip(arrays, back):
        assert b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    other = tmp_path / "again.ply"
    reader.save_gaussian_ply(other, *back)
    assert other.read_bytes() == path.read_bytes()


def test_load_state_matches_jax_trainer(tmp_path):
    from photo_slam_tpu.mapper.trainer import GaussianTrainer
    from photo_slam_tpu.models.scene import Scene

    path = tmp_path / "map.ply"
    tply.save_gaussian_ply(path, *checkpoint_arrays(k_rest=3))
    trainer = GaussianTrainer(JConfig(), Scene())
    trainer.load_ply(path)
    state, sh = tview.load_state(path, Config(), device="cpu")
    assert sh == trainer.default_sh == 1
    assert state.capacity == trainer.state.capacity
    np.testing.assert_array_equal(state.live.numpy(),
                                  np.asarray(trainer.state.live))
    for name, arr in trainer.state.params._asdict().items():
        np.testing.assert_array_equal(getattr(state.params, name).numpy(),
                                      np.asarray(arr))


def test_view_result_cli_matches_jax_app(tmp_path):
    from photo_slam_tpu.apps import view_result as jview

    path = tmp_path / "map.ply"
    tply.save_gaussian_ply(path, *checkpoint_arrays())
    args = ["--ply", str(path), "--width", "96", "--height", "64",
            "--fx", "80", "--fy", "80", "--max-views", "2"]
    tview.main(args + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    jview.main(args + ["--out", str(tmp_path / "jax")])
    names = sorted(p.name for p in (tmp_path / "port").glob("*.png"))
    assert names == ["sweep_000.png", "sweep_001.png"]
    assert names == sorted(p.name for p in (tmp_path / "jax").glob("*.png"))
    for name in names:
        a = load_image_chw(tmp_path / "port" / name)
        b = load_image_chw(tmp_path / "jax" / name)
        assert a.shape == (3, 64, 96) and a.max() > 0.05
        # 8-bit files: a 1e-7 difference can round to the next level.
        assert np.abs(a - b).max() <= 1.0 / 255.0 + 1e-6


def test_view_result_requires_available_device(tmp_path):
    path = tmp_path / "map.ply"
    tply.save_gaussian_ply(path, *checkpoint_arrays(n=10))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tview.main(["--ply", str(path), "--out", str(tmp_path / "o")])


def test_port_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['photo_slam_tpu'] = None\n"
        "import photo_slam_tpu_torch\n"
        "import photo_slam_tpu_torch.ops.render\n"
        "import photo_slam_tpu_torch.apps.view_result\n"
        "import photo_slam_tpu_torch.apps.train_colmap\n"
        "import photo_slam_tpu_torch.mapper.trainer\n"
        "import photo_slam_tpu_torch.models.densify\n"
        "import photo_slam_tpu_torch.models.optimizer\n"
        "import photo_slam_tpu_torch.kernels\n"
        "import photo_slam_tpu_torch.mapper.mapper\n"
        "import photo_slam_tpu_torch.mapper.mapping_ops\n"
        "import photo_slam_tpu_torch.mapper.recorder\n"
        "import photo_slam_tpu_torch.tracking.gt_tracker\n"
        "import photo_slam_tpu_torch.apps.online_slam\n"
        "import photo_slam_tpu_torch.apps.replay_stream\n"
        "import photo_slam_tpu_torch.io.datasets\n"
        "import photo_slam_tpu_torch.tools.synth_replica\n"
        "import photo_slam_tpu_torch.models.transforms\n"
        "import photo_slam_tpu_torch.ops.point_ops\n"
        "import photo_slam_tpu_torch.ops.depth_ops\n"
        "import photo_slam_tpu_torch.utils.trajectory\n"
        "import photo_slam_tpu_torch.utils.profiling\n"
        "import photo_slam_tpu_torch.viewer.server\n"
        "import photo_slam_tpu_torch.parallel.sharding\n"
        "import photo_slam_tpu_torch.apps.realsense_rgbd\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m, v in\n"
        "               sys.modules.items() if v is not None)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_run_online_serves_the_viewer_during_the_run(tmp_path, monkeypatch):
    """run_online(viewer=True, viewer_port=0) starts the port's viewer on a
    free port before the mapper runs (its /status answers then, with the
    tracker as its frontend) and stops it after the run."""
    import json
    import urllib.request

    from photo_slam_tpu_torch.apps import online_slam as tonline
    from photo_slam_tpu_torch.mapper import mapper as tmapper
    from photo_slam_tpu_torch.viewer import server as tserver
    from test_torch_mapper import camera, frames_for, render_frames
    from test_torch_online import Sequence, parity_cfg
    from photo_slam_tpu_torch import config as tconfig
    from photo_slam_tpu_torch.tracking import gt_tracker as tgt

    servers, seen = [], {}
    start, run = tserver.ViewerServer.start, tmapper.GaussianMapper.run

    def start_and_keep(self):
        servers.append(self)
        start(self)

    def run_and_ask(self, *a, **k):
        url = f"http://127.0.0.1:{servers[0].port}/status"
        with urllib.request.urlopen(url, timeout=30) as r:
            seen["status"] = (r.status, json.loads(r.read()))
        seen["frontend"] = servers[0].frontend
        return run(self, *a, **k)

    monkeypatch.setattr(tserver.ViewerServer, "start", start_and_keep)
    monkeypatch.setattr(tmapper.GaussianMapper, "run", run_and_ask)
    mapper = tonline.run_online(
        Sequence(camera(), frames_for(tgt, render_frames())),
        tmapper.SensorType.RGBD, parity_cfg(tconfig), tmp_path,
        keyframe_every=1, num_keypoints=100, max_iterations=3,
        frontend="gt", viewer=True, viewer_port=0, device="cpu")
    assert mapper.trainer.iteration == 3
    assert len(servers) == 1 and servers[0].port > 0
    code, status = seen["status"]
    assert code == 200 and set(status) == {"iteration", "ema_loss",
                                           "last_psnr", "num_gaussians"}
    assert isinstance(seen["frontend"], tgt.GroundTruthTracker)
    with pytest.raises(OSError):   # stopped with the run
        urllib.request.urlopen(
            f"http://127.0.0.1:{servers[0].port}/status", timeout=5)


def test_run_online_batched_matches_jax(tmp_path):
    """run_online(batch=2) of both packages (GT frontend, threaded=False,
    densify off, the samplers seeded alike): the same keyframes, use
    counts and iterations, and render_from_pose within 1e-2."""
    from photo_slam_tpu import config as jconfig
    from photo_slam_tpu.apps import online_slam as jonline
    from photo_slam_tpu.mapper import mapper as jmapper
    from photo_slam_tpu.models.camera import Camera as JCamera
    from photo_slam_tpu.tracking import gt_tracker as jgt
    from photo_slam_tpu_torch import config as tconfig
    from photo_slam_tpu_torch.apps import online_slam as tonline
    from photo_slam_tpu_torch.mapper import mapper as tmapper
    from photo_slam_tpu_torch.tracking import gt_tracker as tgt
    from test_torch_mapper import W, H, camera, frames_for, render_frames
    from test_torch_online import Sequence, parity_cfg

    frames = render_frames()
    kw = dict(keyframe_every=1, num_keypoints=100, max_iterations=6,
              threaded=False, frontend="gt", batch=2)
    jm = jonline.run_online(
        Sequence(camera(JCamera), frames_for(jgt, frames)),
        jmapper.SensorType.RGBD, parity_cfg(jconfig), tmp_path / "jax",
        **kw)
    tm = tonline.run_online(
        Sequence(camera(), frames_for(tgt, frames)), tmapper.SensorType.RGBD,
        parity_cfg(tconfig), tmp_path / "port", device="cpu", **kw)
    assert tm.trainer.iteration == jm.trainer.iteration == 6
    assert sorted(tm.scene.keyframes) == sorted(jm.scene.keyframes)
    assert tm.trainer.sampler.use_counts == jm.trainer.sampler.use_counts
    assert int(tm.trainer.opt_state.step) == int(jm.trainer.opt_state.step)
    for fid, jkf in jm.scene.keyframes.items():
        np.testing.assert_array_equal(tm.scene.keyframes[fid].trans,
                                      jkf.trans)
    for q, t, w, h in (([1.0, 0, 0, 0], [0.0, 0, 0], W, H),
                       ([0.99, 0.0, 0.05, 0.0], [0.1, 0, 0.2], 100, 60)):
        got = tm.render_from_pose(np.array(q), np.array(t), w, h)
        want = jm.render_from_pose(np.array(q), np.array(t), w, h)
        assert got.shape == want.shape == (3, h, w)
        assert np.abs(got - want).max() <= 1e-2
        assert got.max() > 0.05


def synthetic_realsense(num=12):
    """(camera, frames) standing in for capture_frames: test_torch_online's
    textured plane at depth 5 through the Replica camera at 320x181, the
    camera sliding sideways, as RealSense frames (identity pose, depth in
    metres)."""
    from photo_slam_tpu_torch.tools.synth_replica import replica_camera
    from photo_slam_tpu_torch.tracking.gt_tracker import Frame
    from test_torch_frontend import splat_render, textured_world

    cam = replica_camera(320, 181)
    world = textured_world(seed=2)
    frames = [Frame(image=splat_render(world, np.eye(3),
                                       np.array([0.04 * i, 0.01 * i, 0.0]),
                                       cam).astype(np.float32),
                    quat_wxyz=np.array([1.0, 0, 0, 0]), trans=np.zeros(3),
                    depth=np.full((cam.height, cam.width), 5.0, np.float32),
                    filename=f"rs_{i:06d}") for i in range(num)]
    return cam, iter(frames)


def test_realsense_rgbd_maps_captured_frames(tmp_path, monkeypatch):
    """realsense_rgbd.main with capture_frames replaced: the frames go
    through the ORB + PnP tracker into the mapper on --device cpu, with the
    viewer serving."""
    from photo_slam_tpu_torch.apps import realsense_rgbd

    monkeypatch.setattr(realsense_rgbd, "capture_frames",
                        lambda *a: synthetic_realsense())
    yaml = tmp_path / "mapper.yaml"
    yaml.write_text("%YAML:1.0\nOptimization.max_num_iterations: 3\n"
                    "Optimization.densify_until_iter: 3\n"
                    "Record.record_rendered_image: 0\n")
    mapper = realsense_rgbd.main(["--out", str(tmp_path / "out"), "--cfg",
                                  str(yaml), "--viewer-port", "0",
                                  "--device", "cpu"])
    assert mapper.device == torch.device("cpu")
    assert mapper.initial_mapped and len(mapper.scene.keyframes) >= 2
    assert mapper.trainer.iteration == 3
    assert (tmp_path / "out" / "psnr_shutdown.txt").exists()
    assert all(bool(torch.isfinite(p).all())
               for p in mapper.trainer.state.params)


def test_realsense_rgbd_needs_the_sdk(monkeypatch):
    """Without pyrealsense2 both packages' capture_frames raise the same
    RuntimeError."""
    from photo_slam_tpu.apps import realsense_rgbd as jrs
    from photo_slam_tpu_torch.apps import realsense_rgbd as trs

    monkeypatch.setitem(sys.modules, "pyrealsense2", None)
    with pytest.raises(RuntimeError) as got:
        trs.capture_frames(640, 480, 30, 1)
    with pytest.raises(RuntimeError) as want:
        jrs.capture_frames(640, 480, 30, 1)
    assert str(got.value) == str(want.value)
    assert "pyrealsense2 is not installed" in str(got.value)
