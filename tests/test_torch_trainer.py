"""The port's training slice against the JAX package: train_step over 5
steps (driven by train_chunk) on the same map, views and Adam state (JAX mode="pallas",
interpreted), the port's GaussianTrainer end to end on the fixture of
tests/test_trainer.py, checkpoints crossing between the two trainers, and
the train_colmap CLI on the CPU, also through capacity growth (against the
JAX app) and at the capacity ceiling."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photo_slam_tpu.config import Config as JConfig
from photo_slam_tpu.mapper import trainer as jtrainer
from photo_slam_tpu.models import gaussian_model as jgm
from photo_slam_tpu.models import optimizer as joptim
from photo_slam_tpu.models.scene import Scene as JScene
from photo_slam_tpu.ops.camera_math import build_camera_matrices as jcam
from photo_slam_tpu.ops.render import RenderSettings as JSettings
from photo_slam_tpu_torch.config import Config
from photo_slam_tpu_torch.io import colmap
from photo_slam_tpu_torch.mapper import trainer as ttrainer
from photo_slam_tpu_torch.models import gaussian_model as tgm
from photo_slam_tpu_torch.models import optimizer as toptim
from photo_slam_tpu_torch.models.camera import PINHOLE, Camera
from photo_slam_tpu_torch.models.keyframe import Keyframe
from photo_slam_tpu_torch.models.scene import Scene
from photo_slam_tpu_torch.ops.camera_math import build_camera_matrices as tcam
from photo_slam_tpu_torch.ops.render import RenderSettings, render
from photo_slam_tpu_torch.utils import ply
from test_torch_blend import one_torch_thread  # noqa: F401

W, H = 64, 48
FX = FY = 60.0
FOVX, FOVY = 2 * np.arctan(W / (2 * FX)), 2 * np.arctan(H / (2 * FY))
FIELDS = tgm.GaussianParams._fields


def gt_model(n=60, seed=3):
    """tests/test_trainer.py::gt_model."""
    rng = np.random.RandomState(seed)
    pts = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.2, 1.2, n),
                    rng.uniform(4.0, 7.0, n)], 1).astype(np.float32)
    scales = rng.uniform(0.08, 0.25, (n, 3)).astype(np.float32)
    quats = rng.randn(n, 4).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    opac = rng.uniform(0.5, 0.95, n).astype(np.float32)
    colors = rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32)
    return pts, scales, quats, opac, colors


def render_gt(model, t):
    """The model seen from camera translation t, through the port's dense
    oracle."""
    pts, scales, quats, opac, colors = (torch.from_numpy(x) for x in model)
    res = render(pts, scales, quats, opac,
                 tcam(np.eye(3), t, 0.01, 100.0, FOVX, FOVY, device="cpu"),
                 RenderSettings(width=W, height=H, tan_fovx=W / (2 * FX),
                                tan_fovy=H / (2 * FY), mode="dense"),
                 torch.zeros(3), colors_precomp=colors)
    return res.image.numpy()


SHIFTS = (-0.3, 0.0, 0.3)


def run_train_steps(model, mode, steps=5, cap=64):
    """`steps` train steps of the port and of JAX `mode` from one map and
    Adam state; returns (initial arrays, [(port loss, JAX loss)], port
    state and Adam state, JAX state and Adam state)."""
    rng = np.random.RandomState(1)
    init = model[0] + rng.randn(*model[0].shape).astype(np.float32) * 0.05
    state0 = tgm.create_from_pcd(init, rng.rand(*init.shape), sh_degree=0,
                                 capacity=cap, device="cpu")
    arrays = {k: getattr(state0.params, k).numpy() for k in FIELDS}
    live = state0.live.numpy()
    # Anisotropic scales and turned quats: at isotropic scales the rotation
    # gradient is zero up to rounding, and Adam would amplify that noise.
    arrays["log_scales"] += rng.uniform(-0.4, 0.4, (cap, 3)).astype(
        np.float32)
    arrays["quats"] = rng.randn(cap, 4).astype(np.float32)
    gts = [render_gt(model, np.array([dx, 0.0, 0.0])) for dx in SHIFTS]
    kw = dict(width=W, height=H, tan_fovx=W / (2 * FX), tan_fovy=H / (2 * FY),
              sh_degree=0, tile=32, max_tiles_per_gaussian=16,
              max_per_tile=256, tiles_per_chunk=2)
    lam = 0.2
    j_state = jgm.GaussianState(
        params=jgm.GaussianParams(**{k: jnp.asarray(v)
                                     for k, v in arrays.items()}),
        live=jnp.asarray(live), max_radii2d=jnp.zeros(cap),
        xyz_grad_accum=jnp.zeros(cap), denom=jnp.zeros(cap),
        exist_since_iter=jnp.zeros(cap, jnp.int32))
    j_opt = joptim.init_adam(j_state.params)
    j_lrs = joptim.LearningRates.create(1.6e-4, 2.5e-3, 0.05, 5e-3, 1e-3)
    t_state = tgm.state_from_numpy(arrays, live, device="cpu")
    t_opt = toptim.init_adam(t_state.params)
    t_lrs = toptim.LearningRates.create(1.6e-4, 2.5e-3, 0.05, 5e-3, 1e-3)
    j_metrics = []
    for step in range(steps):
        t = np.array([SHIFTS[step % 3], 0.0, 0.0])
        j_state, j_opt, jm = jtrainer.train_step(
            j_state, j_opt, jcam(np.eye(3), t, 0.01, 100.0, FOVX, FOVY),
            jnp.asarray(gts[step % 3]), jnp.ones((H, W)), j_lrs,
            jnp.zeros(3), jnp.float32(lam), JSettings(mode=mode, **kw))
        j_metrics.append(jm)
    # The port takes the same views (step % 3) from a resident view ring.
    views = [tcam(np.eye(3), np.array([dx, 0.0, 0.0]), 0.01, 100.0, FOVX,
                  FOVY, device="cpu") for dx in SHIFTS]
    t_state, t_opt, tm = ttrainer.train_chunk(
        t_state, t_opt, type(views[0])(*(torch.stack(x) for x in zip(*views))),
        torch.from_numpy(np.stack(gts)), torch.ones((H, W)), t_lrs,
        torch.zeros(3), lam, 0, RenderSettings(mode="pallas", **kw), steps)
    losses = []
    for step, jm in enumerate(j_metrics):
        losses.append((tm["loss"][step].item(), float(jm["loss"])))
        assert int(tm["num_visible"][step]) == int(jm["num_visible"])
    return arrays, losses, (t_state, t_opt), (j_state, j_opt)


@pytest.mark.parametrize("mode", ["pallas", "tiled"])
def test_train_step_tracks_jax_over_five_steps(mode):
    """Loss per step within 1e-4 relative, and each parameter group's
    5-step update within a share of its largest update. Against JAX tiled
    (f32 autodiff over the same entries) the share is 6e-3. Against JAX
    pallas, whose transpose rounds routed gradient rows to bf16, Adam turns
    the gradient noise of near-zero gradients into larger differences of a
    few updates (at most 9.1e-3 of the largest, in quats), so there it is
    2e-2."""
    arrays, losses, (t_state, t_opt), (j_state, j_opt) = run_train_steps(
        gt_model(n=40, seed=5), mode)
    for got, want in losses:
        assert got == pytest.approx(want, rel=1e-4)
    assert int(t_opt.step) == int(j_opt.step) == 5
    for k in FIELDS:
        if arrays[k].size == 0:   # features_rest at SH degree 0
            continue
        a = getattr(t_state.params, k).numpy() - arrays[k]
        b = np.asarray(getattr(j_state.params, k)) - arrays[k]
        scale = np.abs(b).max()
        assert scale > 0, k
        share = 6e-3 if mode == "tiled" else 2e-2
        np.testing.assert_allclose(a, b, atol=share * scale,
                                   err_msg=f"update of {k}")
    scale = np.abs(np.asarray(j_state.xyz_grad_accum)).max()
    np.testing.assert_allclose(t_state.xyz_grad_accum.numpy(),
                               np.asarray(j_state.xyz_grad_accum),
                               atol=6e-3 * scale)
    np.testing.assert_array_equal(t_state.max_radii2d.numpy(),
                                  np.asarray(j_state.max_radii2d))


def make_scene(cfg):
    cam = Camera(camera_id=0, model_id=PINHOLE, width=W, height=H, fx=FX,
                 fy=FY, cx=W / 2, cy=H / 2)
    scene = Scene()
    scene.add_camera(cam)
    model = gt_model()
    for i, dx in enumerate(SHIFTS):
        kf = Keyframe(fid=i, camera=cam)
        kf.set_pose(np.array([1.0, 0, 0, 0]), np.array([dx, 0.0, 0.0]),
                    device="cpu")
        kf.set_image(render_gt(model, np.array([dx, 0.0, 0.0])))
        kf.remaining_times_of_use = 10**9
        scene.add_keyframe(kf)
    return scene, model


@pytest.fixture(scope="module")
def trained():
    """tests/test_trainer.py::trained on the port, on the CPU."""
    cfg = Config()
    cfg.renderer.initial_capacity = 512
    cfg.opt.densify_from_iter = 20
    cfg.opt.densification_interval = 25
    cfg.opt.densify_until_iter = 100
    cfg.opt.opacity_reset_interval = 0
    cfg.opt.position_lr_max_steps = 150
    cfg.mapper.do_gaus_pyramid_training = False
    scene, model = make_scene(cfg)
    trainer = ttrainer.GaussianTrainer(cfg, scene, seed=0, device="cpu")
    rng = np.random.RandomState(0)
    init_cols = np.clip(model[4] + rng.randn(*model[4].shape) * 0.2, 0, 1)
    trainer.initialize_map(model[0], init_cols.astype(np.float32))
    psnr0 = float(trainer.train_iteration()["psnr"])
    trainer.train(num_iterations=149)
    return trainer, psnr0


def test_trainer_end_to_end(trained, tmp_path):
    """The assertions of tests/test_trainer.py::TestEndToEnd."""
    trainer, psnr0 = trained
    m = trainer.metrics
    assert m.last_psnr > psnr0 + 3.0 and m.last_psnr > 20.0, (psnr0,
                                                              m.last_psnr)
    assert np.isfinite(m.ema_loss) and m.ema_loss < 0.1
    assert m.num_live != 60 or m.num_dropped > 0
    assert int(trainer.opt_state.step) == 150
    for p in trainer.state.params:
        assert torch.isfinite(p).all()

    path = tmp_path / "ckpt.ply"
    trainer.save_ply(path)
    cfg2 = Config()
    cfg2.renderer.initial_capacity = 512
    trainer2 = ttrainer.GaussianTrainer(cfg2, trainer.scene, seed=1,
                                        device="cpu")
    trainer2.load_ply(path)
    assert int(tgm.num_live(trainer2.state)) == m.num_live
    kf = trainer.scene.keyframes[0]
    settings = RenderSettings(width=W, height=H, tan_fovx=W / (2 * FX),
                              tan_fovy=H / (2 * FY),
                              sh_degree=trainer.default_sh)

    def img_of(state):
        s, q, o = tgm.activated(state.params)
        return render(state.params.xyz, s, q, o, kf.matrices, settings,
                      torch.zeros(3), shs=tgm.sh_features(state.params),
                      live_mask=state.live).image

    np.testing.assert_allclose(img_of(trainer2.state).numpy(),
                               img_of(trainer.state).numpy(), atol=1e-4)


def test_capacity_growth():
    """tests/test_trainer.py::test_capacity_growth on the port."""
    cfg = Config()
    cfg.renderer.initial_capacity = 64
    cam = Camera(camera_id=0, model_id=PINHOLE, width=W, height=H, fx=FX,
                 fy=FY, cx=W / 2, cy=H / 2)
    scene = Scene()
    scene.add_camera(cam)
    kf = Keyframe(fid=0, camera=cam)
    kf.set_pose(np.array([1.0, 0, 0, 0]), np.zeros(3), device="cpu")
    kf.set_image(np.zeros((3, H, W), np.float32))
    scene.add_keyframe(kf)
    trainer = ttrainer.GaussianTrainer(cfg, scene, device="cpu")
    rng = np.random.RandomState(0)
    trainer.initialize_map(rng.randn(40, 3).astype(np.float32) + [0, 0, 5],
                           rng.rand(40, 3).astype(np.float32))
    cap0 = trainer.state.capacity
    inserted = trainer.increase_pcd(
        rng.randn(100, 3).astype(np.float32) + [0, 0, 5],
        rng.rand(100, 3).astype(np.float32))
    assert inserted == 100 and trainer.state.capacity > cap0
    assert int(tgm.num_live(trainer.state)) == 140
    assert trainer.opt_state.m.xyz.shape[0] == trainer.state.capacity


def test_checkpoints_cross_load_both_ways(trained, tmp_path):
    trainer, _ = trained
    port_ckpt = tmp_path / "port.npz"
    trainer.save_checkpoint(port_ckpt)
    jt = jtrainer.GaussianTrainer(JConfig(), JScene())
    jt.load_checkpoint(port_ckpt)
    assert (jt.iteration, jt.default_sh) == (trainer.iteration,
                                             trainer.default_sh)
    assert int(jt.opt_state.step) == int(trainer.opt_state.step)
    for k in FIELDS:
        for a, b in ((trainer.state.params, jt.state.params),
                     (trainer.opt_state.m, jt.opt_state.m),
                     (trainer.opt_state.v, jt.opt_state.v)):
            np.testing.assert_array_equal(getattr(a, k).numpy(),
                                          np.asarray(getattr(b, k)))
    for k in ("live", "max_radii2d", "xyz_grad_accum", "denom",
              "exist_since_iter"):
        np.testing.assert_array_equal(getattr(trainer.state, k).numpy(),
                                      np.asarray(getattr(jt.state, k)))

    # And back: the JAX trainer's checkpoint into a fresh port trainer.
    jax_ckpt = tmp_path / "jax.npz"
    jt.iteration += 7
    jt.save_checkpoint(jax_ckpt)
    back = ttrainer.GaussianTrainer(Config(), Scene(), device="cpu")
    back.load_checkpoint(jax_ckpt)
    assert back.iteration == trainer.iteration + 7
    assert back.ema_loss == trainer.ema_loss
    assert back.opt_state.step.dtype == torch.int32
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(back.opt_state.v, k).numpy(),
                                      np.asarray(getattr(jt.opt_state.v, k)))
        np.testing.assert_array_equal(getattr(back.state.params, k).numpy(),
                                      np.asarray(getattr(jt.state.params, k)))
    np.testing.assert_array_equal(back.state.live.numpy(),
                                  np.asarray(jt.state.live))


def write_colmap_set(root, model):
    """A tiny COLMAP set of `model` seen from SHIFTS, written with the
    port's writers and PIL under root/sparse/0 and root/images."""
    from PIL import Image

    sparse = root / "sparse" / "0"
    sparse.mkdir(parents=True)
    imgdir = root / "images"
    imgdir.mkdir()
    images = {}
    for i, dx in enumerate(SHIFTS):
        img = render_gt(model, np.array([dx, 0.0, 0.0]))
        name = f"frame_{i:03d}.png"
        Image.fromarray((np.clip(img.transpose(1, 2, 0), 0, 1) * 255)
                        .astype(np.uint8)).save(imgdir / name)
        images[i + 1] = colmap.ColmapImage(
            image_id=i + 1, quat_wxyz=np.array([1.0, 0, 0, 0]),
            trans=np.array([dx, 0.0, 0.0]), camera_id=1, name=name,
            xys=np.zeros((0, 2)), point3d_ids=np.zeros(0, np.int64))
    colmap.write_cameras_bin(sparse / "cameras.bin", {1: colmap.ColmapCamera(
        1, "PINHOLE", W, H, np.array([FX, FY, W / 2, H / 2]))})
    colmap.write_images_bin(sparse / "images.bin", images)
    colmap.write_points3d_bin(sparse / "points3D.bin",
                              np.arange(len(model[0])), model[0], model[4])
    return root


def test_train_colmap_cli_on_cpu(tmp_path):
    """A tiny COLMAP set written with the port's writers and PIL, trained
    for 5 iterations with --device cpu."""
    from photo_slam_tpu_torch.apps import train_colmap

    model = gt_model(n=50, seed=1)
    write_colmap_set(tmp_path / "data", model)
    out = tmp_path / "out"
    train_colmap.main(["--data", str(tmp_path / "data"), "--out", str(out),
                       "--iters", "5", "--log-every", "0", "--device", "cpu"])
    summary = json.loads((out / "summary.json").read_text())
    assert summary["iterations"] == 5 and summary["device"] == "cpu"
    assert np.isfinite(summary["ema_loss"])
    (ply_path,) = (out / "point_cloud").rglob("point_cloud.ply")
    assert ply.load_gaussian_ply(ply_path)[0].shape == (50, 3)
    xyz, rgb = ply.load_points_ply(out / "input.ply")
    np.testing.assert_allclose(xyz, model[0], atol=1e-6)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_colmap.main(["--data", str(tmp_path / "data"),
                               "--out", str(out)])


def growth_config(cfg):
    """A schedule that grows the capacity in 8 iterations from 50 points:
    capacity 128 at the start (initial_capacity 64), densify at iterations
    4, 6 and 8. At grad threshold 0 every live Gaussian is a candidate, so
    each event doubles the live count whatever the gradients (the two
    packages' renders agree only to rounding): 50 -> 100 -> 200 -> 400;
    before the event at 6, 100 live and a quarter's headroom no longer fit
    in 128 slots, and the capacity grows to round_capacity's smallest
    bucket, 4096."""
    cfg.renderer.initial_capacity = 64
    cfg.opt.densify_from_iter = 2
    cfg.opt.densification_interval = 2
    cfg.opt.densify_until_iter = 10
    cfg.opt.densify_grad_threshold = 0.0
    cfg.opt.opacity_reset_interval = 0
    cfg.mapper.do_gaus_pyramid_training = False
    return cfg


def test_train_colmap_grows_capacity_as_jax(tmp_path, monkeypatch):
    """train_colmap's main on the CPU through a capacity growth, held
    against the JAX app's main on the same COLMAP set (JAX in its CPU
    "tiled" mode at 32 px tiles): the live count and the capacity after
    the growth, and the summary's trace of them."""
    from photo_slam_tpu.apps import train_colmap as japp
    from photo_slam_tpu_torch.apps import train_colmap as tapp

    data = write_colmap_set(tmp_path / "data", gt_model(n=50, seed=1))
    jax_cfg = growth_config(JConfig())
    jax_cfg.renderer.tile = 32
    jax_trainers = []

    class Recorded(japp.GaussianTrainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            jax_trainers.append(self)

    monkeypatch.setattr(japp, "GaussianTrainer", Recorded)
    monkeypatch.setattr(japp, "Config", lambda: jax_cfg)
    port_cfg = growth_config(Config())
    monkeypatch.setattr(tapp, "Config", lambda: port_cfg)
    argv = ["--data", str(data), "--iters", "8", "--log-every", "2"]
    japp.main(argv + ["--out", str(tmp_path / "jax")])
    summary, port = tapp.main(argv + ["--out", str(tmp_path / "port"),
                                      "--device", "cpu"])
    (jax_t,) = jax_trainers
    assert int(tgm.num_live(port.state)) == int(jgm.num_live(
        jax_t.state)) == 400
    assert port.state.capacity == jax_t.state.capacity == 4096
    assert port.opt_state.m.xyz.shape[0] == port.state.live.shape[0] == 4096
    assert summary == json.loads(
        (tmp_path / "port" / "summary.json").read_text())
    assert summary["num_gaussians"] == 400 and summary["capacity"] == 4096
    assert summary["ceiling_reached_at"] is None
    assert summary["num_dropped"] == 0 and summary["peak_memory_gib"] is None
    assert [(r["iter"], r["live"], r["capacity"])
            for r in summary["trace"]] == [(2, 50, 128), (4, 100, 128),
                                           (6, 200, 4096), (8, 400, 4096)]
    assert np.isfinite(summary["first_psnr"])
    for p in port.state.params:
        assert torch.isfinite(p).all()


def test_train_colmap_drops_at_the_ceiling(tmp_path, monkeypatch):
    """At max_capacity the map stops growing: the same schedule with the
    ceiling at 256 grows to it (not to 4096) before the event at 6, and the
    event at 8 approves only as many of its 200 candidates as there are
    free slots (56, the largest accumulated gradients first), so every
    approved copy places and none is counted as dropped."""
    from photo_slam_tpu_torch.apps import train_colmap as tapp

    data = write_colmap_set(tmp_path / "data", gt_model(n=50, seed=1))
    cfg = growth_config(Config())
    cfg.renderer.max_capacity = 256
    monkeypatch.setattr(tapp, "Config", lambda: cfg)
    tapp.main(["--data", str(data), "--out", str(tmp_path / "out"),
               "--iters", "8", "--log-every", "2", "--device", "cpu"])
    summary = json.loads((tmp_path / "out" / "summary.json").read_text())
    assert summary["capacity"] == 256 and summary["ceiling_reached_at"] == 6
    assert summary["num_gaussians"] == 256
    assert summary["num_dropped"] == 0
    assert [(r["iter"], r["live"], r["capacity"])
            for r in summary["trace"]][2:] == [(6, 200, 256), (8, 256, 256)]
