"""tests/test_pyramid.py on the port: the Gaussian-pyramid coarse-to-fine
schedule (GausPyramid.* behaviour) and training across the levels, whose
losses are held iteration by iteration against the JAX trainer's on the
same inputs (JAX in its CPU "tiled" mode at 32 px tiles, the port's plain
kernel path)."""
import jax
import numpy as np
import pytest

from photo_slam_tpu.config import Config as JConfig
from photo_slam_tpu.mapper.trainer import GaussianTrainer as JTrainer
from photo_slam_tpu.models.camera import PINHOLE as JPINHOLE
from photo_slam_tpu.models.camera import Camera as JCamera
from photo_slam_tpu.models.keyframe import Keyframe as JKeyframe
from photo_slam_tpu.models.scene import Scene as JScene
from photo_slam_tpu_torch.config import Config
from photo_slam_tpu_torch.mapper.trainer import GaussianTrainer
from photo_slam_tpu_torch.models.camera import PINHOLE, Camera
from photo_slam_tpu_torch.models.keyframe import Keyframe
from photo_slam_tpu_torch.models.scene import Scene
from test_torch_blend import one_torch_thread  # noqa: F401

W, H = 64, 48


def test_pyramid_levels_schedule():
    cam = Camera(camera_id=0, model_id=PINHOLE, width=W, height=H,
                 fx=60.0, fy=60.0, cx=W / 2, cy=H / 2)
    kf = Keyframe(fid=0, camera=cam)
    kf.set_pose(np.array([1.0, 0, 0, 0]), np.zeros(3), device="cpu")
    img = np.random.RandomState(0).rand(3, H, W).astype(np.float32)
    kf.set_image(img, num_sub_levels=2, sub_level_times_of_use=2)
    # Level budget: 2x level 0, 2x level 1, then full resolution forever
    # (reference: src/gaussian_keyframe.cpp:206-216).
    levels = [kf.current_pyramid_level() for _ in range(6)]
    assert levels == [0, 0, 1, 1, 2, 2]
    assert kf.level_image(0).shape == (3, H // 4, W // 4)
    assert kf.level_image(1).shape == (3, H // 2, W // 2)
    assert kf.level_image(2).shape == (3, H, W)


def test_pyramid_images_match_jax():
    img = np.random.RandomState(0).rand(3, H, W).astype(np.float32)
    levels = []
    for cam_cls, kf_cls, pinhole, kw in (
            (Camera, Keyframe, PINHOLE, {"device": "cpu"}),
            (JCamera, JKeyframe, JPINHOLE, {})):
        cam = cam_cls(camera_id=0, model_id=pinhole, width=W, height=H,
                      fx=60.0, fy=60.0, cx=W / 2, cy=H / 2)
        kf = kf_cls(fid=0, camera=cam)
        kf.set_pose(np.array([1.0, 0, 0, 0]), np.zeros(3), **kw)
        kf.set_image(img, num_sub_levels=2, sub_level_times_of_use=2)
        levels.append([np.asarray(kf.level_image(i)) for i in range(3)])
    for a, b in zip(*levels):
        np.testing.assert_allclose(a, b, atol=1e-6)


def pyramid_trainer(cfg, cam_cls, kf_cls, scene_cls, trainer_cls, pinhole,
                    **kw):
    """tests/test_pyramid.py::test_training_across_pyramid_levels' trainer,
    for either package (kw: the port's device)."""
    cfg.renderer.initial_capacity = 512
    cfg.mapper.do_gaus_pyramid_training = True
    cfg.mapper.num_gaus_pyramid_sub_levels = 2
    cfg.mapper.gaus_pyramid_sub_level_times_of_use = 2
    cfg.opt.densify_from_iter = 10**9
    cam = cam_cls(camera_id=0, model_id=pinhole, width=W, height=H,
                  fx=60.0, fy=60.0, cx=W / 2, cy=H / 2)
    scene = scene_cls()
    scene.add_camera(cam)
    rng = np.random.RandomState(0)
    kf = kf_cls(fid=0, camera=cam)
    kf.set_pose(np.array([1.0, 0, 0, 0]), np.zeros(3), **kw)
    img = np.zeros((3, H, W), np.float32)
    img[0] = 0.8  # solid-ish target
    kf.set_image(img, num_sub_levels=2, sub_level_times_of_use=2)
    kf.remaining_times_of_use = 10**9
    scene.add_keyframe(kf)
    trainer = trainer_cls(cfg, scene, **kw)
    pts = np.stack([rng.uniform(-1, 1, 60), rng.uniform(-0.8, 0.8, 60),
                    rng.uniform(4, 6, 60)], 1).astype(np.float32)
    trainer.initialize_map(pts, rng.rand(60, 3).astype(np.float32))
    return trainer


def test_training_across_pyramid_levels_tracks_jax():
    """8 iterations cross the level 0 -> 1 -> 2 boundaries (16x12, 32x24,
    64x48): each loss within 1e-4 relative of the JAX trainer's (the
    trainer tests' tolerance), the map finite."""
    port = pyramid_trainer(Config(), Camera, Keyframe, Scene,
                           GaussianTrainer, PINHOLE, device="cpu")
    jcfg = JConfig()
    # The port's kernel path bins at 32 px tiles; JAX "tiled" at the same
    # tile, with caps that bind on neither side at these sizes.
    jcfg.renderer.tile = 32
    jt = pyramid_trainer(jcfg, JCamera, JKeyframe, JScene, JTrainer,
                         JPINHOLE)
    kf = port.scene.keyframes[0]
    levels = []
    for _ in range(8):
        # The level this iteration trains at: the first with budget left.
        levels.append(next((i for i, n in enumerate(kf.pyramid_times_of_use)
                            if n > 0), len(kf.pyramid)))
        m = port.train_iteration()
        jm = jt.train_iteration()
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]),
                                                 rel=1e-4)
    assert levels == [0, 0, 1, 1, 2, 2, 2, 2]
    for p in port.state.params:
        assert np.isfinite(p.numpy()).all()
    for leaf in jax.tree.leaves(jt.state.params):
        assert np.isfinite(np.asarray(leaf)).all()
