"""tests/test_checkpoint.py on the port: full-state checkpoint and resume
(mapper/trainer.py save_checkpoint / load_checkpoint), on the CPU, where
the kernels' plain versions run. Training continues bit-exactly."""
import numpy as np
import pytest
import torch

from photo_slam_tpu_torch.config import Config
from photo_slam_tpu_torch.mapper.trainer import GaussianTrainer
from photo_slam_tpu_torch.models.camera import PINHOLE, Camera
from photo_slam_tpu_torch.models.keyframe import Keyframe
from photo_slam_tpu_torch.models.scene import Scene
from test_torch_blend import one_torch_thread  # noqa: F401

W, H = 64, 48


def make_trainer(seed=0):
    """tests/test_checkpoint.py::make_trainer on the port."""
    cfg = Config()
    cfg.renderer.initial_capacity = 256
    cfg.mapper.do_gaus_pyramid_training = False
    cfg.opt.densify_from_iter = 10**9
    cam = Camera(camera_id=0, model_id=PINHOLE, width=W, height=H,
                 fx=60.0, fy=60.0, cx=W / 2, cy=H / 2)
    scene = Scene()
    scene.add_camera(cam)
    rng = np.random.RandomState(7)
    kf = Keyframe(fid=0, camera=cam)
    kf.set_pose(np.array([1.0, 0, 0, 0]), np.zeros(3), device="cpu")
    kf.set_image(rng.rand(3, H, W).astype(np.float32))
    kf.remaining_times_of_use = 10**9
    scene.add_keyframe(kf)
    trainer = GaussianTrainer(cfg, scene, seed=seed, device="cpu")
    pts = np.stack([rng.uniform(-1, 1, 50), rng.uniform(-0.8, 0.8, 50),
                    rng.uniform(4, 6, 50)], 1).astype(np.float32)
    trainer.initialize_map(pts, rng.rand(50, 3).astype(np.float32))
    return trainer


def test_resume_is_bit_exact(tmp_path):
    t1 = make_trainer()
    for _ in range(5):
        t1.train_iteration()
    ckpt = tmp_path / "state.npz"
    t1.save_checkpoint(ckpt)

    # Continue the original for 3 more steps.
    for _ in range(3):
        t1.train_iteration()

    # Resume a fresh trainer from the checkpoint and run the same 3 steps.
    t2 = make_trainer()
    t2.load_checkpoint(ckpt)
    assert t2.iteration == 5
    for _ in range(3):
        t2.train_iteration()

    np.testing.assert_array_equal(t1.state.params.xyz.numpy(),
                                  t2.state.params.xyz.numpy())
    np.testing.assert_array_equal(t1.opt_state.m.xyz.numpy(),
                                  t2.opt_state.m.xyz.numpy())
    assert int(t1.opt_state.step) == int(t2.opt_state.step) == 8


def test_resume_is_bit_exact_in_every_tensor(tmp_path):
    """Beyond the JAX file: every parameter group, both moments and the
    densification statistics."""
    t1 = make_trainer()
    for _ in range(5):
        t1.train_iteration()
    t1.save_checkpoint(tmp_path / "state.npz")
    for _ in range(3):
        t1.train_iteration()
    t2 = make_trainer(seed=9)
    t2.load_checkpoint(tmp_path / "state.npz")
    for _ in range(3):
        t2.train_iteration()
    for a, b in ((t1.state.params, t2.state.params),
                 (t1.opt_state.m, t2.opt_state.m),
                 (t1.opt_state.v, t2.opt_state.v)):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    for k in ("live", "max_radii2d", "xyz_grad_accum", "denom",
              "exist_since_iter"):
        assert torch.equal(getattr(t1.state, k), getattr(t2.state, k)), k
    assert t1.ema_loss == t2.ema_loss


def test_checkpoint_preserves_counts(tmp_path):
    t1 = make_trainer()
    t1.train_iteration()
    ckpt = tmp_path / "s.npz"
    t1.save_checkpoint(ckpt)
    t2 = make_trainer(seed=9)
    t2.load_checkpoint(ckpt)
    assert int(t2.state.live.sum()) == int(t1.state.live.sum())
    assert t2.default_sh == t1.default_sh
    assert t2.ema_loss == pytest.approx(t1.ema_loss)
