"""tests/test_fisheye_e2e.py's Kannala-Brandt8 sequence through the port:
the frontend's rectification (tracking/frontend.py, the camera's
undistort remap), its RGB-D tracking with the port's own vision, and the
port's online mapper, on the CPU.

The distorted frames are made as the JAX file makes them (its oversized JAX
render of tests/test_frontend.py's textured plane, warped by
`distort_to_fisheye`); the thresholds are the JAX file's: the rectified
first frame within 28 dB of the pinhole view inside the undistortion mask,
ATE below 5 cm, and a render of the map from a new pose above 15 dB. Slow,
as in JAX (the plain blends of the mapper on the CPU)."""
import numpy as np
import pytest
import torch

from photo_slam_tpu_torch.config import Config
from photo_slam_tpu_torch.mapper.mapper import GaussianMapper, SensorType
from photo_slam_tpu_torch.models.camera import FISHEYE, Camera
from photo_slam_tpu_torch.ops.losses import psnr
from photo_slam_tpu_torch.tracking.frontend import SlamFrontend
from photo_slam_tpu_torch.tracking.gt_tracker import Frame
from photo_slam_tpu_torch.utils.evaluate import ate_rmse
from photo_slam_tpu_torch.utils.math import se3_inverse
from test_torch_blend import one_torch_thread  # noqa: F401

pytest.importorskip("cv2")  # the JAX file's module imports it

from tests.test_fisheye_e2e import (distort_to_fisheye,  # noqa: E402
                                    make_fisheye_camera)
from tests.test_frontend import (H, PLANE_Z, W, F,  # noqa: E402
                                 render_frame, textured_world)

K = (0.02, -0.01, 0.003, 0.0)


def port_fisheye_camera():
    return Camera(camera_id=0, model_id=FISHEYE, width=W, height=H, fx=F,
                  fy=F, cx=W / 2, cy=H / 2,
                  dist_coeffs=np.asarray(K, np.float32))


def tensor_psnr(a, b) -> float:
    return float(psnr(torch.from_numpy(np.asarray(a, np.float32)),
                      torch.from_numpy(np.asarray(b, np.float32))))


@pytest.mark.slow
def test_kb8_sequence_tracks_and_maps(tmp_path):
    from photo_slam_tpu.ops.camera_math import build_camera_matrices
    from photo_slam_tpu.ops.render import RenderSettings, render_jit
    import jax.numpy as jnp

    jcam = make_fisheye_camera(K)
    world = textured_world(seed=1)
    big = 1.6
    W2, H2 = int(W * big), int(H * big)

    def render_big(t):
        pts, scales, quats, opac, cols = world
        mats = build_camera_matrices(np.eye(3), t, 0.01, 100.0,
                                     2 * np.arctan(W2 / (2 * F)),
                                     2 * np.arctan(H2 / (2 * F)))
        settings = RenderSettings(width=W2, height=H2,
                                  tan_fovx=W2 / (2 * F),
                                  tan_fovy=H2 / (2 * F), max_per_tile=1024)
        return np.asarray(render_jit(
            jnp.asarray(pts), jnp.asarray(scales), jnp.asarray(quats),
            jnp.asarray(opac), mats, settings, jnp.zeros(3),
            colors_precomp=jnp.asarray(cols)).image)

    frames, gts, pinholes = [], [], []
    for i in range(10):
        t = np.array([0.05 * i, 0.015 * i, 0.0])
        ph_big = render_big(t)
        img_d = distort_to_fisheye(jcam, ph_big, F, W2 / 2, H2 / 2)
        frames.append(Frame(image=img_d, quat_wxyz=np.array([1.0, 0, 0, 0]),
                            trans=t, depth=np.full((H, W), PLANE_Z,
                                                   np.float32),
                            filename=f"f{i}"))
        T = np.eye(4)
        T[:3, 3] = t
        gts.append(T)
        y0, x0 = (H2 - H) // 2, (W2 - W) // 2
        pinholes.append(ph_big[:, y0:y0 + H, x0:x0 + W])

    cam = port_fisheye_camera()
    mask = cam.undistort_mask()
    rect = np.transpose(cam.undistort_image(
        np.transpose(frames[0].image, (1, 2, 0))), (2, 0, 1))
    rect_psnr = tensor_psnr(rect * mask[None], pinholes[0] * mask[None])
    assert rect_psnr > 28.0, f"rectification round-trip {rect_psnr:.1f} dB"

    cfg = Config()
    cfg.renderer.initial_capacity = 8192
    cfg.mapper.min_num_initial_map_kfs = 2
    cfg.mapper.do_gaus_pyramid_training = False
    cfg.opt.densify_from_iter = 10000
    mapper = GaussianMapper(cfg, SensorType.RGBD, result_dir=tmp_path,
                            device="cpu")
    mapper.add_camera(cam)
    fe = SlamFrontend(cam, sensor="rgbd", kf_min_interval=1,
                      kf_tracked_ratio=2.0, enable_loop_closing=False,
                      device="cpu")
    fe.run(iter(frames), mapper.queue.push)
    mapper.run(is_tracker_done=lambda: True, max_iterations=60)

    est = np.stack([se3_inverse(t)[:3, 3] for t in fe.trajectory])
    gt_pos = np.stack([se3_inverse(np.asarray(t))[:3, 3] for t in gts])
    err = ate_rmse(est, gt_pos)
    assert err < 0.05, f"fisheye-sequence ATE {err:.3f} m"

    img = mapper.render_from_pose(np.array([1.0, 0, 0, 0]),
                                  np.array([0.22, 0.07, 0.0]), W, H)
    gt_img = render_frame(world, np.eye(3), np.array([0.22, 0.07, 0.0]),
                          jcam)  # same intrinsics, pinhole
    p = tensor_psnr(img, gt_img * mask[None])
    print(f"[fisheye] port: rectification {rect_psnr:.2f} dB, ATE "
          f"{err:.4f} m, map render {p:.2f} dB")
    assert p > 15.0, f"fisheye-mapped render PSNR {p:.2f} dB"
