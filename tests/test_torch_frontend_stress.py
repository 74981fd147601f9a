"""tests/test_frontend_stress.py's scenarios on the port's SlamFrontend
(photo_slam_tpu_torch/tracking/frontend.py) with the port's own vision:
ORB, matching, PnP and the native optimizers, no cv2.

The frames are made as the JAX file makes them: its JAX render of the
splat cylinder (`_cyl_frame` over test_loop_closing's `_cylinder_world`
and its own `_full_cylinder_world`) and tests/test_frontend.py's textured
plane (`make_sequence`); only the frames cross over, as numpy arrays. The
thresholds are the JAX file's: relocalization within 3 frames of a
teleport back into the mapped region (pose within 0.05), no confident
wrong pose after a teleport into unmapped territory, an ATE below 5 cm
through half-masked frames, and (slow, as in JAX) both loops of a
400-frame session closed with an ATE below 8 cm."""
import time

import numpy as np
import pytest

from photo_slam_tpu_torch.tracking.frontend import SlamFrontend
from photo_slam_tpu_torch.tracking.gt_tracker import Frame
from photo_slam_tpu_torch.utils.math import se3_inverse, se3_log_numpy
from test_torch_blend import one_torch_thread  # noqa: F401
from test_torch_frontend import make_camera

pytest.importorskip("cv2")  # the JAX file's module imports it

from tests.test_frontend import make_sequence  # noqa: E402
from tests.test_frontend_stress import (_ate_rmse, _cyl_frame,  # noqa: E402
                                        _full_cylinder_world)
from tests.test_loop_closing import _cylinder_world  # noqa: E402


def port_frame(fr) -> Frame:
    """The JAX test's frame as the port's Frame (same fields)."""
    return Frame(image=np.asarray(fr.image, np.float32),
                 quat_wxyz=fr.quat_wxyz, trans=fr.trans, depth=fr.depth,
                 filename=fr.filename)


def cyl_frame(world, yaw, center=None):
    """(port Frame, ground-truth world->camera) of the JAX file's render."""
    from tests.test_frontend import make_camera as jax_camera

    fr, gt = _cyl_frame(world, jax_camera(), yaw, center)
    return port_frame(fr), gt


def frontend(**kw):
    return SlamFrontend(make_camera(), sensor="rgbd", device="cpu", **kw)


@pytest.fixture(scope="module")
def cylinder():
    return _cylinder_world()


def test_relocalizes_after_teleport(cylinder):
    """Track a pan away from the start, then put the camera back at a
    mapped viewpoint with no continuity: only relocalization can recover,
    within 3 frames."""
    fe = frontend(kf_min_interval=1, kf_tracked_ratio=2.0, ba_window=3,
                  enable_loop_closing=False)
    for yaw in np.linspace(0.0, 1.15, 10):
        fe.process_frame(cyl_frame(cylinder, yaw)[0])
    recovered_at = None
    for k in range(3):
        fr, gt = cyl_frame(cylinder, 0.07 + 0.03 * k)
        fe.process_frame(fr)
        if np.abs(se3_log_numpy(fe.tcw @ se3_inverse(gt))).max() < 0.05:
            recovered_at = k
            break
    fe.close()
    assert recovered_at is not None, (
        "kidnapped camera never relocalized within 3 frames")


def test_stays_lost_in_unmapped_region(cylinder):
    """A teleport to never-seen territory must not give a confident wrong
    pose: lost, or a new sub-map, but not the old track carried on."""
    fe = frontend(kf_min_interval=1, kf_tracked_ratio=2.0, ba_window=3,
                  enable_loop_closing=False)
    for yaw in np.linspace(0.0, 0.5, 6):
        fe.process_frame(cyl_frame(cylinder, yaw)[0])
    tcw_before = fe.tcw.copy()
    fr, gt = cyl_frame(cylinder, -1.8)
    fe.process_frame(fr)
    fe.close()
    moved = np.abs(se3_log_numpy(fe.tcw @ se3_inverse(tcw_before))).max()
    confident_wrong = (moved > 0.5 and np.abs(se3_log_numpy(
        fe.tcw @ se3_inverse(gt))).max() > 0.5)
    assert not confident_wrong, (
        "frontend jumped to a confident wrong pose after kidnap")


def test_tracks_through_half_masked_frames():
    """Every third frame after the fourth loses its left half (image and
    depth): tracking survives on the rest, ATE below 5 cm."""
    n_frames = 36
    trans = [np.array([0.035 * i, 0.012 * i, 0.0]) for i in range(n_frames)]
    cam, frames, gt = make_sequence(trans, seed=2)

    def occlude(fr):
        img, d = fr.image.copy(), fr.depth.copy()
        img[:, :, : cam.width // 2] = 0.0
        d[:, : cam.width // 2] = 0.0
        return Frame(image=img, quat_wxyz=fr.quat_wxyz, trans=fr.trans,
                     depth=d, filename=fr.filename)

    n_occluded = sum(1 for i in range(n_frames) if i % 3 == 1 and i > 3)
    assert n_occluded >= n_frames // 4
    fe = frontend(kf_min_interval=1, kf_tracked_ratio=2.0, ba_window=3,
                  enable_loop_closing=False)
    for i, fr in enumerate(frames):
        fr = port_frame(fr)
        fe.process_frame(occlude(fr) if i % 3 == 1 and i > 3 else fr)
    fe.flush()
    fe.close()
    assert len(fe.trajectory) == n_frames
    ate = _ate_rmse(fe.trajectory, gt)
    assert ate < 0.05, f"occlusion-burst ATE {ate:.3f} m"


@pytest.mark.slow
def test_400_frames_two_loops():
    """Two separate excursions (0 -> +1.3 rad -> 0 -> -1.3 rad -> 0) on a
    small orbit: both returns close a loop, the trajectory stays complete,
    ATE below 8 cm; the tracking times are printed."""
    world = _full_cylinder_world()
    leg = 100
    yaws = np.concatenate([np.linspace(0.0, 1.3, leg),
                           np.linspace(1.3, 0.0, leg),
                           np.linspace(0.0, -1.3, leg),
                           np.linspace(-1.3, 0.0, leg)])
    centers = np.stack([0.25 * np.sin(yaws), np.zeros_like(yaws),
                        0.25 * (np.cos(yaws) - 1.0)], 1)
    fe = frontend(kf_min_interval=3, kf_tracked_ratio=2.0, ba_window=4,
                  enable_loop_closing=True)
    gt_all, times_ms = [], []
    for yaw, c in zip(yaws, centers):
        fr, gt = cyl_frame(world, yaw, center=c)
        t0 = time.perf_counter()
        fe.process_frame(fr)
        times_ms.append(1000.0 * (time.perf_counter() - t0))
        gt_all.append(gt)
    fe.flush()
    fe.close()
    assert len(fe.trajectory) == len(yaws)
    ate = _ate_rmse(fe.trajectory, np.array(gt_all))
    print(f"[stress] 400-frame multi-loop on the port: ATE {ate:.4f} m, "
          f"loops_closed={fe.num_loops_closed}, tracking p50="
          f"{np.median(times_ms):.1f} ms p90="
          f"{np.percentile(times_ms, 90):.1f} ms")
    assert fe.num_loops_closed >= 2, (
        f"expected both excursion loops to close, got "
        f"{fe.num_loops_closed}")
    assert ate < 0.08, f"400-frame multi-loop ATE {ate:.3f} m"
