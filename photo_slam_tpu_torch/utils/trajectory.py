"""Trajectory savers: TUM / EuRoC / KITTI formats, the reference's 5-file set.

photo_slam_tpu/utils/trajectory.py, copied (numpy only).

The reference writes, per run (reference: examples/replica_rgbd.cpp:188-192;
ORB-SLAM3/src/System.cc SaveTrajectoryTUM/SaveKeyFrameTrajectoryTUM/
SaveTrajectoryEuRoC/SaveKeyFrameTrajectoryEuRoC/SaveTrajectoryKITTI):

    CameraTrajectory_TUM.txt      t tx ty tz qx qy qz qw   (camera-to-world)
    KeyFrameTrajectory_TUM.txt    same, keyframes only
    CameraTrajectory_EuRoC.txt    t_ns tx ty tz qw qx qy qz
    KeyFrameTrajectory_EuRoC.txt  same, keyframes only
    CameraTrajectory_KITTI.txt    12 floats: 3x4 camera-to-world row-major

so the Photo-SLAM-eval tooling (evo / evaluate_ate_scale.py) runs unchanged.
"""
from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np

from photo_slam_tpu_torch.utils.math import rotmat_to_quat_numpy, se3_inverse


def _twc_quat(tcw: np.ndarray):
    """camera-to-world translation + quaternion (w, x, y, z)."""
    twc = se3_inverse(np.asarray(tcw, np.float64))
    return twc, rotmat_to_quat_numpy(twc[:3, :3])


def save_tum(path, stamps: Sequence[float],
             poses_tcw: Sequence[np.ndarray]) -> None:
    lines = []
    for t, tcw in zip(stamps, poses_tcw):
        twc, q = _twc_quat(tcw)
        p = twc[:3, 3]
        lines.append(f"{t:.6f} {p[0]:.7f} {p[1]:.7f} {p[2]:.7f} "
                     f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}")
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text("\n".join(lines) + "\n")


def save_euroc(path, stamps: Sequence[float],
               poses_tcw: Sequence[np.ndarray]) -> None:
    """EuRoC convention: nanosecond integer stamps, qw first."""
    lines = []
    for t, tcw in zip(stamps, poses_tcw):
        twc, q = _twc_quat(tcw)
        p = twc[:3, 3]
        lines.append(f"{int(round(t * 1e9))} {p[0]:.7f} {p[1]:.7f} "
                     f"{p[2]:.7f} {q[0]:.7f} {q[1]:.7f} {q[2]:.7f} "
                     f"{q[3]:.7f}")
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text("\n".join(lines) + "\n")


def save_kitti(path, poses_tcw: Sequence[np.ndarray]) -> None:
    """KITTI: one 3x4 camera-to-world matrix per line, row-major."""
    lines = []
    for tcw in poses_tcw:
        twc = se3_inverse(np.asarray(tcw, np.float64))
        lines.append(" ".join(f"{v:.9e}" for v in twc[:3].reshape(-1)))
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text("\n".join(lines) + "\n")


def save_all_formats(out_dir, frame_stamps, frame_tcw, kf_stamps,
                     kf_tcw) -> list[str]:
    """Write the reference's 5-file trajectory set; returns the file names."""
    out = Path(out_dir)
    save_tum(out / "CameraTrajectory_TUM.txt", frame_stamps, frame_tcw)
    save_tum(out / "KeyFrameTrajectory_TUM.txt", kf_stamps, kf_tcw)
    save_euroc(out / "CameraTrajectory_EuRoC.txt", frame_stamps, frame_tcw)
    save_euroc(out / "KeyFrameTrajectory_EuRoC.txt", kf_stamps, kf_tcw)
    save_kitti(out / "CameraTrajectory_KITTI.txt", frame_tcw)
    return ["CameraTrajectory_TUM.txt", "KeyFrameTrajectory_TUM.txt",
            "CameraTrajectory_EuRoC.txt", "KeyFrameTrajectory_EuRoC.txt",
            "CameraTrajectory_KITTI.txt"]
