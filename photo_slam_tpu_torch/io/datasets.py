"""Dataset loaders: Replica and TUM RGB-D.

Counterpart of photo_slam_tpu/io/datasets.py (numpy only; reference:
examples/replica_rgbd.cpp:43-110 LoadImages, examples/tum_rgbd.cpp
association parsing) with ground-truth trajectory loading, so the GT-pose
tracker drives the mapper without a live feature tracker. Loaders yield
`tracking.gt_tracker.Frame` objects lazily: images are read on demand, on
the tracker's thread. The EuRoC stereo loader (rectification, IMU) comes
with the host-SLAM slice of the port.
"""
from __future__ import annotations

from pathlib import Path
from typing import Iterator, Optional

import numpy as np

from photo_slam_tpu_torch.io.images import load_depth, load_image_chw
from photo_slam_tpu_torch.models.camera import PINHOLE, Camera
from photo_slam_tpu_torch.tracking.gt_tracker import Frame
from photo_slam_tpu_torch.utils.math import (quat_to_rotmat_numpy,
                                             rotmat_to_quat_numpy,
                                             se3_inverse)


# ---------------------------------------------------------------------------
# Replica (as packaged for Photo-SLAM: <seq>/results/frame*.jpg depth*.png,
# <seq>/traj.txt with per-frame 4x4 row-major camera-to-world)
# ---------------------------------------------------------------------------

REPLICA_DEPTH_SCALE = 6553.5  # cfg/ORB_SLAM3/RGB-D/Replica/*.yaml DepthMapFactor
REPLICA_CAMERA = dict(fx=600.0, fy=600.0, cx=599.5, cy=339.5,
                      width=1200, height=680)


class ReplicaDataset:
    def __init__(self, seq_dir, camera_id: int = 0, load_depth_maps=True):
        self.seq_dir = Path(seq_dir)
        results = self.seq_dir / "results"
        if not results.is_dir():
            raise FileNotFoundError(
                f"not a Replica sequence: {results} does not exist "
                f"(expected <seq>/results/frame*, depth*)")
        self.rgb_files = sorted(results.glob("frame*"))
        self.depth_files = sorted(results.glob("depth*"))
        if not self.rgb_files:
            raise FileNotFoundError(f"no frame* images under {results}")
        self.load_depth_maps = load_depth_maps
        self.poses = self._load_traj(self.seq_dir / "traj.txt")
        # Replica ships 1200x680; scale the intrinsics if the sequence was
        # resized (half-res exports, synthetic mini-sequences) instead of
        # silently sampling outside the actual images.
        cam = dict(REPLICA_CAMERA)
        probe = load_image_chw(self.rgb_files[0])
        h, w = probe.shape[1], probe.shape[2]
        if (w, h) != (cam["width"], cam["height"]):
            sx = w / cam["width"]
            sy = h / cam["height"]
            cam.update(width=w, height=h, fx=cam["fx"] * sx,
                       fy=cam["fy"] * sy,
                       cx=(cam["cx"] + 0.5) * sx - 0.5,
                       cy=(cam["cy"] + 0.5) * sy - 0.5)
        self.camera = Camera(camera_id=camera_id, model_id=PINHOLE, **cam)

    @staticmethod
    def _load_traj(path) -> Optional[np.ndarray]:
        """traj.txt: one 4x4 row-major camera-to-world matrix per line."""
        if not Path(path).exists():
            return None
        rows = np.loadtxt(path)
        return rows.reshape(-1, 4, 4)

    def __len__(self):
        return len(self.rgb_files)

    def frames(self) -> Iterator[Frame]:
        for i, rgb_path in enumerate(self.rgb_files):
            img = load_image_chw(rgb_path)
            depth = None
            if self.load_depth_maps and i < len(self.depth_files):
                depth = load_depth(self.depth_files[i], REPLICA_DEPTH_SCALE)
            quat, trans = np.array([1.0, 0, 0, 0]), np.zeros(3)
            if self.poses is not None:
                c2w = self.poses[i]
                w2c = np.linalg.inv(c2w)
                quat = rotmat_to_quat_numpy(w2c[:3, :3])
                trans = w2c[:3, 3]
            yield Frame(image=img, quat_wxyz=quat, trans=trans, depth=depth,
                        filename=rgb_path.name)


# ---------------------------------------------------------------------------
# TUM RGB-D (rgb.txt / depth.txt / groundtruth.txt, optional associations)
# ---------------------------------------------------------------------------

TUM_DEPTH_SCALE = 5000.0


def _read_tum_list(path):
    entries = []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        entries.append((float(parts[0]), parts[1:]))
    return entries


def _associate(a, b, max_dt=0.02):
    """Greedy nearest-timestamp association (the role of the reference's
    associate.py, ORB-SLAM3/evaluation)."""
    out = []
    bi = 0
    for ta, va in a:
        while bi + 1 < len(b) and abs(b[bi + 1][0] - ta) <= abs(b[bi][0] - ta):
            bi += 1
        if abs(b[bi][0] - ta) <= max_dt:
            out.append((ta, va, b[bi][0], b[bi][1]))
    return out


class TumDataset:
    def __init__(self, seq_dir, camera: Camera, camera_id: int = 0,
                 with_depth=True):
        self.seq_dir = Path(seq_dir)
        self.camera = camera
        if not (self.seq_dir / "rgb.txt").exists():
            raise FileNotFoundError(
                f"not a TUM sequence: {self.seq_dir}/rgb.txt missing")
        rgb = _read_tum_list(self.seq_dir / "rgb.txt")
        self.with_depth = with_depth and (self.seq_dir / "depth.txt").exists()
        if self.with_depth:
            depth = _read_tum_list(self.seq_dir / "depth.txt")
            self.assoc = _associate(rgb, depth)
        else:
            self.assoc = [(t, v, t, None) for t, v in rgb]
        gt_path = self.seq_dir / "groundtruth.txt"
        self.gt = _read_tum_list(gt_path) if gt_path.exists() else None

    def __len__(self):
        return len(self.assoc)

    def _pose_at(self, t):
        """Nearest GT pose: tx ty tz qx qy qz qw (camera-to-world)."""
        if not self.gt:
            return np.array([1.0, 0, 0, 0]), np.zeros(3)
        times = np.array([g[0] for g in self.gt])
        i = int(np.argmin(np.abs(times - t)))
        vals = [float(x) for x in self.gt[i][1]]
        t_wc = np.array(vals[0:3])
        qx, qy, qz, qw = vals[3:7]
        R_wc = quat_to_rotmat_numpy(np.array([qw, qx, qy, qz]))
        Twc = np.eye(4)
        Twc[:3, :3] = R_wc
        Twc[:3, 3] = t_wc
        Tcw = se3_inverse(Twc)
        return (rotmat_to_quat_numpy(Tcw[:3, :3]),
                Tcw[:3, 3])

    def frames(self) -> Iterator[Frame]:
        for t_rgb, rgb_v, t_d, d_v in self.assoc:
            img = load_image_chw(self.seq_dir / rgb_v[0])
            depth = (load_depth(self.seq_dir / d_v[0], TUM_DEPTH_SCALE)
                     if d_v is not None else None)
            quat, trans = self._pose_at(t_rgb)
            yield Frame(image=img, quat_wxyz=quat, trans=trans, depth=depth,
                        filename=Path(rgb_v[0]).name)
