"""Ground-truth-pose tracker: a frontend that speaks MappingOperation.

Counterpart of photo_slam_tpu/tracking/gt_tracker.py. It stands in for the
ORB-SLAM3 frontend (reference layer L5, SURVEY.md §2.4) when ground-truth
trajectories are available (Replica/TUM GT files) or in tests: it selects
keyframes on a stride, samples sparse "feature" points from the depth
image, and pushes LocalMappingBA operations like the reference's
LocalMapping thread (reference: ORB-SLAM3/src/LocalMapping.cc:149-160).

The keypoint jitter comes from np.random.RandomState(seed), so both
packages draw the same keypoints. The tracker runs on the host: numpy and
CPU tensors only, never the card, so its thread never touches the mapper's
device.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np
import torch

from photo_slam_tpu_torch.mapper.mapping_ops import (KeyframeData,
                                                     MappingOperation, OprType)
from photo_slam_tpu_torch.models.camera import Camera
from photo_slam_tpu_torch.ops import depth_ops
from photo_slam_tpu_torch.utils.math import se3_inverse, se3_matrix


@dataclass
class Frame:
    image: np.ndarray                 # [3,H,W] float32
    quat_wxyz: np.ndarray             # world->camera
    trans: np.ndarray
    depth: Optional[np.ndarray] = None  # [H,W] float32 (RGBD)
    right: Optional[np.ndarray] = None  # [3,H,W] right image (stereo)
    filename: str = ""
    timestamp: Optional[float] = None  # seconds (trajectory savers)
    imu: Optional[tuple] = None       # (stamps[M], acc[M,3], gyro[M,3])
    #                                   covering the span since the previous
    #                                   frame (inertial sensors only)


class GroundTruthTracker:
    """Feed frames; emits one LocalMappingBA per keyframe."""

    def __init__(self, camera: Camera, keyframe_every: int = 10,
                 num_keypoints: int = 400, seed: int = 0,
                 min_depth: float = 1e-6, max_depth: float = 1e9):
        self.camera = camera
        self.keyframe_every = keyframe_every
        self.num_keypoints = num_keypoints
        self.rng = np.random.RandomState(seed)
        self.min_depth = min_depth
        self.max_depth = max_depth
        self._frame_idx = 0
        self._kf_count = 0
        self.done = False
        self.live_kf_ids: set[int] = set()
        self.track_times: list[float] = []  # per-frame seconds
        # (TrackingTime.txt, as the feature frontend writes it)

    def _sample_keypoints(self, frame: Frame):
        """Grid-jittered keypoint pixels + camera-local 3D where depth is
        valid (the output contract of KeyFrame::GetKeypointInfo,
        reference: ORB-SLAM3/src/KeyFrame.cc:1169-1196)."""
        cam = self.camera
        n = self.num_keypoints
        g = int(np.ceil(np.sqrt(n)))
        xs = (np.arange(g) + 0.5) * cam.width / g
        ys = (np.arange(g) + 0.5) * cam.height / g
        px, py = np.meshgrid(xs, ys)
        pix = np.stack([px.ravel(), py.ravel()], 1)[:n]
        pix += self.rng.uniform(-2, 2, pix.shape)
        pix[:, 0] = np.clip(pix[:, 0], 0, cam.width - 1)
        pix[:, 1] = np.clip(pix[:, 1], 0, cam.height - 1)

        local = np.zeros((pix.shape[0], 3), np.float32)
        if frame.depth is not None:
            u = pix[:, 0].astype(np.int64)
            v = pix[:, 1].astype(np.int64)
            d = frame.depth[v, u]
            ok = (d > self.min_depth) & (d < self.max_depth)
            pts = depth_ops.backproject_pinhole(
                torch.tensor(pix[:, 0], dtype=torch.float32),
                torch.tensor(pix[:, 1], dtype=torch.float32),
                torch.tensor(np.where(ok, d, 0.0), dtype=torch.float32),
                cam.fx, cam.fy, cam.cx, cam.cy).numpy()
            local[ok] = pts[ok]
        return pix.astype(np.float32), local

    def _sparse_points_world(self, frame: Frame, pix, local):
        """Sparse map points (world frame) + colors for increasePcd."""
        has3d = np.abs(local).sum(1) > 0
        if not has3d.any():
            return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32))
        twc = se3_inverse(se3_matrix(frame.quat_wxyz, frame.trans))
        pts_w = local[has3d] @ twc[:3, :3].T + twc[:3, 3]
        u = np.clip(pix[has3d, 0].astype(np.int64), 0, self.camera.width - 1)
        v = np.clip(pix[has3d, 1].astype(np.int64), 0, self.camera.height - 1)
        cols = frame.image[:, v, u].T
        return pts_w.astype(np.float32), cols.astype(np.float32)

    def process_frame(self, frame: Frame) -> Optional[MappingOperation]:
        """Returns a MappingOperation when this frame becomes a keyframe."""
        t0 = time.perf_counter()
        try:
            return self._process_frame(frame)
        finally:
            self.track_times.append(time.perf_counter() - t0)

    def _process_frame(self, frame: Frame) -> Optional[MappingOperation]:
        idx = self._frame_idx
        self._frame_idx += 1
        if idx % self.keyframe_every != 0:
            return None
        kfid = self._kf_count
        self._kf_count += 1
        self.live_kf_ids.add(kfid)

        pix, local = self._sample_keypoints(frame)
        pts_w, cols = self._sparse_points_world(frame, pix, local)
        kf = KeyframeData(
            kfid=kfid,
            camera_id=self.camera.camera_id,
            quat_wxyz=frame.quat_wxyz.astype(np.float64),
            trans=frame.trans.astype(np.float64),
            image=frame.image,
            aux_image=frame.depth if frame.depth is not None else frame.right,
            kps_pixel=pix,
            kps_point_local=local,
            filename=frame.filename,
        )
        return MappingOperation(kind=OprType.LOCAL_MAPPING_BA,
                                keyframes=[kf], points=pts_w, colors=cols)

    def run(self, frames: Iterator[Frame], push) -> None:
        """Drive a full sequence, pushing ops via `push(op)`."""
        for frame in frames:
            op = self.process_frame(frame)
            if op is not None:
                push(op)
        self.done = True
