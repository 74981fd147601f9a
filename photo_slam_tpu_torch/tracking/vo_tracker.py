"""Feature-based visual-odometry tracker (ORB + PnP), RGBD/stereo.

A real tracking frontend implementing the MappingOperation protocol — the
role of the reference's ORB-SLAM3 Tracking thread (reference layer L5,
SURVEY.md §2.4: ORB extraction -> pose tracking -> keyframe decision ->
LocalMappingBA push). This is deliberately the lightweight core of that
pipeline (no covisibility-graph local BA, no DBoW2 loop detection yet):

  * ORB keypoints + descriptors per frame;
  * 3D-2D tracking: match against the last keyframe's descriptors whose
    keypoints have depth, solvePnPRansac for the world->camera pose;
  * keyframe decision on tracked-inlier ratio / translation / rotation
    thresholds (Tracking::NeedNewKeyFrame's criteria in spirit);
  * on keyframe: sample map points from depth at feature pixels, push a
    LocalMappingBA MappingOperation with pose+image+keypoints+sparse points
    (exactly what ORB-SLAM3's hooks provide the reference mapper:
    KeyFrame::GetKeypointInfo + MapPoint colors, SURVEY.md §2.4).

Depth comes from the RGBD sensor directly or from stereo SGM disparity.

Counterpart of photo_slam_tpu/tracking/vo_tracker.py: ORB and PnP come
from the port's tracking/vision.py (ORB in torch on `device`), OpenCV's
brute-force Hamming matcher becomes hamming_matrix and an argsort, and
OpenCV's SGBM the port's SGM on `device` (ops/stereo.py).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

import torch

from photo_slam_tpu_torch.mapper.mapping_ops import (KeyframeData,
                                                     MappingOperation, OprType)
from photo_slam_tpu_torch.models.camera import Camera
from photo_slam_tpu_torch.native import pose_optimize
from photo_slam_tpu_torch.ops import stereo
from photo_slam_tpu_torch.tracking import vision
from photo_slam_tpu_torch.tracking.frontend import hamming_matrix
from photo_slam_tpu_torch.tracking.gt_tracker import Frame
from photo_slam_tpu_torch.utils.math import (rotmat_to_quat_numpy,
                                             se3_inverse, se3_matrix)


@dataclass
class TrackState:
    """Last-keyframe reference data for 3D-2D tracking."""

    descriptors: np.ndarray
    keypoints_px: np.ndarray      # [K,2]
    points_world: np.ndarray      # [K,3]
    has_depth: np.ndarray         # [K]
    tcw: np.ndarray               # 4x4


@dataclass
class TrackResult:
    tcw: Optional[np.ndarray]
    num_inliers: int
    is_keyframe: bool
    lost: bool = False


class OrbVoTracker:
    def __init__(self, camera: Camera, num_features: int = 1500,
                 min_inliers: int = 30, kf_min_inlier_ratio: float = 0.5,
                 kf_max_translation: float = 0.25,
                 kf_max_rotation_deg: float = 15.0,
                 kf_min_interval: int = 5,
                 min_depth: float = 0.05, max_depth: float = 40.0,
                 stereo_bf: float = 0.0, *, device):
        self.camera = camera
        self.num_features = num_features
        self.device = torch.device(device)
        self.min_inliers = min_inliers
        self.kf_min_inlier_ratio = kf_min_inlier_ratio
        self.kf_max_translation = kf_max_translation
        self.kf_max_rotation = np.deg2rad(kf_max_rotation_deg)
        self.kf_min_interval = kf_min_interval
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.stereo_bf = stereo_bf or camera.stereo_bf

        self.ref: Optional[TrackState] = None
        self.tcw = np.eye(4)
        self.trajectory: list[np.ndarray] = []  # per-frame Tcw
        self.frames_since_kf = 0
        self._frame_idx = 0
        self._kf_count = 0
        self.done = False
        self.live_kf_ids: set[int] = set()
        self.K = np.array([[camera.fx, 0, camera.cx],
                           [0, camera.fy, camera.cy],
                           [0, 0, 1]], np.float64)

    # ------------------------------------------------------------------

    @staticmethod
    def _to_gray(img_chw: np.ndarray) -> np.ndarray:
        u8 = (np.clip(np.transpose(img_chw, (1, 2, 0)), 0, 1) * 255).astype(
            np.uint8)
        return vision.rgb_to_gray(u8)

    def _depth_of(self, frame: Frame) -> Optional[np.ndarray]:
        if frame.depth is not None:
            return frame.depth
        if frame.right is not None and self.stereo_bf > 0:
            disp = stereo.disparity(frame.image, frame.right, self.device)
            with np.errstate(divide="ignore"):
                depth = np.where(disp > 1.0, self.stereo_bf / disp, 0.0)
            return depth.astype(np.float32)
        return None

    def _extract(self, frame: Frame):
        f = vision.orb_detect_and_compute(self._to_gray(frame.image),
                                          self.num_features, self.device)
        return f.px, f.desc

    def _backproject_world(self, px, depth_map, tcw):
        cam = self.camera
        u = np.clip(px[:, 0].astype(np.int64), 0, cam.width - 1)
        v = np.clip(px[:, 1].astype(np.int64), 0, cam.height - 1)
        d = depth_map[v, u]
        ok = (d > self.min_depth) & (d < self.max_depth)
        x = (px[:, 0] - cam.cx) * d / cam.fx
        y = (px[:, 1] - cam.cy) * d / cam.fy
        pts_cam = np.stack([x, y, d], 1)
        twc = se3_inverse(tcw)
        pts_w = pts_cam @ twc[:3, :3].T + twc[:3, 3]
        return pts_w.astype(np.float32), ok

    def _make_ref(self, px, desc, depth_map, tcw) -> TrackState:
        pts_w, ok = self._backproject_world(px, depth_map, tcw)
        return TrackState(descriptors=desc, keypoints_px=px,
                          points_world=pts_w, has_depth=ok, tcw=tcw.copy())

    # ------------------------------------------------------------------

    def track(self, frame: Frame) -> TrackResult:
        """Estimate this frame's pose against the last keyframe."""
        px, desc = self._extract(frame)
        depth_map = self._depth_of(frame)

        if self.ref is None:
            # First frame initializes the map at the given (or identity) pose.
            self.tcw = np.eye(4)
            if frame.quat_wxyz is not None:
                self.tcw = se3_matrix(frame.quat_wxyz, frame.trans)
            if depth_map is None:
                return TrackResult(None, 0, False, lost=True)
            self.ref = self._make_ref(px, desc, depth_map, self.tcw)
            self.trajectory.append(self.tcw.copy())
            return TrackResult(self.tcw, len(px), True)

        if desc.shape[0] < 10:
            self.trajectory.append(self.tcw.copy())
            return TrackResult(None, 0, False, lost=True)

        # Match current descriptors to the reference keyframe's (with depth).
        ref_ok = self.ref.has_depth
        ref_desc = self.ref.descriptors[ref_ok]
        ref_pts = self.ref.points_world[ref_ok]
        if ref_desc.shape[0] < 10:
            self.trajectory.append(self.tcw.copy())
            return TrackResult(None, 0, False, lost=True)
        # Two nearest reference descriptors per current one, Lowe's ratio.
        d = hamming_matrix(desc, ref_desc)
        nn = np.argsort(d, axis=1, kind="stable")[:, :2]
        best = d[np.arange(len(d)), nn[:, 0]]
        good = best < 0.75 * d[np.arange(len(d)), nn[:, 1]]
        query = np.nonzero(good)[0]
        if len(query) < 6:
            self.trajectory.append(self.tcw.copy())
            return TrackResult(None, len(query), False, lost=True)

        obj = ref_pts[nn[query, 0]].astype(np.float64)
        img_pts = px[query].astype(np.float64)
        ok, rvec, tvec, inliers = vision.solve_pnp_ransac(
            obj, img_pts, self.K, reproj_err=3.0, iters=100)
        n_inl = 0 if inliers is None else len(inliers)
        if not ok or n_inl < self.min_inliers:
            self.trajectory.append(self.tcw.copy())
            return TrackResult(None, n_inl, False, lost=True)

        R = vision.rodrigues(rvec)
        tcw = np.eye(4)
        tcw[:3, :3] = R
        tcw[:3, 3] = tvec.ravel()

        # Motion-only BA polish on the RANSAC inliers (the role of
        # Optimizer::PoseOptimization after initial pose estimation;
        # native C++ Gauss-Newton core).
        inl = inliers.ravel()
        _, tcw, _ = pose_optimize(obj[inl], img_pts[inl], self.camera.fx,
                                  self.camera.fy, self.camera.cx,
                                  self.camera.cy, tcw)
        self.tcw = tcw
        self.trajectory.append(tcw.copy())

        # Keyframe decision.
        self.frames_since_kf += 1
        rel = tcw @ se3_inverse(self.ref.tcw)
        trans_delta = np.linalg.norm(rel[:3, 3])
        rot_delta = np.arccos(np.clip((np.trace(rel[:3, :3]) - 1) / 2, -1, 1))
        inlier_ratio = n_inl / max(len(query), 1)
        need_kf = self.frames_since_kf >= self.kf_min_interval and (
            inlier_ratio < self.kf_min_inlier_ratio
            or trans_delta > self.kf_max_translation
            or rot_delta > self.kf_max_rotation)
        if need_kf and depth_map is not None:
            self.ref = self._make_ref(px, desc, depth_map, tcw)
            self.frames_since_kf = 0
        return TrackResult(tcw, n_inl, need_kf and depth_map is not None)

    # ------------------------------------------------------------------

    def process_frame(self, frame: Frame) -> Optional[MappingOperation]:
        """Track; on keyframe decision return a LocalMappingBA operation."""
        self._frame_idx += 1
        res = self.track(frame)
        if not res.is_keyframe or res.tcw is None:
            return None
        depth_map = self._depth_of(frame)
        kfid = self._kf_count
        self._kf_count += 1
        self.live_kf_ids.add(kfid)

        tcw = res.tcw
        quat = rotmat_to_quat_numpy(tcw[:3, :3])
        px = self.ref.keypoints_px
        ok = self.ref.has_depth
        # Camera-local 3D for keypoints with depth (GetKeypointInfo contract).
        cam = self.camera
        u = np.clip(px[:, 0].astype(np.int64), 0, cam.width - 1)
        v = np.clip(px[:, 1].astype(np.int64), 0, cam.height - 1)
        d = depth_map[v, u] if depth_map is not None else np.zeros(len(u))
        local = np.zeros((px.shape[0], 3), np.float32)
        local[ok, 0] = (px[ok, 0] - cam.cx) * d[ok] / cam.fx
        local[ok, 1] = (px[ok, 1] - cam.cy) * d[ok] / cam.fy
        local[ok, 2] = d[ok]

        pts_w = self.ref.points_world[ok]
        cols = frame.image[:, v[ok], u[ok]].T.astype(np.float32)
        return MappingOperation(
            kind=OprType.LOCAL_MAPPING_BA,
            keyframes=[KeyframeData(
                kfid=kfid, camera_id=cam.camera_id, quat_wxyz=quat,
                trans=tcw[:3, 3], image=frame.image, aux_image=frame.depth,
                kps_pixel=px, kps_point_local=local,
                filename=frame.filename)],
            points=pts_w, colors=cols)

    def run(self, frames, push) -> None:
        for frame in frames:
            op = self.process_frame(frame)
            if op is not None:
                push(op)
        self.done = True
