"""Scene: cameras + keyframes + scene-extent estimation.

Counterpart of photo_slam_tpu/models/scene.py (reference:
include/gaussian_scene.h:36-79, src/gaussian_scene.cpp). The trainer owns
the scene; nothing here locks.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from photo_slam_tpu_torch.models.camera import Camera
from photo_slam_tpu_torch.models.keyframe import Keyframe


@dataclass
class Scene:
    cameras: dict[int, Camera] = field(default_factory=dict)
    keyframes: dict[int, Keyframe] = field(default_factory=dict)
    cameras_extent: float = 1.0

    def add_camera(self, cam: Camera) -> None:
        self.cameras[cam.camera_id] = cam

    def add_keyframe(self, kf: Keyframe) -> None:
        self.keyframes[kf.fid] = kf

    def compute_nerfpp_norm(self) -> float:
        """cameras_extent = 1.1 * max distance of any camera center from the
        mean center (reference: src/gaussian_scene.cpp:120-151 getNerfppNorm).
        """
        centers = []
        for kf in self.keyframes.values():
            if kf.matrices is not None:
                centers.append(kf.matrices.cam_center.detach().cpu().numpy())
        if not centers:
            self.cameras_extent = 1.0
            return self.cameras_extent
        c = np.stack(centers)
        mean = c.mean(axis=0)
        diag = np.linalg.norm(c - mean, axis=1).max()
        self.cameras_extent = float(diag * 1.1)
        if self.cameras_extent <= 0:
            self.cameras_extent = 1.0
        return self.cameras_extent
