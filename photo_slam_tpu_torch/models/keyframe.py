"""Keyframe: pose + camera + ground-truth image (+ pyramid).

Counterpart of photo_slam_tpu/models/keyframe.py (reference:
include/gaussian_keyframe.h:36-135, src/gaussian_keyframe.cpp). The image
and pyramid are host numpy arrays; the transform tensors are built once by
set_pose with ops/camera_math.build_camera_matrices on the device it is
given (natural convention; the reference stores transposed versions of the
same matrices). The keypoints, the auxiliary image and the scheduling
and loop-closure bookkeeping serve the online mapper (mapper/mapper.py).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

import torch

from photo_slam_tpu_torch.models.camera import Camera, build_pyramid
from photo_slam_tpu_torch.ops.camera_math import (CameraMatrices,
                                                  build_camera_matrices)
from photo_slam_tpu_torch.utils.math import quat_to_rotmat


@dataclass
class Keyframe:
    fid: int
    camera: Camera
    znear: float = 0.01
    zfar: float = 100.0

    # Pose: world->camera quaternion (w,x,y,z) + translation.
    quat: Optional[np.ndarray] = None
    trans: Optional[np.ndarray] = None
    matrices: Optional[CameraMatrices] = None

    # Ground-truth image (CHW float32 [0,1], undistorted) + sub-level pyramid.
    image: Optional[np.ndarray] = None
    pyramid: list[np.ndarray] = field(default_factory=list)

    # Keypoints: undistorted pixel coords [K,2] and camera-local 3D [K,3]
    # (0-filled where no matched map point — reference
    # ORB-SLAM3/src/KeyFrame.cc:1169-1196 GetKeypointInfo).
    kps_pixel: Optional[np.ndarray] = None
    kps_point_local: Optional[np.ndarray] = None
    img_filename: str = ""
    img_aux: Optional[np.ndarray] = None  # right image (stereo) / depth (RGBD)

    # Scheduling state (reference: remaining_times_of_use_,
    # gaus_pyramid_times_of_use_).
    remaining_times_of_use: int = 0
    pyramid_times_of_use: list[int] = field(default_factory=list)
    done_inactive_geo_densify: bool = False
    creation_iter: int = 0
    set_this_time: bool = True  # loop-closure bookkeeping

    def set_pose(self, quat_wxyz, t, *, device) -> None:
        """Normalize + store pose, rebuild the transform bundle on `device`
        (reference: src/gaussian_keyframe.cpp:21-55, 119-152). The rotation
        is computed in float32, as the JAX package computes it."""
        q = np.asarray(quat_wxyz, np.float64)
        q = q / np.linalg.norm(q)
        self.quat = q
        self.trans = np.asarray(t, np.float64)
        R = quat_to_rotmat(torch.tensor(q, dtype=torch.float32)).numpy()
        self.matrices = build_camera_matrices(
            R, self.trans, self.znear, self.zfar,
            self.camera.fovx, self.camera.fovy, device=device)

    def set_image(self, img_chw: np.ndarray, num_sub_levels: int = 0,
                  sub_level_times_of_use: int = 0) -> None:
        self.image = img_chw.astype(np.float32)
        if num_sub_levels > 0:
            hwc = np.transpose(img_chw, (1, 2, 0))
            self.pyramid = [
                np.transpose(p, (2, 0, 1))
                for p in build_pyramid(hwc, num_sub_levels)
            ]
            self.pyramid_times_of_use = [sub_level_times_of_use] * num_sub_levels

    def current_pyramid_level(self) -> int:
        """Coarse-to-fine level scheduler: spend each sub level's budget
        before moving up; full resolution afterwards
        (reference: src/gaussian_keyframe.cpp:206-216)."""
        for i, n in enumerate(self.pyramid_times_of_use):
            if n > 0:
                self.pyramid_times_of_use[i] -= 1
                return i
        return len(self.pyramid)

    def level_image(self, level: int) -> np.ndarray:
        if level >= len(self.pyramid):
            return self.image
        return self.pyramid[level]

    @property
    def image_width(self) -> int:
        return self.camera.width

    @property
    def image_height(self) -> int:
        return self.camera.height
