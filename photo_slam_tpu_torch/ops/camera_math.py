"""Camera transform math: world-to-view, perspective projection, NDC<->pixels.

Counterpart of photo_slam_tpu/ops/camera_math.py. Matrices are built on the
host in numpy (float64 math, float32 results) exactly as there; the per-point
transforms are PyTorch. Natural convention: points transform as column
vectors, ``p' = M @ [p, 1]``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def world_to_view(R: np.ndarray, t: np.ndarray, trans=(0.0, 0.0, 0.0),
                  scale: float = 1.0) -> np.ndarray:
    """4x4 world->camera transform with optional camera-center shift/scale
    (reference: src/gaussian_keyframe.cpp:154-174); defaults are identity."""
    Rt = np.eye(4, dtype=np.float64)
    Rt[:3, :3] = R
    Rt[:3, 3] = t
    if scale == 1.0 and not np.any(np.asarray(trans)):
        return Rt.astype(np.float32)
    C2W = np.linalg.inv(Rt)
    cam_center = (C2W[:3, 3] + np.asarray(trans, dtype=np.float64)) * scale
    C2W[:3, 3] = cam_center
    return np.linalg.inv(C2W).astype(np.float32)


def projection_matrix(znear: float, zfar: float, fovx: float,
                      fovy: float) -> np.ndarray:
    """OpenGL-style perspective projection with w' = z_view
    (reference: src/gaussian_keyframe.cpp:176-204)."""
    tan_half_fovy = np.tan(fovy / 2.0)
    tan_half_fovx = np.tan(fovx / 2.0)
    top = tan_half_fovy * znear
    right = tan_half_fovx * znear
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


class CameraMatrices(NamedTuple):
    """Per-view transform bundle consumed by the renderer (float32 tensors):
      viewmatrix:  [4,4] world->camera
      full_proj:   [4,4] projection @ viewmatrix
      cam_center:  [3] camera center in world coordinates
    """

    viewmatrix: torch.Tensor
    full_proj: torch.Tensor
    cam_center: torch.Tensor


def build_camera_matrices(R: np.ndarray, t: np.ndarray, znear: float,
                          zfar: float, fovx: float, fovy: float,
                          trans=(0.0, 0.0, 0.0), scale: float = 1.0, *,
                          device) -> CameraMatrices:
    """Compute the transform bundle like computeTransformTensors
    (reference: src/gaussian_keyframe.cpp:118-152), on `device`."""
    w2v = world_to_view(R, t, trans, scale)
    proj = projection_matrix(znear, zfar, fovx, fovy)
    full = (proj.astype(np.float64) @ w2v.astype(np.float64)).astype(np.float32)
    cam_center = np.linalg.inv(w2v.astype(np.float64))[:3, 3].astype(np.float32)
    return CameraMatrices(
        viewmatrix=torch.from_numpy(w2v).to(device),
        full_proj=torch.from_numpy(full).to(device),
        cam_center=torch.from_numpy(cam_center).to(device),
    )


def ndc_to_pixel(v: torch.Tensor, size: int) -> torch.Tensor:
    """NDC [-1,1] -> continuous pixel coordinate
    (reference: cuda_rasterizer/auxiliary.h:41-44)."""
    return ((v + 1.0) * size - 1.0) * 0.5


def transform_points_44(points: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """[N,3] points through a 4x4 matrix -> homogeneous [N,4]."""
    out = points @ M[:3, :3].T + M[:3, 3]
    w = points @ M[3, :3] + M[3, 3]
    return torch.cat([out, w[:, None]], dim=-1)


def transform_points_43(points: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """[N,3] points through the affine part of a 4x4 matrix -> [N,3]."""
    return points @ M[:3, :3].T + M[:3, 3]
