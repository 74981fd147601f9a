"""Point-cloud transform ops used by loop closure and scale refinement.

Counterpart of photo_slam_tpu/ops/point_ops.py (reference:
src/operate_points.cu:38-143, cuda_rasterizer/operate_points.h:42-200):
rigid and similarity transforms of means, quaternion rotation composition
and frustum visibility marking, as plain PyTorch on the device of the
tensors given. All are O(N) elementwise work; the JAX package has no
kernel for them either.

The reference's device-side matrix->quaternion conversion writes one
quaternion component to the wrong index (operate_points.h:192-200 stores
slot +2 twice and never +3); this uses the correct conversion
(utils/math.rotmat_to_quat), as the JAX package does.
"""
from __future__ import annotations

import torch

from photo_slam_tpu_torch.ops.camera_math import transform_points_43
from photo_slam_tpu_torch.ops.preprocess import NEAR_CULL_Z
from photo_slam_tpu_torch.utils.math import quat_multiply, rotmat_to_quat


def mark_visible(points: torch.Tensor, viewmatrix: torch.Tensor,
                 projmatrix: torch.Tensor) -> torch.Tensor:
    """Frustum visibility: view-space z beyond the near cull plane
    (reference: cuda_rasterizer/rasterizer_impl.cu:54-66 + auxiliary.h
    in_frustum, whose screen-bounds test is disabled there too)."""
    del projmatrix  # kept for signature parity; the z test is sufficient
    return transform_points_43(points, viewmatrix)[..., 2] > NEAR_CULL_Z


def transform_points(points: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Rigid transform of [N,3] points by a 4x4 matrix
    (reference: src/operate_points.cu transform_points)."""
    return transform_points_43(points, T)


def scale_and_transform_points(points: torch.Tensor, quats: torch.Tensor,
                               T: torch.Tensor, mask: torch.Tensor,
                               scale) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked similarity transform of means + rotation composition
    (reference: cuda_rasterizer/operate_points.h:100-180):
    p' = R_T (s * p) + t_T where mask; q' = quat(R_T) * q (Hamilton)."""
    new_pts = transform_points_43(points * scale, T)
    q_t = rotmat_to_quat(T[:3, :3])
    new_quats = quat_multiply(q_t.expand(quats.shape), quats)
    m = mask[:, None]
    return torch.where(m, new_pts, points), torch.where(m, new_quats, quats)


def scale_and_transform_then_mark_visible(
        points: torch.Tensor, quats: torch.Tensor,
        not_transformed: torch.Tensor, unstable: torch.Tensor,
        T: torch.Tensor, viewmatrix: torch.Tensor, projmatrix: torch.Tensor,
        scale):
    """Both steps in one (reference: src/operate_points.cu:95-143): mask =
    visible in the keyframe AND not yet transformed AND unstable; apply the
    similarity transform there and clear their not_transformed flag.

    Returns (points, quats, not_transformed, num_transformed), the count a
    0-d int32 tensor on the device."""
    visible = mark_visible(points, viewmatrix, projmatrix)
    final_mask = not_transformed & unstable & visible
    pts, qs = scale_and_transform_points(points, quats, T, final_mask, scale)
    return (pts, qs, not_transformed & ~final_mask,
            final_mask.sum(dtype=torch.int32))
