"""Map-level similarity transforms: loop closure + scale refinement.

Counterpart of photo_slam_tpu/models/transforms.py (reference:
src/gaussian_model.cpp:379-475). The JAX functions donate the state; these
write the map parameters and the Adam moments in place, as the port's Adam
step does, and return them. Every scalar may be a 0-d tensor, as JAX
traces it: mapper/trainer.StepGraphs passes them so, and replays both
functions from captured graphs on the resident map.
"""
from __future__ import annotations

import torch

from photo_slam_tpu_torch.models.gaussian_model import GaussianState
from photo_slam_tpu_torch.models.optimizer import AdamState
from photo_slam_tpu_torch.ops.camera_math import transform_points_43
from photo_slam_tpu_torch.ops.point_ops import (
    scale_and_transform_then_mark_visible)
from photo_slam_tpu_torch.utils.math import quat_multiply, rotmat_to_quat


def _zero_moments(opt_state: AdamState, mask: torch.Tensor,
                  groups: tuple[int, ...]) -> None:
    """Zero, in place, the Adam moments of `groups` at the rows of mask."""
    for gi in groups:
        for x in (opt_state.m[gi], opt_state.v[gi]):
            x.masked_fill_(mask.reshape((-1,) + (1,) * (x.dim() - 1)), 0.0)


@torch.no_grad()
def apply_scaled_transformation(state: GaussianState, opt_state: AdamState,
                                T: torch.Tensor, s):
    """Whole-map similarity transform: xyz <- T @ (s * xyz), rotations
    composed with T's rotation, log-scales += log s, on the live rows; the
    xyz, log_scales and quats moments zeroed there (reference:
    src/gaussian_model.cpp:379-414 applyScaledTransformation +
    scaledTransformationPostfix).

    As in the JAX package, sizes scale geometrically (the reference
    multiplies the raw log-scales by s) and rotations compose with T (the
    reference leaves them), so the map renders identically from the
    transformed keyframes. `s` a float or a 0-d float32 tensor. Returns
    (state, opt_state), updated in place."""
    p = state.params
    live = state.live[:, None]
    new_xyz = transform_points_43(p.xyz * s, T)
    q_t = rotmat_to_quat(T[:3, :3])
    new_quats = quat_multiply(q_t.expand(p.quats.shape), p.quats)
    log_s = torch.log(torch.as_tensor(s, dtype=torch.float32,
                                      device=p.xyz.device))
    p.xyz.copy_(torch.where(live, new_xyz, p.xyz))
    p.quats.copy_(torch.where(live, new_quats, p.quats))
    p.log_scales.copy_(torch.where(live, p.log_scales + log_s, p.log_scales))
    _zero_moments(opt_state, state.live, (0, 4, 5))
    return state, opt_state


@torch.no_grad()
def scaled_transform_visible_points_of_keyframe(
        state: GaussianState, opt_state: AdamState,
        not_transformed: torch.Tensor, diff_pose: torch.Tensor,
        kf_viewmatrix: torch.Tensor, kf_full_proj: torch.Tensor,
        kf_creation_iter, stable_num_iter, scale):
    """Loop-closure correction of one keyframe's visible, unstable points
    (reference: src/gaussian_model.cpp:416-475): unstable =
    |exist_since_iter - kf_creation_iter| < stable_num_iter; the similarity
    `diff_pose` (with scale) moves the visible unstable points not moved
    yet, whose xyz and rotation moments are zeroed. Quaternions are
    normalized on the way, as in the reference. kf_creation_iter and
    stable_num_iter are ints or 0-d int32 tensors, scale a float or a 0-d
    float32 tensor.

    Returns (state, opt_state, not_transformed, num_transformed), the map
    and the moments updated in place."""
    p = state.params
    unstable = (state.exist_since_iter - kf_creation_iter).abs() < (
        stable_num_iter)
    quats_act = p.quats / torch.linalg.norm(p.quats, dim=-1, keepdim=True)
    pts, qs, new_not_transformed, num = scale_and_transform_then_mark_visible(
        p.xyz, quats_act, not_transformed & state.live, unstable, diff_pose,
        kf_viewmatrix, kf_full_proj, scale)
    p.xyz.copy_(pts)
    p.quats.copy_(qs)
    _zero_moments(opt_state, not_transformed & ~new_not_transformed, (0, 5))
    return state, opt_state, new_not_transformed, num
