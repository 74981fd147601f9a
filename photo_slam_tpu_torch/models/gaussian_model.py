"""Gaussian map state with padded capacity and a live mask.

Counterpart of photo_slam_tpu/models/gaussian_model.py (reference:
include/gaussian_model.h:59-193). The map is a NamedTuple of fixed-capacity
tensors plus a `live` mask, in the JAX package's parameter layout (so PLY
round trips are byte-compatible):
  xyz            [C, 3]
  features_dc    [C, 1, 3]
  features_rest  [C, (deg+1)^2 - 1, 3]
  log_scales     [C, 3]   (exp activation)
  quats          [C, 4]   (w,x,y,z; normalize activation)
  opacity_logit  [C, 1]   (sigmoid activation)
plus the densification statistics. Insert, growth and densify come with the
training slice.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from photo_slam_tpu_torch.ops.knn import scale_init_from_points
from photo_slam_tpu_torch.ops.sh import rgb_to_sh
from photo_slam_tpu_torch.utils.math import inverse_sigmoid


class GaussianParams(NamedTuple):
    """The 6 optimizable parameter groups (order mirrors the reference's
    Adam param_groups, src/gaussian_model.cpp:477-510)."""

    xyz: torch.Tensor
    features_dc: torch.Tensor
    features_rest: torch.Tensor
    opacity_logit: torch.Tensor
    log_scales: torch.Tensor
    quats: torch.Tensor


class GaussianState(NamedTuple):
    """Full map state = parameters + live mask + densification stats."""

    params: GaussianParams
    live: torch.Tensor              # [C] bool
    max_radii2d: torch.Tensor       # [C] float32
    xyz_grad_accum: torch.Tensor    # [C] float32
    denom: torch.Tensor             # [C] float32
    exist_since_iter: torch.Tensor  # [C] int32

    @property
    def capacity(self) -> int:
        return self.live.shape[0]


def activated(params: GaussianParams):
    """(scales, unit quats, opacities[N]): the activations the renderer
    consumes (reference: src/gaussian_model.cpp:48-71)."""
    scales = torch.exp(params.log_scales)
    quats = params.quats / torch.linalg.norm(params.quats, dim=-1,
                                             keepdim=True)
    opacities = torch.sigmoid(params.opacity_logit[:, 0])
    return scales, quats, opacities


def sh_features(params: GaussianParams) -> torch.Tensor:
    """[C, K, 3] concatenated DC + rest coefficients."""
    return torch.cat([params.features_dc, params.features_rest], dim=1)


def round_capacity(n: int, minimum: int = 4096) -> int:
    """Bucketed capacity: next power of two."""
    return max(minimum, 1 << max(0, math.ceil(math.log2(max(n, 1)))))


def empty_state(capacity: int, sh_degree: int = 3, *,
                device) -> GaussianState:
    k_rest = (sh_degree + 1) ** 2 - 1
    f32 = dict(dtype=torch.float32, device=device)
    quats = torch.zeros((capacity, 4), **f32)
    quats[:, 0] = 1.0
    params = GaussianParams(
        xyz=torch.zeros((capacity, 3), **f32),
        features_dc=torch.zeros((capacity, 1, 3), **f32),
        features_rest=torch.zeros((capacity, k_rest, 3), **f32),
        opacity_logit=torch.full((capacity, 1), -10.0, **f32),
        log_scales=torch.full((capacity, 3), -10.0, **f32),
        quats=quats,
    )
    return GaussianState(
        params=params,
        live=torch.zeros(capacity, dtype=torch.bool, device=device),
        max_radii2d=torch.zeros(capacity, **f32),
        xyz_grad_accum=torch.zeros(capacity, **f32),
        denom=torch.zeros(capacity, **f32),
        exist_since_iter=torch.zeros(capacity, dtype=torch.int32,
                                     device=device),
    )


def create_from_pcd(points: np.ndarray, colors: np.ndarray,
                    sh_degree: int = 3, capacity: int | None = None, *,
                    device) -> GaussianState:
    """Initialize the map on `device` from a colored point cloud
    (reference: src/gaussian_model.cpp:114-191): DC SH from RGB, log-sqrt
    3NN scale init, identity quats, opacity 0.1."""
    n = points.shape[0]
    cap = capacity or round_capacity(n * 2)
    state = empty_state(cap, sh_degree, device=device)
    p = state.params

    pts = torch.as_tensor(points, dtype=torch.float32, device=device)
    p.xyz[:n] = pts
    p.features_dc[:n, 0] = rgb_to_sh(
        torch.as_tensor(colors, dtype=torch.float32, device=device))
    p.opacity_logit[:n] = inverse_sigmoid(
        torch.full((n, 1), 0.1, dtype=torch.float32, device=device))
    p.log_scales[:n] = scale_init_from_points(pts)
    state.live[:n] = True
    return state


def state_from_numpy(params: dict[str, np.ndarray], live: np.ndarray, *,
                     device) -> GaussianState:
    """Carry a map across from numpy arrays: the six parameter arrays under
    their GaussianParams names (xyz, features_dc, features_rest,
    opacity_logit, log_scales, quats, e.g. a JAX state's arrays) and the live
    mask. Densification statistics start at zero."""
    missing = set(GaussianParams._fields) - set(params)
    if missing:
        raise KeyError(f"missing parameter arrays: {sorted(missing)}")
    # np.array copies: the state never aliases the caller's arrays.
    gp = GaussianParams(**{
        k: torch.from_numpy(np.array(params[k], np.float32)).to(device)
        for k in GaussianParams._fields})
    cap = gp.xyz.shape[0]
    zeros = torch.zeros(cap, dtype=torch.float32, device=device)
    return GaussianState(
        params=gp,
        live=torch.from_numpy(np.array(live, bool)).to(device),
        max_radii2d=zeros,
        xyz_grad_accum=zeros.clone(),
        denom=zeros.clone(),
        exist_since_iter=torch.zeros(cap, dtype=torch.int32, device=device),
    )
