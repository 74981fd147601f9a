"""Adaptive density control: clone / split / prune as masked tensor ops.

Counterpart of photo_slam_tpu/models/densify.py (reference:
src/gaussian_model.cpp:716-831), at a fixed padded capacity:

  * kill = split parents + pruned Gaussians; their slots become dead;
  * candidates (clones + 2 split children per parent) are placed into dead
    slots by rank;
  * the Adam moments are zeroed at every changed slot;
  * the densification statistics reset to zero afterwards.

Decision rules as in the reference:
  clone:  |mean grad| >= tau and max(scale) <= percent_dense * extent
  split:  |mean grad| >= tau and max(scale) >  percent_dense * extent,
          children sampled from N(0, S) rotated into world, scale /= 1.6
  prune:  opacity < min_opacity, or (when max_screen_size > 0)
          screen radius > max_screen_size or max(scale) > 0.1 * extent
The split samples come in as an argument (standard normals drawn by the
caller from its torch.Generator), so no function here draws random numbers.
Nothing here reads a value back to the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from photo_slam_tpu_torch.models.gaussian_model import (GaussianParams,
                                                        GaussianState,
                                                        scatter_rows)
from photo_slam_tpu_torch.models.optimizer import (AdamState,
                                                   zero_moments_where)
from photo_slam_tpu_torch.utils.math import inverse_sigmoid, quat_to_rotmat

SPLIT_N = 2                      # children per split (densifyAndSplit N)
SPLIT_SCALE_DIV = 0.8 * SPLIT_N  # new scale = old / (0.8 * N)


class DensifyInfo(NamedTuple):
    num_cloned: torch.Tensor
    num_split: torch.Tensor
    num_pruned: torch.Tensor
    num_dropped: torch.Tensor  # candidates that did not fit in capacity


def add_densification_stats(state: GaussianState, means2d_grad: torch.Tensor,
                            visible: torch.Tensor, width: int = 2,
                            height: int = 2) -> GaussianState:
    """Accumulate ||dL/dmean2d|| for visible Gaussians
    (reference: src/gaussian_model.cpp:817-831), in the reference's
    half-viewport units: the CUDA backward scales dL/dmean2D by 0.5 W and
    0.5 H (cuda_rasterizer/backward.cu:460-465) before the densify
    threshold sees it."""
    return add_densification_stats_(
        state._replace(xyz_grad_accum=state.xyz_grad_accum.clone(),
                       denom=state.denom.clone()),
        means2d_grad, visible, width, height)


def update_max_radii(state: GaussianState, radii: torch.Tensor,
                     visible: torch.Tensor) -> GaussianState:
    """max_radii2D tracking (reference: src/gaussian_mapper.cpp:713-718)."""
    return update_max_radii_(
        state._replace(max_radii2d=state.max_radii2d.clone()), radii,
        visible)


def add_densification_stats_(state: GaussianState,
                             means2d_grad: torch.Tensor,
                             visible: torch.Tensor, width: int = 2,
                             height: int = 2) -> GaussianState:
    """add_densification_stats written IN PLACE into the state's
    xyz_grad_accum and denom (the donated buffers of the train step);
    returns the state."""
    g = torch.stack([means2d_grad[:, 0] * (0.5 * width),
                     means2d_grad[:, 1] * (0.5 * height)], dim=-1)
    norm = torch.linalg.norm(g, dim=-1)
    state.xyz_grad_accum.add_(torch.where(visible, norm, 0.0))
    state.denom.add_(visible.to(torch.float32))
    return state


def update_max_radii_(state: GaussianState, radii: torch.Tensor,
                      visible: torch.Tensor) -> GaussianState:
    """update_max_radii written IN PLACE into the state's max_radii2d;
    returns the state."""
    r = radii.to(torch.float32)
    m = state.max_radii2d
    m.copy_(torch.where(visible, torch.maximum(m, r), m))
    return state


def densify_and_prune(
    state: GaussianState,
    opt_state: AdamState,
    noise: torch.Tensor,
    grad_threshold: float,
    min_opacity: float,
    extent,
    max_screen_size: int,
    percent_dense: float,
) -> tuple[GaussianState, AdamState, DensifyInfo]:
    """One densify + prune event at fixed capacity.

    noise [2, C, 3] standard normals on the state's device: the samples of
    the first and second split child of each slot. `max_screen_size` 0
    disables the screen-size and world-size pruning (reference:
    src/gaussian_mapper.cpp:722-730)."""
    p = state.params
    cap = state.capacity
    dev = state.live.device
    live = state.live

    grads = state.xyz_grad_accum / state.denom
    grads = torch.where(torch.isnan(grads), 0.0, grads)

    scales = torch.exp(p.log_scales)
    smax = scales.amax(dim=-1)
    opac = torch.sigmoid(p.opacity_logit[:, 0])

    # Opacity and world-size prune terms also keep a parent from cloning or
    # splitting (its copies would be prunable on arrival).
    prune_soft = opac < min_opacity
    if max_screen_size:
        prune_soft = prune_soft | (smax > 0.1 * extent)
    prune_old = prune_soft
    if max_screen_size:
        # A radii-big parent stays splittable (photo_slam_tpu
        # densify.py:113-121).
        prune_old = prune_old | (state.max_radii2d > max_screen_size)
    # Non-finite Gaussians fail every comparison; cull them explicitly.
    finite = (torch.isfinite(p.xyz).all(-1)
              & torch.isfinite(p.log_scales).all(-1)
              & torch.isfinite(p.quats).all(-1)
              & torch.isfinite(p.opacity_logit).all(-1))
    prune_old = (prune_old | ~finite) & live

    hot = live & finite & ~prune_soft & (grads >= grad_threshold)
    clone = hot & (smax <= percent_dense * extent)
    split = hot & (smax > percent_dense * extent)

    # Capacity budget: each approved clone or split takes one net free slot;
    # the highest accumulated gradients go first when slots are scarce, so
    # every approved copy or child places.
    budget = (~live | prune_old).sum(dtype=torch.int32)
    want = clone | split
    order = torch.argsort(torch.where(want, -grads, float("inf")),
                          stable=True)
    inv_rank = torch.empty(cap, dtype=torch.int32, device=dev)
    inv_rank[order] = torch.arange(cap, dtype=torch.int32, device=dev)
    approved = want & (inv_rank < budget)
    clone = clone & approved
    split = split & approved

    kill = live & (split | prune_old)
    survivors = live & ~kill

    # ---- Candidates (2 per slot) ---------------------------------------
    rot = quat_to_rotmat(p.quats)  # [C, 3, 3], normalizes like build_rotation

    def make_child(samples):
        return torch.einsum("nij,nj->ni", rot, samples * scales) + p.xyz

    child_xyz_1 = make_child(noise[0])
    child_xyz_2 = make_child(noise[1])
    child_log_scales = torch.log(scales / SPLIT_SCALE_DIV)

    # Candidate A: the clone's copy, or the first split child; candidate B:
    # the second split child.
    a_valid = clone | split
    a_xyz = torch.where(split[:, None], child_xyz_1, p.xyz)
    a_log_scales = torch.where(split[:, None], child_log_scales, p.log_scales)

    cand_valid = torch.cat([a_valid, split])                       # [2C]
    src = torch.arange(cap, device=dev).repeat(2)
    cand_xyz = torch.cat([a_xyz, child_xyz_2])
    cand_log_scales = torch.cat([a_log_scales, child_log_scales])

    # ---- Compaction: valid candidates into dead slots, by rank ---------
    dead_order = torch.argsort(survivors.to(torch.int32), stable=True)
    num_dead = (~survivors).sum(dtype=torch.int32)
    cand_rank = torch.cumsum(cand_valid.to(torch.int32), 0) - 1
    can_place = cand_valid & (cand_rank < num_dead)
    num_dropped = (cand_valid & ~can_place).sum(dtype=torch.int32)
    # Candidates that do not place are dropped (dst = cap).
    dst = torch.where(can_place, dead_order[cand_rank.clamp(0, cap - 1)],
                      cap)

    def place(arr, vals):
        return scatter_rows(arr, dst, vals)

    new_params = GaussianParams(
        xyz=place(p.xyz, cand_xyz),
        features_dc=place(p.features_dc, p.features_dc[src]),
        features_rest=place(p.features_rest, p.features_rest[src]),
        opacity_logit=place(p.opacity_logit, p.opacity_logit[src]),
        log_scales=place(p.log_scales, cand_log_scales),
        quats=place(p.quats, p.quats[src]),
    )
    new_live = place(survivors, torch.ones_like(cand_valid))
    new_exist = place(state.exist_since_iter, state.exist_since_iter[src])

    # ---- Adam surgery: zero the moments at every changed slot -----------
    changed = kill | (new_live & ~survivors)
    new_opt = zero_moments_where(opt_state, changed)

    zeros = torch.zeros(cap, dtype=torch.float32, device=dev)
    new_state = GaussianState(
        params=new_params,
        live=new_live,
        max_radii2d=zeros,
        xyz_grad_accum=zeros.clone(),
        denom=zeros.clone(),
        exist_since_iter=new_exist,
    )
    info = DensifyInfo(
        num_cloned=clone.sum(dtype=torch.int32),
        num_split=split.sum(dtype=torch.int32),
        num_pruned=prune_old.sum(dtype=torch.int32),
        num_dropped=num_dropped,
    )
    return new_state, new_opt, info


def reset_opacity(state: GaussianState, opt_state: AdamState
                  ) -> tuple[GaussianState, AdamState]:
    """opacity <- min(opacity, 0.01) with the opacity group's moments reset
    (reference: src/gaussian_model.cpp:556-565 + replaceTensorToOptimizer)."""
    logit = state.params.opacity_logit
    new_logit = inverse_sigmoid(torch.clamp_max(torch.sigmoid(logit), 0.01))
    params = state.params._replace(opacity_logit=torch.where(
        state.live[:, None], new_logit, logit))
    return (state._replace(params=params),
            zero_moments_where(opt_state, state.live, group="opacity_logit"))
