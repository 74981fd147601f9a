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
plus the densification statistics. Inserts write into dead slots
(insert_points, dropping what does not fit); grow_capacity re-buckets on
the host. Densify lives in models/densify.py.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from photo_slam_tpu_torch.ops.knn import scale_init_from_points
from photo_slam_tpu_torch.ops.sh import rgb_to_sh
from photo_slam_tpu_torch.utils import ply
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


def num_live(state: GaussianState) -> torch.Tensor:
    return state.live.sum(dtype=torch.int32)


def clone_state(state: GaussianState) -> GaussianState:
    """A copy of every tensor of the state (Adam writes a map in place)."""
    return GaussianState(GaussianParams(*(x.clone() for x in state.params)),
                         *(x.clone() for x in state[1:]))


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


def state_from_ply(path, min_capacity: int, *,
                   device) -> tuple[GaussianState, int]:
    """Load a 3DGS checkpoint into a map on `device` as the JAX trainer's
    load_ply does (photo_slam_tpu/mapper/trainer.py:631-649): capacity
    max(min_capacity, round_capacity(n)), SH degree from the number of
    f_rest coefficients. Returns (state, sh_degree)."""
    xyz, f_dc, f_rest, opac, log_s, quats = ply.load_gaussian_ply(path)
    n = xyz.shape[0]
    cap = max(min_capacity, round_capacity(n))
    sh_deg = int(round((f_rest.shape[1] + 1) ** 0.5)) - 1
    state = empty_state(cap, sh_degree=sh_deg, device=device)
    p = state.params
    for dst, src in ((p.xyz, xyz), (p.features_dc, f_dc),
                     (p.features_rest, f_rest), (p.opacity_logit, opac),
                     (p.log_scales, log_s), (p.quats, quats)):
        dst[:n] = torch.from_numpy(src).to(device)
    state.live[:n] = True
    return state, sh_deg


def scatter_rows(arr: torch.Tensor, dst: torch.Tensor,
                 vals: torch.Tensor) -> torch.Tensor:
    """arr with rows dst <- vals, where dst == len(arr) drops the row (the
    JAX package's .at[dst].set(vals, mode="drop")): dropped rows land in a
    scratch row past the end, so no index reads back to the host."""
    ext = torch.cat([arr, arr[:1]])
    ext[dst.long()] = vals.to(arr.dtype)
    return ext[:arr.shape[0]]


def insert_points(state: GaussianState, points: torch.Tensor,
                  colors: torch.Tensor, valid_new: torch.Tensor,
                  iteration) -> tuple[GaussianState, torch.Tensor]:
    """increasePcd: write new Gaussians into dead slots
    (reference: src/gaussian_model.cpp:193-310): DC SH from RGB, scale from
    the 3-NN distance among the new points only, identity rotation, opacity
    0.1, exist_since_iter = iteration, statistics zeroed. The caller zeroes
    the optimizer moments at the returned slots.

    points/colors [M, 3] candidates on the state's device, valid_new [M]
    bool. Returns (new state, dst [M] int32 slot or -1 where the candidate
    is invalid or beyond the free capacity). The k-th valid candidate takes
    the k-th dead slot. No host synchronization."""
    m = points.shape[0]
    cap = state.capacity
    dev = state.live.device
    log_s = scale_init_from_points(points, valid_new)
    dc = rgb_to_sh(colors)

    dead_order = torch.argsort(state.live.to(torch.int32), stable=True)
    cand_rank = torch.cumsum(valid_new.to(torch.int32), 0) - 1
    num_dead = (~state.live).sum(dtype=torch.int32)
    can_place = valid_new & (cand_rank < num_dead)
    dst = torch.where(can_place, dead_order[cand_rank.clamp(0, cap - 1)],
                      -1).to(torch.int32)
    dst_safe = torch.where(dst >= 0, dst, cap)

    def scatter(arr, vals):
        return scatter_rows(arr, dst_safe, vals)

    p = state.params
    quats = torch.zeros((m, 4), dtype=torch.float32, device=dev)
    quats[:, 0] = 1.0
    params = GaussianParams(
        xyz=scatter(p.xyz, points),
        features_dc=scatter(p.features_dc, dc[:, None, :]),
        features_rest=scatter(p.features_rest, torch.zeros(
            (m,) + tuple(p.features_rest.shape[1:]), device=dev)),
        opacity_logit=scatter(p.opacity_logit, torch.full(
            (m, 1), float(np.log(0.1 / 0.9)), device=dev)),
        log_scales=scatter(p.log_scales, log_s),
        quats=scatter(p.quats, quats),
    )
    zeros_m = torch.zeros(m, dtype=torch.float32, device=dev)
    iters = torch.as_tensor(iteration, dtype=torch.int32,
                            device=dev).expand(m)
    new_state = state._replace(
        params=params,
        live=scatter(state.live, torch.ones(m, dtype=torch.bool,
                                            device=dev)),
        exist_since_iter=scatter(state.exist_since_iter, iters),
        max_radii2d=scatter(state.max_radii2d, zeros_m),
        xyz_grad_accum=scatter(state.xyz_grad_accum, zeros_m),
        denom=scatter(state.denom, zeros_m),
    )
    return new_state, dst


def grow_capacity(state: GaussianState, new_capacity: int) -> GaussianState:
    """Re-bucket: pad every array to `new_capacity`; new slots are dead,
    with identity quats and -10 opacity and scale logits."""
    cap = state.capacity
    if new_capacity < cap:
        raise ValueError(f"grow_capacity: {new_capacity} < capacity {cap}")
    extra = new_capacity - cap
    if extra == 0:
        return state

    def pad(x, value=0):
        tail = torch.full((extra,) + tuple(x.shape[1:]), value,
                          dtype=x.dtype, device=x.device)
        return torch.cat([x, tail])

    p = state.params
    quats = pad(p.quats)
    quats[cap:, 0] = 1.0
    params = GaussianParams(
        xyz=pad(p.xyz), features_dc=pad(p.features_dc),
        features_rest=pad(p.features_rest),
        opacity_logit=pad(p.opacity_logit, -10.0),
        log_scales=pad(p.log_scales, -10.0), quats=quats)
    return GaussianState(
        params=params,
        live=pad(state.live, False),
        max_radii2d=pad(state.max_radii2d),
        xyz_grad_accum=pad(state.xyz_grad_accum),
        denom=pad(state.denom),
        exist_since_iter=pad(state.exist_since_iter),
    )


def state_from_numpy(params: dict[str, np.ndarray], live: np.ndarray, *,
                     device, max_radii2d=None, xyz_grad_accum=None,
                     denom=None, exist_since_iter=None) -> GaussianState:
    """Carry a map across from numpy arrays: the six parameter arrays under
    their GaussianParams names (xyz, features_dc, features_rest,
    opacity_logit, log_scales, quats, e.g. a JAX state's arrays), the live
    mask and, optionally, the densification statistics (zero where not
    given)."""
    missing = set(GaussianParams._fields) - set(params)
    if missing:
        raise KeyError(f"missing parameter arrays: {sorted(missing)}")
    # np.array copies: the state never aliases the caller's arrays.
    gp = GaussianParams(**{
        k: torch.from_numpy(np.array(params[k], np.float32)).to(device)
        for k in GaussianParams._fields})
    cap = gp.xyz.shape[0]
    given = dict(max_radii2d=max_radii2d, xyz_grad_accum=xyz_grad_accum,
                 denom=denom, exist_since_iter=exist_since_iter)
    stats = {}
    for name, arr in given.items():
        dtype = np.int32 if name == "exist_since_iter" else np.float32
        if arr is None:
            arr = np.zeros(cap, dtype)
        stats[name] = torch.from_numpy(np.array(arr, dtype)).to(device)
    return GaussianState(
        params=gp, live=torch.from_numpy(np.array(live, bool)).to(device),
        **stats)
