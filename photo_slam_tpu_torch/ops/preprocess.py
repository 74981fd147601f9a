"""Per-Gaussian preprocessing: projection, covariance, conic, radius, color.

Counterpart of photo_slam_tpu/ops/preprocess.py (reference:
cuda_rasterizer/forward.cu:156-256), as batched PyTorch ops over the whole
padded Gaussian array. Culled or dead Gaussians are masked (radius 0), never
dropped, so every shape stays [N, ...].
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from photo_slam_tpu_torch.ops import sh as sh_ops
from photo_slam_tpu_torch.ops.camera_math import (
    ndc_to_pixel,
    transform_points_43,
    transform_points_44,
)

# Frustum near-cull threshold on view-space z
# (reference: cuda_rasterizer/auxiliary.h:154).
NEAR_CULL_Z = 0.2
# Low-pass filter added to the 2D covariance diagonal so every splat is at
# least ~1px wide (reference: cuda_rasterizer/forward.cu:110-112).
COV2D_LOWPASS = 0.3


class Preprocessed(NamedTuple):
    """Per-Gaussian screen-space quantities, all shape [N, ...]."""

    means2d: torch.Tensor        # [N, 2] pixel-space centers
    depths: torch.Tensor         # [N] view-space z
    conics: torch.Tensor         # [N, 3] inverse 2D covariance (a, b, c)
    radii: torch.Tensor          # [N] int32 screen-space radius, 0 = culled
    rgb: torch.Tensor            # [N, 3] colors (SH-evaluated or passthrough)
    visible: torch.Tensor        # [N] bool, radius > 0


def compute_cov3d(scales: torch.Tensor, quats: torch.Tensor,
                  scale_modifier: float = 1.0) -> torch.Tensor:
    """World-space 3D covariance [N, 6] (xx, xy, xz, yy, yz, zz) from
    activated scales and unit quaternions (reference:
    cuda_rasterizer/forward.cu:118-152)."""
    w, x, y, z = quats[..., 0], quats[..., 1], quats[..., 2], quats[..., 3]
    r00 = 1.0 - 2.0 * (y * y + z * z)
    r01 = 2.0 * (x * y - w * z)
    r02 = 2.0 * (x * z + w * y)
    r10 = 2.0 * (x * y + w * z)
    r11 = 1.0 - 2.0 * (x * x + z * z)
    r12 = 2.0 * (y * z - w * x)
    r20 = 2.0 * (x * z - w * y)
    r21 = 2.0 * (y * z + w * x)
    r22 = 1.0 - 2.0 * (x * x + y * y)
    s = scales * scale_modifier
    sx, sy, sz = s[..., 0], s[..., 1], s[..., 2]
    # M = R @ diag(s): columns of R scaled; Sigma = M M^T.
    m00, m01, m02 = r00 * sx, r01 * sy, r02 * sz
    m10, m11, m12 = r10 * sx, r11 * sy, r12 * sz
    m20, m21, m22 = r20 * sx, r21 * sy, r22 * sz
    c_xx = m00 * m00 + m01 * m01 + m02 * m02
    c_xy = m00 * m10 + m01 * m11 + m02 * m12
    c_xz = m00 * m20 + m01 * m21 + m02 * m22
    c_yy = m10 * m10 + m11 * m11 + m12 * m12
    c_yz = m10 * m20 + m11 * m21 + m12 * m22
    c_zz = m20 * m20 + m21 * m21 + m22 * m22
    return torch.stack([c_xx, c_xy, c_xz, c_yy, c_yz, c_zz], dim=-1)


def tight_extents(conics: torch.Tensor, opacities: torch.Tensor,
                  radii: torch.Tensor,
                  alpha_min: float = 1.0 / 255.0) -> torch.Tensor:
    """Opacity-aware per-axis half-extents [N, 2] of the visible footprint
    {d : opacity * exp(-0.5 d^T C d) >= alpha_min}: half-widths
    sqrt(2 L Sigma_xx/yy) with L = ln(opacity/alpha_min) and Sigma = C^-1,
    plus a pixel of margin, capped at the radius; 0 where the opacity is
    below the blend threshold everywhere."""
    a, b, c = conics[..., 0], conics[..., 1], conics[..., 2]
    det = torch.clamp_min(a * c - b * b, 1e-12)
    sig_xx = c / det
    sig_yy = a / det
    L = torch.log(torch.clamp_min(opacities, 1e-12) / alpha_min) * 1.001
    dead = L <= 0.0
    L = torch.clamp_min(L, 0.0)
    ext_x = torch.sqrt(2.0 * L * torch.clamp_min(sig_xx, 0.0)) + 1.0
    ext_y = torch.sqrt(2.0 * L * torch.clamp_min(sig_yy, 0.0)) + 1.0
    r = radii.to(torch.float32)
    ext = torch.stack([torch.minimum(ext_x, r), torch.minimum(ext_y, r)],
                      dim=-1)
    return torch.where(dead[..., None], 0.0, ext)


def compute_cov2d(means3d: torch.Tensor, cov3d: torch.Tensor,
                  viewmatrix: torch.Tensor, focal_x: float, focal_y: float,
                  tan_fovx: float, tan_fovy: float) -> torch.Tensor:
    """EWA-splatting 2D covariance [N, 3] = (a, b, c) of [[a,b],[b,c]]
    (reference: cuda_rasterizer/forward.cu:74-113): J R Sigma R^T J^T with the
    Jacobian taken at the point clamped to 1.3x the FoV, plus the 0.3
    low-pass on the diagonal."""
    t = transform_points_43(means3d, viewmatrix)
    tz = t[..., 2]
    limx = 1.3 * tan_fovx
    limy = 1.3 * tan_fovy
    tx = torch.clamp(t[..., 0] / tz, -limx, limx) * tz
    ty = torch.clamp(t[..., 1] / tz, -limy, limy) * tz
    inv_tz = 1.0 / tz
    inv_tz2 = inv_tz * inv_tz

    j00 = focal_x * inv_tz
    j02 = -focal_x * tx * inv_tz2
    j11 = focal_y * inv_tz
    j12 = -focal_y * ty * inv_tz2

    R = viewmatrix[:3, :3]
    # Rows of U = J @ R, shape [N, 3] each.
    u0 = j00[..., None] * R[0][None, :] + j02[..., None] * R[2][None, :]
    u1 = j11[..., None] * R[1][None, :] + j12[..., None] * R[2][None, :]

    xx, xy, xz, yy, yz, zz = (cov3d[..., i] for i in range(6))

    def sigma_apply(v):
        return torch.stack(
            [
                xx * v[..., 0] + xy * v[..., 1] + xz * v[..., 2],
                xy * v[..., 0] + yy * v[..., 1] + yz * v[..., 2],
                xz * v[..., 0] + yz * v[..., 1] + zz * v[..., 2],
            ],
            dim=-1,
        )

    s_u0 = sigma_apply(u0)
    a = (u0 * s_u0).sum(dim=-1) + COV2D_LOWPASS
    b = (u1 * s_u0).sum(dim=-1)
    c = (u1 * sigma_apply(u1)).sum(dim=-1) + COV2D_LOWPASS
    return torch.stack([a, b, c], dim=-1)


def preprocess(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    viewmatrix: torch.Tensor,
    full_proj: torch.Tensor,
    cam_center: torch.Tensor,
    width: int,
    height: int,
    tan_fovx: float,
    tan_fovy: float,
    sh_degree: int = 3,
    shs: Optional[torch.Tensor] = None,
    colors_precomp: Optional[torch.Tensor] = None,
    cov3d_precomp: Optional[torch.Tensor] = None,
    scale_modifier: float = 1.0,
    live_mask: Optional[torch.Tensor] = None,
    principal: Optional[tuple] = None,
) -> Preprocessed:
    """Batched per-Gaussian preprocess
    (reference: cuda_rasterizer/forward.cu:156-256).

    Either `shs` [N,K,3] or `colors_precomp` [N,3] must be given; cov3d is
    computed from scales/quats unless `cov3d_precomp` [N,6] is given.
    `live_mask` marks padded/dead slots; they come out with radius 0.
    `principal` (cx, cy) moves the principal point off the image center.
    """
    focal_x = width / (2.0 * tan_fovx)
    focal_y = height / (2.0 * tan_fovy)

    p_view = transform_points_43(means3d, viewmatrix)
    depths = p_view[..., 2]
    in_front = depths > NEAR_CULL_Z

    p_hom = transform_points_44(means3d, full_proj)
    p_w = 1.0 / (p_hom[..., 3] + 1e-7)
    p_proj = p_hom[..., :3] * p_w[..., None]

    cov3d = cov3d_precomp if cov3d_precomp is not None else compute_cov3d(
        scales, quats, scale_modifier)
    cov2d = compute_cov2d(means3d, cov3d, viewmatrix, focal_x, focal_y,
                          tan_fovx, tan_fovy)
    a, b, c = cov2d[..., 0], cov2d[..., 1], cov2d[..., 2]
    det = a * c - b * b
    det_ok = det != 0.0
    det_inv = 1.0 / torch.where(det_ok, det, 1.0)
    conics = torch.stack([c * det_inv, -b * det_inv, a * det_inv], dim=-1)

    # Screen-space radius from the max eigenvalue of cov2d
    # (reference: cuda_rasterizer/forward.cu:229-232).
    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius_f = torch.ceil(3.0 * torch.sqrt(lam))

    px = ndc_to_pixel(p_proj[..., 0], width)
    py = ndc_to_pixel(p_proj[..., 1], height)
    if principal is not None:
        # Python scalars, not a tensor copied from the host: such a copy
        # would make every render wait for the card.
        px = px + (principal[0] - 0.5 * width)
        py = py + (principal[1] - 0.5 * height)
    means2d = torch.stack([px, py], dim=-1)

    on_screen = (
        (means2d[..., 0] + radius_f > 0)
        & (means2d[..., 0] - radius_f < width)
        & (means2d[..., 1] + radius_f > 0)
        & (means2d[..., 1] - radius_f < height)
    )
    visible = in_front & det_ok & on_screen
    if live_mask is not None:
        visible = visible & live_mask
    radii = torch.where(visible, radius_f, 0.0).to(torch.int32)

    if colors_precomp is not None:
        rgb = colors_precomp
    else:
        rgb = sh_ops.sh_to_rgb(sh_degree, shs, means3d, cam_center)

    return Preprocessed(
        means2d=means2d,
        depths=depths,
        conics=conics,
        radii=radii,
        rgb=rgb,
        visible=visible,
    )
