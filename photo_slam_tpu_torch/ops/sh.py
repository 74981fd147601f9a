"""Spherical-harmonics color evaluation, degrees 0..4.

Counterpart of photo_slam_tpu/ops/sh.py (reference:
cuda_rasterizer/forward.cu:20-71, include/sh_utils.h:33-148). SH layout is
the standard 3DGS one: shs[N, K, 3] with K = (deg+1)^2, coefficient 0 is the
DC term.
"""
from __future__ import annotations

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
SH_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)
SH_C4 = (
    2.5033429417967046,
    -1.7701307697799304,
    0.9461746957575601,
    -0.6690465435572892,
    0.10578554691520431,
    -0.6690465435572892,
    0.47308734787878004,
    -1.7701307697799304,
    0.6258357354491761,
)


def num_sh_coeffs(degree: int) -> int:
    return (degree + 1) ** 2


def eval_sh(degree: int, shs: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Raw SH colors [..., 3] (before the +0.5 shift and clamp of
    :func:`sh_to_rgb`) of shs [..., K, 3], K >= (degree+1)^2, along unit
    view directions dirs [..., 3]."""
    result = SH_C0 * shs[..., 0, :]
    if degree > 0:
        x = dirs[..., 0:1]
        y = dirs[..., 1:2]
        z = dirs[..., 2:3]
        result = (
            result
            - SH_C1 * y * shs[..., 1, :]
            + SH_C1 * z * shs[..., 2, :]
            - SH_C1 * x * shs[..., 3, :]
        )
        if degree > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            result = (
                result
                + SH_C2[0] * xy * shs[..., 4, :]
                + SH_C2[1] * yz * shs[..., 5, :]
                + SH_C2[2] * (2.0 * zz - xx - yy) * shs[..., 6, :]
                + SH_C2[3] * xz * shs[..., 7, :]
                + SH_C2[4] * (xx - yy) * shs[..., 8, :]
            )
            if degree > 2:
                result = (
                    result
                    + SH_C3[0] * y * (3.0 * xx - yy) * shs[..., 9, :]
                    + SH_C3[1] * xy * z * shs[..., 10, :]
                    + SH_C3[2] * y * (4.0 * zz - xx - yy) * shs[..., 11, :]
                    + SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * shs[..., 12, :]
                    + SH_C3[4] * x * (4.0 * zz - xx - yy) * shs[..., 13, :]
                    + SH_C3[5] * z * (xx - yy) * shs[..., 14, :]
                    + SH_C3[6] * x * (xx - 3.0 * yy) * shs[..., 15, :]
                )
                if degree > 3:
                    result = (
                        result
                        + SH_C4[0] * xy * (xx - yy) * shs[..., 16, :]
                        + SH_C4[1] * yz * (3.0 * xx - yy) * shs[..., 17, :]
                        + SH_C4[2] * xy * (7.0 * zz - 1.0) * shs[..., 18, :]
                        + SH_C4[3] * yz * (7.0 * zz - 3.0) * shs[..., 19, :]
                        + SH_C4[4] * (zz * (35.0 * zz - 30.0) + 3.0) * shs[..., 20, :]
                        + SH_C4[5] * xz * (7.0 * zz - 3.0) * shs[..., 21, :]
                        + SH_C4[6] * (xx - yy) * (7.0 * zz - 1.0) * shs[..., 22, :]
                        + SH_C4[7] * xz * (xx - 3.0 * yy) * shs[..., 23, :]
                        + SH_C4[8] * (xx * (xx - 3.0 * yy)
                                      - yy * (3.0 * xx - yy)) * shs[..., 24, :]
                    )
    return result


def sh_to_rgb(degree: int, shs: torch.Tensor, means: torch.Tensor,
              campos: torch.Tensor) -> torch.Tensor:
    """SH -> RGB as the rasterizer does per Gaussian: +0.5 shift, then
    clamp at 0 (reference: cuda_rasterizer/forward.cu:63-70)."""
    dirs = means - campos[None, :]
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    rgb = eval_sh(degree, shs, dirs) + 0.5
    return torch.clamp_min(rgb, 0.0)


def sh_to_rgb_dc(sh: torch.Tensor) -> torch.Tensor:
    """DC SH coefficient -> RGB (reference: include/sh_utils.h SH2RGB)."""
    return sh * SH_C0 + 0.5


def rgb_to_sh(rgb: torch.Tensor) -> torch.Tensor:
    """RGB in [0,1] -> DC SH coefficient (reference: include/sh_utils.h RGB2SH)."""
    return (rgb - 0.5) / SH_C0
