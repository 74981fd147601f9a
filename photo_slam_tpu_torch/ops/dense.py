"""Dense reference renderer: exact alpha compositing over ALL Gaussians.

Counterpart of photo_slam_tpu/ops/dense.py and the port's own oracle for
mode="dense": O(N * H * W), with the per-pixel semantics of the reference
render kernel (cuda_rasterizer/forward.cu:261-374):

  * Gaussians blended front-to-back in view-depth order,
  * power = -0.5*(A dx^2 + C dy^2) - B dx dy, skip if power > 0,
  * alpha = min(0.99, opacity * exp(power)), skip if alpha < 1/255,
  * stop when transmittance would drop below 1e-4 (that contribution and all
    later ones are dropped),
  * out = accumulated color + final_T * background.

The sequential early exit is a prefix mask over the depth-ordered cumulative
product, and a Gaussian only touches pixels whose 16x16 tile lies inside its
radius rect, as the binning implies.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from photo_slam_tpu_torch.ops.preprocess import Preprocessed

ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4


class RenderOutput(NamedTuple):
    image: torch.Tensor      # [3, H, W]
    final_T: torch.Tensor    # [H, W] final transmittance
    n_contrib: torch.Tensor  # [H, W] int32 number of counted contributions


def blend_pixels(xy, conic, opacity, rgb, active, pix_x, pix_y, bg,
                 rects=None, tile: int = 16):
    """Blend depth-sorted Gaussians into a flat set of pixels.

    xy [N,2], conic [N,3], opacity [N], rgb [N,3], active [N]: per-Gaussian
    data sorted front to back; pix_x, pix_y [P] pixel coordinates; bg [3];
    rects (x0, y0, x1, y1) [N] each restrict a Gaussian to its tiles.
    Returns (color [P,3] incl. background, final_T [P], n_contrib [P]).
    """
    dx = xy[:, 0:1] - pix_x[None, :]  # [N, P]
    dy = xy[:, 1:2] - pix_y[None, :]
    power = (
        -0.5 * (conic[:, 0:1] * dx * dx + conic[:, 2:3] * dy * dy)
        - conic[:, 1:2] * dx * dy
    )
    alpha = torch.clamp_max(opacity[:, None] * torch.exp(power), ALPHA_MAX)
    alpha = torch.where((power > 0.0) | (alpha < ALPHA_MIN), 0.0, alpha)
    alpha = torch.where(active[:, None], alpha, 0.0)
    if rects is not None:
        x0, y0, x1, y1 = rects
        ptx = (pix_x / tile).to(torch.int32)[None, :]
        pty = (pix_y / tile).to(torch.int32)[None, :]
        in_rect = (
            (ptx >= x0[:, None]) & (ptx < x1[:, None])
            & (pty >= y0[:, None]) & (pty < y1[:, None])
        )
        alpha = torch.where(in_rect, alpha, 0.0)

    # S_k = prod_{j<=k} (1 - alpha_j); T_k = S_{k-1}; counted iff S_k >= eps.
    S = torch.cumprod(1.0 - alpha, dim=0)
    T = torch.cat([torch.ones_like(S[:1]), S[:-1]], dim=0)
    counted = S >= T_EPS
    w = alpha * T * counted
    color = w.T @ rgb
    final_T = torch.where(counted, S, 1.0).amin(dim=0)
    n_contrib = (counted & (alpha > 0.0)).sum(dim=0, dtype=torch.int32)
    return color + final_T[:, None] * bg[None, :], final_T, n_contrib


def render_dense(prep: Preprocessed, opacities: torch.Tensor, width: int,
                 height: int, bg_color: torch.Tensor,
                 row_chunk: int = 8) -> RenderOutput:
    """Render the full image by blending every Gaussian into every pixel.
    `opacities` is the activated (sigmoid) opacity, shape [N]."""
    from photo_slam_tpu_torch.ops.binning import compute_rects

    dev = prep.means2d.device
    order = torch.argsort(torch.where(prep.visible, prep.depths, torch.inf))
    xy = prep.means2d[order]
    conic = prep.conics[order]
    rgb = prep.rgb[order]
    op = opacities[order]
    active = prep.visible[order]
    rects = compute_rects(xy, prep.radii[order], width, height)

    xs = torch.arange(width, dtype=torch.float32, device=dev)
    colors, ts, ns = [], [], []
    for y0 in range(0, height, row_chunk):
        yy = y0 + torch.arange(row_chunk, dtype=torch.float32, device=dev)
        py, px = torch.meshgrid(yy, xs, indexing="ij")
        c, t, n = blend_pixels(xy, conic, op, rgb, active, px.reshape(-1),
                               py.reshape(-1), bg_color, rects=rects)
        colors.append(c.reshape(row_chunk, width, 3))
        ts.append(t.reshape(row_chunk, width))
        ns.append(n.reshape(row_chunk, width))
    image = torch.cat(colors)[:height]
    return RenderOutput(
        image=image.permute(2, 0, 1),
        final_T=torch.cat(ts)[:height],
        n_contrib=torch.cat(ns)[:height],
    )
