"""Depth reprojection + monocular neighborhood depth densification.

Counterpart of photo_slam_tpu/ops/depth_ops.py (reference:
src/stereo_vision.cu:39-136, cuda_rasterizer/stereo_vision.h:41-55), plain
PyTorch on the device of the tensors given:

  * reproject_depth_map: pinhole back-projection of masked depth pixels to
    camera-frame 3D;
  * mono_neighbor_densify: for keypoints without depth, borrow the depth of
    the nearest keypoint (squared pixel distance <= max_pixel_dist) that has
    one, then back-project; the reference's O(N^2) per-pair search is one
    [N, N] distance matrix + argmin (N is the keypoint count, ~800).
"""
from __future__ import annotations

import torch


def backproject_pinhole(u, v, depth, fx, fy, cx, cy) -> torch.Tensor:
    """Camera-frame 3D from pixel + depth
    (reference: cuda_rasterizer/stereo_vision.h:41-55)."""
    x = (u - cx) * depth / fx
    y = (v - cy) * depth / fy
    return torch.stack([x, y, depth], dim=-1)


def reproject_depth_map(depth: torch.Tensor, mask: torch.Tensor, fx, fy, cx,
                        cy) -> torch.Tensor:
    """[H,W] depth (+ validity mask) -> [H*W, 3] camera-frame points
    (invalid rows keep z = 0) (reference: src/stereo_vision.cu:39-61)."""
    h, w = depth.shape
    v, u = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=depth.device),
        torch.arange(w, dtype=torch.float32, device=depth.device),
        indexing="ij")
    d = torch.where(mask, depth, 0.0)
    return backproject_pinhole(u, v, d, fx, fy, cx, cy).reshape(-1, 3)


def mono_neighbor_densify(pixels: torch.Tensor, has3d: torch.Tensor,
                          points_local: torch.Tensor, max_pixel_dist: float,
                          fx, fy, cx, cy
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Estimate camera-frame 3D for depthless keypoints
    (reference: src/stereo_vision.cu:63-136).

    pixels [N, 2] keypoint pixel coordinates (undistorted), has3d [N] bool
    (keypoint has a matched map point), points_local [N, 3] camera-frame 3D
    of the matched keypoints (0 where none); max_pixel_dist is compared with
    the SQUARED pixel distance (the reference compares squared distances
    with the config value directly).

    Returns (points [N, 3], valid [N]): keypoints with 3D keep their point,
    the others borrow the nearest-with-depth neighbour's z and back-project;
    valid is False where no donor lies inside the radius."""
    n = pixels.shape[0]
    d2 = ((pixels[:, None, :] - pixels[None, :, :]) ** 2).sum(-1)  # [N, N]
    eye = torch.eye(n, dtype=torch.bool, device=pixels.device)
    d2m = torch.where(has3d[None, :] & ~eye, d2, 1e20)
    nn = torch.argmin(d2m, dim=1)
    nn_dist = torch.gather(d2m, 1, nn[:, None])[:, 0]
    donor_ok = nn_dist <= max_pixel_dist
    depth = points_local[nn, 2]
    borrowed = backproject_pinhole(pixels[:, 0], pixels[:, 1], depth,
                                   fx, fy, cx, cy)
    pts = torch.where(has3d[:, None], points_local, borrowed)
    return pts, has3d | (donor_ok & (depth > 0.0))
