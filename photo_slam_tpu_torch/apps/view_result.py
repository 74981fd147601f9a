"""View a saved map: load a PLY, render requested poses, write PNGs.

Counterpart of photo_slam_tpu/apps/view_result.py (reference:
examples/view_result.cpp:43-69 + GaussianMapper::loadPly,
src/gaussian_mapper.cpp:1982-2055): renders a sweep of poses (or the poses
in a cameras.json) on one device through the kernel render path, each
view replayed from one captured graph (ops/render.render_jit).

Usage:
  python -m photo_slam_tpu_torch.apps.view_result --ply <point_cloud.ply> \
      --out <dir> [--cameras cameras.json] [--width 1200 --height 680] \
      [--device cuda]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from photo_slam_tpu_torch.config import Config
from photo_slam_tpu_torch.io.images import save_image_chw
from photo_slam_tpu_torch.models import gaussian_model as gm
from photo_slam_tpu_torch.ops.camera_math import build_camera_matrices
from photo_slam_tpu_torch.ops.render import RenderSettings, render_jit


def load_state(path, cfg: Config, *, device) -> tuple[gm.GaussianState, int]:
    """Load a 3DGS checkpoint into a map on `device` the way the JAX
    trainer's load_ply does (photo_slam_tpu/mapper/trainer.py:631-649):
    capacity max(initial_capacity, round_capacity(n)), SH degree from the
    number of f_rest coefficients. Returns (state, sh_degree)."""
    return gm.state_from_ply(path, cfg.renderer.initial_capacity,
                             device=device)


def view_poses(cameras, max_views: int):
    """[(name, Rcw, tcw)] from a cameras.json path, or a sweep along +x."""
    views = []
    if cameras:
        for c in json.loads(Path(cameras).read_text())[:max_views]:
            Rwc = np.array(c["rotation"])
            twc = np.array(c["position"])
            Rcw = Rwc.T
            views.append((c["img_name"], Rcw, -Rcw @ twc))
    else:
        for i in range(max_views):
            views.append((f"sweep_{i:03d}", np.eye(3),
                          np.array([0.15 * i, 0.0, 0.0])))
    return views


def render_views(state: gm.GaussianState, sh_degree: int, views,
                 width: int, height: int, fx: float,
                 fy: float) -> list[tuple[str, torch.Tensor]]:
    """Render each (name, Rcw, tcw) view of the map on its device with the
    JAX app's settings; returns [(name, image [3, H, W])]."""
    device = state.live.device
    fovx = 2 * np.arctan(width / (2 * fx))
    fovy = 2 * np.arctan(height / (2 * fy))
    settings = RenderSettings(
        width=width, height=height,
        tan_fovx=float(np.tan(fovx / 2)), tan_fovy=float(np.tan(fovy / 2)),
        sh_degree=sh_degree, mode="pallas")
    scales, quats, opac = gm.activated(state.params)
    shs = gm.sh_features(state.params)
    bg = torch.zeros(3, device=device)
    images = []
    for name, R, t in views:
        mats = build_camera_matrices(R, t, 0.01, 100.0, fovx, fovy,
                                     device=device)
        res = render_jit(state.params.xyz, scales, quats, opac, mats,
                         settings, bg, shs=shs, live_mask=state.live)
        images.append((str(name), res.image))
    return images


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ply", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--cameras", default=None, help="cameras.json")
    ap.add_argument("--width", type=int, default=1200)
    ap.add_argument("--height", type=int, default=680)
    ap.add_argument("--fx", type=float, default=600.0)
    ap.add_argument("--fy", type=float, default=600.0)
    ap.add_argument("--max-views", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default: cuda)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu to render on the CPU)")
    # The renderer's float32 products stay full precision on the card.
    torch.backends.cuda.matmul.allow_tf32 = False

    state, sh_degree = load_state(args.ply, Config(), device=device)
    n = int(state.live.sum())
    print(f"[view_result] loaded {n} gaussians from {args.ply}")

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    images = render_views(state, sh_degree,
                          view_poses(args.cameras, args.max_views),
                          args.width, args.height, args.fx, args.fy)
    for name, img in images:
        save_image_chw(out / f"{Path(name).stem}.png", img.cpu().numpy())
    print(f"[view_result] wrote {len(images)} renders -> {out}")


if __name__ == "__main__":
    main()
