"""A synthetic COLMAP dataset, rendered by the port: the input of the
offline training path (apps/train_colmap.py).

Counterpart of tools/gen_synth_colmap.py (reference: examples/
train_colmap.cpp with scripts/colmap.sh): tools/synth_replica.py's
cylinder room (60,000 splats, seed 3) seen by `num` cameras on a ring of
yaws, each at a small offset from the room's axis with a height drawn from
RandomState(0), f = 0.55 w and the principal point at w / 2 - 0.5. Each
view renders through the port's `render` in mode "pallas" with the splats'
own colours (k_dup 8, 1024 entries a tile) on the given device; the sparse
init is 20,000 of the splats, chosen and moved by 2 cm noise from the same
stream, after the views' draws, so poses and points equal the JAX tool's.

Layout: <out>/sparse/0/{cameras,images,points3D}.bin (the port's io/colmap
writers) and <out>/images/frame_NNNN.png (io/images, which writes PNG
without cv2 or PIL: the card's machine has neither).

Usage:
  python -m photo_slam_tpu_torch.tools.synth_colmap <out_dir> \
      [--views 40] [--width 640] [--height 480] [--device cuda]
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from photo_slam_tpu_torch.io import colmap
from photo_slam_tpu_torch.io.images import save_image_chw
from photo_slam_tpu_torch.ops.camera_math import build_camera_matrices
from photo_slam_tpu_torch.ops.render import RenderSettings, render
from photo_slam_tpu_torch.tools.synth_replica import cylinder_world
from photo_slam_tpu_torch.utils.math import rotmat_to_quat_numpy

NUM_VIEWS, WIDTH, HEIGHT = 40, 640, 480
INIT_POINTS = 20_000
INIT_NOISE = 0.02


def view_pose(i: int, num: int, rng: np.random.RandomState):
    """(R world->camera, camera center) of view i: yaw 2 pi i / num, the
    center 0.4 m off the axis, its height drawn from `rng`."""
    yaw = 2 * np.pi * i / num
    cy, sy = np.cos(yaw), np.sin(yaw)
    R = np.array([[cy, 0, -sy], [0, 1, 0], [sy, 0, cy]])
    c_w = np.array([0.4 * np.sin(yaw + 1.2), rng.uniform(-0.2, 0.2),
                    0.4 * np.cos(yaw + 1.2)])
    return R, c_w


def write(out, num: int = NUM_VIEWS, width: int = WIDTH,
          height: int = HEIGHT, device="cuda") -> Path:
    """Render and write the dataset under `out`; returns `out`."""
    device = torch.device(device)
    out = Path(out)
    f = 0.55 * width
    fovx = 2 * np.arctan(width / (2 * f))
    fovy = 2 * np.arctan(height / (2 * f))
    world = cylinder_world()
    pts, cols = world[0], world[4]
    splats = [torch.from_numpy(x).to(device) for x in world]
    settings = RenderSettings(width=width, height=height,
                              tan_fovx=float(np.tan(fovx / 2)),
                              tan_fovy=float(np.tan(fovy / 2)),
                              max_per_tile=1024, max_tiles_per_gaussian=8,
                              mode="pallas")
    sparse = out / "sparse" / "0"
    sparse.mkdir(parents=True, exist_ok=True)
    imgdir = out / "images"
    imgdir.mkdir(exist_ok=True)

    cams = {1: colmap.ColmapCamera(
        1, "PINHOLE", width, height,
        np.array([f, f, width / 2 - 0.5, height / 2 - 0.5]))}
    images = {}
    rng = np.random.RandomState(0)
    bg = torch.zeros(3, device=device)
    for i in range(num):
        R, c_w = view_pose(i, num, rng)
        t = -R @ c_w
        mats = build_camera_matrices(R, t, 0.01, 100.0, fovx, fovy,
                                     device=device)
        with torch.no_grad():
            img = render(*splats[:4], mats, settings, bg,
                         colors_precomp=splats[4]).image
        name = f"frame_{i:04d}.png"
        save_image_chw(imgdir / name, img.cpu().numpy())
        images[i + 1] = colmap.ColmapImage(
            image_id=i + 1, quat_wxyz=rotmat_to_quat_numpy(R), trans=t,
            camera_id=1, name=name, xys=np.zeros((0, 2)),
            point3d_ids=np.zeros(0, np.int64))

    # The sparse init: a noisy subsample of the world (the role of COLMAP's
    # triangulated points).
    sel = rng.choice(len(pts), INIT_POINTS, replace=False)
    colmap.write_cameras_bin(sparse / "cameras.bin", cams)
    colmap.write_images_bin(sparse / "images.bin", images)
    colmap.write_points3d_bin(
        sparse / "points3D.bin", np.arange(len(sel)),
        pts[sel] + rng.randn(len(sel), 3).astype(np.float32) * INIT_NOISE,
        cols[sel])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("--views", type=int, default=NUM_VIEWS)
    ap.add_argument("--width", type=int, default=WIDTH)
    ap.add_argument("--height", type=int, default=HEIGHT)
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default: cuda)")
    args = ap.parse_args(argv)
    from photo_slam_tpu_torch.apps.online_slam import cli_device

    out = write(args.out, args.views, args.width, args.height,
                cli_device(args.device))
    print(f"wrote {args.views} views -> {out}")


if __name__ == "__main__":
    main()
