"""Offline 3DGS training from a COLMAP reconstruction.

Counterpart of photo_slam_tpu/apps/train_colmap.py (reference:
examples/train_colmap.cpp): load cameras/images/points3D.bin and the image
files, build the scene, run the offline training loop on one device, save
the model and a summary.

Every --log-every iterations the trainer prints and keeps a trace row
(GaussianTrainer.trace_row). summary.json holds the trace, the first
iteration's PSNR, the iteration at which the capacity reached
`max_capacity` (null if it did not) and, on a card, the peak device
memory.

Usage:
  python -m photo_slam_tpu_torch.apps.train_colmap \
      --data <colmap_root with sparse/0 and images/> \
      --out <result_dir> [--cfg mapper.yaml] [--iters N] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from photo_slam_tpu_torch.config import Config, load_reference_yaml
from photo_slam_tpu_torch.io.colmap import load_reconstruction
from photo_slam_tpu_torch.io.images import load_image_chw
from photo_slam_tpu_torch.mapper.trainer import GaussianTrainer
from photo_slam_tpu_torch.models.camera import PINHOLE, Camera, resize_image
from photo_slam_tpu_torch.models.keyframe import Keyframe
from photo_slam_tpu_torch.models.scene import Scene
from photo_slam_tpu_torch.utils.ply import save_points_ply


def build_scene_from_colmap(data_dir, cfg: Config, *, device,
                            image_subdir: str = "images"):
    """Scene (cameras + keyframes with images, matrices on `device`) and the
    sparse points (xyz, rgb) of a COLMAP reconstruction."""
    data_dir = Path(data_dir)
    sparse = data_dir / "sparse" / "0"
    if not sparse.exists():
        sparse = data_dir / "sparse"
    cams, images, (ids, xyz, rgb) = load_reconstruction(sparse)

    scene = Scene()
    for cam_id, c in cams.items():
        if c.model == "PINHOLE":
            fx, fy, cx, cy = c.params
        elif c.model == "SIMPLE_PINHOLE":
            fx, cx, cy = c.params
            fy = fx
        else:
            raise ValueError(
                f"unsupported COLMAP camera model {c.model}: undistort first")
        scene.add_camera(Camera(
            camera_id=cam_id, model_id=PINHOLE, width=c.width,
            height=c.height, fx=fx, fy=fy, cx=cx, cy=cy,
        ))

    num_sub = cfg.mapper.num_gaus_pyramid_sub_levels if (
        cfg.mapper.do_gaus_pyramid_training) else 0
    for image_id, im in sorted(images.items()):
        cam = scene.cameras[im.camera_id]
        kf = Keyframe(fid=image_id, camera=cam,
                      znear=cfg.mapper.z_near, zfar=cfg.mapper.z_far)
        kf.set_pose(im.quat_wxyz, im.trans, device=device)
        img = load_image_chw(data_dir / image_subdir / im.name)
        if img.shape[1] != cam.height or img.shape[2] != cam.width:
            hwc = np.transpose(img, (1, 2, 0))
            img = np.transpose(resize_image(hwc, cam.height, cam.width),
                               (2, 0, 1))
        kf.set_image(img, num_sub,
                     cfg.mapper.gaus_pyramid_sub_level_times_of_use)
        kf.img_filename = im.name
        kf.remaining_times_of_use = 10**9  # offline: uniform ring
        scene.add_keyframe(kf)
    return scene, (xyz, rgb)


def main(argv=None) -> tuple[dict, GaussianTrainer]:
    """Train and save; returns the summary and the trainer."""
    from photo_slam_tpu_torch.apps.online_slam import cli_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--data", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--cfg", default=None)
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--log-every", type=int, default=200)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: cuda)")
    args = ap.parse_args(argv)

    device = cli_device(args.device)
    cfg = load_reference_yaml(args.cfg) if args.cfg else Config()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    scene, (xyz, rgb) = build_scene_from_colmap(args.data, cfg, device=device)
    trainer = GaussianTrainer(cfg, scene, device=device)
    trainer.initialize_map(xyz, rgb)

    iters = args.iters or cfg.opt.max_num_iterations
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.time()
    met = trainer.train(num_iterations=iters, log_every=args.log_every)
    wall = time.time() - t0

    it_dir = out / "point_cloud" / f"iteration_{trainer.iteration}"
    trainer.save_ply(it_dir / "point_cloud.ply")
    save_points_ply(out / "input.ply", xyz, (rgb * 255).astype(np.uint8))
    summary = {
        "iterations": trainer.iteration,
        "wall_seconds": wall,
        "iters_per_sec": trainer.iteration / max(wall, 1e-9),
        "ema_loss": trainer.ema_loss,
        "last_psnr": trainer.metrics.last_psnr,
        "num_gaussians": trainer.metrics.num_live,
        "device": str(device),
        "first_psnr": met.first_psnr,
        "capacity": trainer.state.capacity,
        "max_capacity": cfg.renderer.max_capacity,
        "ceiling_reached_at": met.ceiling_reached_at,
        "num_dropped": trainer.metrics.num_dropped,
        # Captured step graphs (mapper/trainer.StepGraphs): one a pyramid
        # size, SH degree and capacity the run met.
        "graph_captures": trainer.graphs.captures,
        "peak_memory_gib": (torch.cuda.max_memory_allocated(device) / 2**30
                            if device.type == "cuda" else None),
        "trace": met.trace,
    }
    (out / "summary.json").write_text(json.dumps(summary, indent=2))
    print(f"[train_colmap] {trainer.iteration} iters in {wall:.1f}s "
          f"({trainer.iteration / max(wall, 1e-9):.1f} it/s), "
          f"PSNR {trainer.metrics.last_psnr:.2f}, "
          f"{trainer.metrics.num_live} gaussians on {device} -> {out}")
    return summary, trainer


if __name__ == "__main__":
    main()
