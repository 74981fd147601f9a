"""Replay a recorded MappingOperation stream through the online mapper.

Counterpart of photo_slam_tpu/apps/replay_stream.py: the record/replay
counterpart of a live tracker (SURVEY.md §4 recommends scripted
MappingOperation streams as the CI substitute for running the SLAM
frontend). A stream captured with `mapping_ops.save_stream` by either
package re-runs here deterministically, on `--device` (default cuda).

Usage:
  python -m photo_slam_tpu_torch.apps.replay_stream --stream ops.npz \
      --out out/ [--fx 600 --fy 600 --cx 599.5 --cy 339.5 --width 1200 \
      --height 680] [--iters N] [--device cuda]
"""
from __future__ import annotations

import argparse

from photo_slam_tpu_torch.apps.online_slam import cli_device
from photo_slam_tpu_torch.config import Config, load_reference_yaml
from photo_slam_tpu_torch.mapper.mapper import GaussianMapper, SensorType
from photo_slam_tpu_torch.mapper.mapping_ops import load_stream
from photo_slam_tpu_torch.models.camera import PINHOLE, Camera


def main(argv=None) -> GaussianMapper:
    ap = argparse.ArgumentParser()
    ap.add_argument("--stream", required=True, help=".npz op stream")
    ap.add_argument("--out", required=True)
    ap.add_argument("--cfg", default=None)
    ap.add_argument("--sensor", default="rgbd",
                    choices=["mono", "stereo", "rgbd"])
    ap.add_argument("--fx", type=float, default=600.0)
    ap.add_argument("--fy", type=float, default=600.0)
    ap.add_argument("--cx", type=float, default=599.5)
    ap.add_argument("--cy", type=float, default=339.5)
    ap.add_argument("--width", type=int, default=1200)
    ap.add_argument("--height", type=int, default=680)
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device to map on (default: cuda)")
    args = ap.parse_args(argv)

    device = cli_device(args.device)
    cfg = load_reference_yaml(args.cfg) if args.cfg else Config()
    sensor = {"mono": SensorType.MONOCULAR, "stereo": SensorType.STEREO,
              "rgbd": SensorType.RGBD}[args.sensor]
    mapper = GaussianMapper(cfg, sensor, result_dir=args.out, device=device)
    mapper.add_camera(Camera(
        camera_id=0, model_id=PINHOLE, width=args.width, height=args.height,
        fx=args.fx, fy=args.fy, cx=args.cx, cy=args.cy))

    ops = load_stream(args.stream)
    for op in ops:
        mapper.queue.push(op)
    print(f"[replay_stream] queued {len(ops)} operations")
    mapper.run(is_tracker_done=lambda: True, max_iterations=args.iters)
    print(f"[replay_stream] {mapper.trainer.iteration} iters, "
          f"{len(mapper.scene.keyframes)} kfs, "
          f"{mapper.trainer.metrics.num_live} gaussians on {device} -> "
          f"{args.out}")
    return mapper


if __name__ == "__main__":
    main()
