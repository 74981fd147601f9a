"""Live RGB-D mapping from an Intel RealSense camera.

Counterpart of photo_slam_tpu/apps/realsense_rgbd.py (reference:
examples/realsense_rgbd.cpp, librealsense capture feeding TrackRGBD):
captures aligned color and depth frames with pyrealsense2, tracks them with
the ORB + PnP frontend (ORB on `--device`), maps them online on
`--device` (default cuda) and serves the live viewer. Gated on pyrealsense2
and a connected camera.

Usage:
  python -m photo_slam_tpu_torch.apps.realsense_rgbd --out <dir>
          [--cfg yaml] [--width 640 --height 480 --fps 30] [--max-frames N]
          [--viewer-port 8090] [--device cuda]
"""
from __future__ import annotations

import argparse
import threading
from pathlib import Path

import numpy as np

from photo_slam_tpu_torch.apps.online_slam import cli_device
from photo_slam_tpu_torch.config import dataset_config, load_reference_yaml
from photo_slam_tpu_torch.mapper.mapper import GaussianMapper, SensorType
from photo_slam_tpu_torch.models.camera import PINHOLE, Camera
from photo_slam_tpu_torch.tracking.gt_tracker import Frame


def capture_frames(width, height, fps, max_frames):
    """(camera, iterator of Frames) from a live RealSense pipeline, depth
    aligned to color."""
    try:
        import pyrealsense2 as rs
    except ImportError as e:  # hardware-gated
        raise RuntimeError(
            "pyrealsense2 is not installed; realsense_rgbd needs a RealSense "
            "camera + SDK. Use the dataset apps (replica/tum/euroc) instead."
        ) from e

    pipeline = rs.pipeline()
    cfg = rs.config()
    cfg.enable_stream(rs.stream.color, width, height, rs.format.rgb8, fps)
    cfg.enable_stream(rs.stream.depth, width, height, rs.format.z16, fps)
    profile = pipeline.start(cfg)
    align = rs.align(rs.stream.color)
    intr = (profile.get_stream(rs.stream.color)
            .as_video_stream_profile().get_intrinsics())
    depth_scale = profile.get_device().first_depth_sensor().get_depth_scale()

    camera = Camera(camera_id=0, model_id=PINHOLE, width=intr.width,
                    height=intr.height, fx=intr.fx, fy=intr.fy,
                    cx=intr.ppx, cy=intr.ppy,
                    dist_coeffs=np.asarray(list(intr.coeffs)[:5], np.float32))

    def frames():
        i = 0
        try:
            while max_frames is None or i < max_frames:
                fs = align.process(pipeline.wait_for_frames())
                color = np.asanyarray(fs.get_color_frame().get_data())
                depth = np.asanyarray(fs.get_depth_frame().get_data())
                yield Frame(
                    image=np.transpose(color.astype(np.float32) / 255.0,
                                       (2, 0, 1)),
                    quat_wxyz=np.array([1.0, 0, 0, 0]),
                    trans=np.zeros(3),
                    depth=depth.astype(np.float32) * depth_scale,
                    filename=f"rs_{i:06d}")
                i += 1
        finally:
            pipeline.stop()

    return camera, frames()


def main(argv=None) -> GaussianMapper:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--cfg", default=None)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--fps", type=int, default=30)
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--viewer-port", type=int, default=8090)
    ap.add_argument("--device", default="cuda",
                    help="torch device to map and extract ORB on "
                         "(default: cuda)")
    args = ap.parse_args(argv)

    cfg = (load_reference_yaml(args.cfg) if args.cfg
           else dataset_config("realsense_rgbd"))
    device = cli_device(args.device)
    camera, frames = capture_frames(args.width, args.height, args.fps,
                                    args.max_frames)

    from photo_slam_tpu_torch.tracking.vo_tracker import OrbVoTracker
    from photo_slam_tpu_torch.viewer.server import ViewerServer

    mapper = GaussianMapper(cfg, SensorType.RGBD, result_dir=Path(args.out),
                            device=device)
    mapper.add_camera(camera)
    tracker = OrbVoTracker(camera, device=mapper.device)
    viewer = ViewerServer(mapper, port=args.viewer_port)
    viewer.start()
    print(f"[realsense_rgbd] viewer at http://127.0.0.1:{viewer.port}")

    # A tracker crash must still flip `done`, or the mapper waits forever;
    # it is re-raised after the join.
    tracker_error: list[BaseException] = []

    def run_tracker():
        try:
            tracker.run(frames, mapper.queue.push)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            tracker_error.append(e)
            tracker.done = True

    th = threading.Thread(target=run_tracker, daemon=True)
    th.start()
    try:
        mapper.run(is_tracker_done=lambda: tracker.done,
                   live_kf_ids=lambda: tracker.live_kf_ids)
    finally:
        th.join()
        viewer.stop()
    if tracker_error:
        raise tracker_error[0]
    return mapper


if __name__ == "__main__":
    main()
