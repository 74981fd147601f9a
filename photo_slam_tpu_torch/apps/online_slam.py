"""Shared online-SLAM app runner + per-dataset CLI entry points.

Counterpart of photo_slam_tpu/apps/online_slam.py, mirroring the reference
example mains (reference: examples/replica_rgbd.cpp, tum_rgbd.cpp,
tum_mono.cpp): load a sequence, run the tracker thread and the Gaussian
mapper concurrently, save the trajectories, per-keyframe metrics and the
final map. The map and its training run on `--device` (default cuda); the
tracker thread stays on the host, apart from the feature frontends' ORB,
which runs on the same device.

Frontends: `slam` (the default: local-map tracking, local BA on its own
thread unless --no-async-mapping, loop closing, relocalization; with --imu
the visual-inertial initialization and its ScaleRefinement ops), `vo`
(ORB + PnP odometry) and `gt` (the datasets' ground-truth poses). Stereo
depth (euroc_stereo) is the port's SGM on the device. --viewer serves the
live web viewer (viewer/server.py) on --viewer-port while the run lasts;
--batch N trains N keyframes per optimization step
(trainer.train_iteration_batched).

Usage:
  python -m photo_slam_tpu_torch.apps.online_slam replica_rgbd \
      --data <seq> --out <dir> [--frontend slam|vo|gt] [--iters N] \
      [--device cuda] [--viewer --viewer-port 8090] [--batch N]
  python -m photo_slam_tpu_torch.apps.online_slam euroc_stereo \
      --data <EuRoC sequence> --out <dir> [--imu] [--bf 47.9]
"""
from __future__ import annotations

import argparse
import json
import threading
import time
from pathlib import Path

import numpy as np
import torch

from photo_slam_tpu_torch.config import (Config, dataset_config,
                                         load_reference_yaml)
from photo_slam_tpu_torch.mapper.mapper import GaussianMapper, SensorType
from photo_slam_tpu_torch.models.camera import PINHOLE, Camera
from photo_slam_tpu_torch.tracking.gt_tracker import GroundTruthTracker
from photo_slam_tpu_torch.utils.evaluate import ate_rmse
from photo_slam_tpu_torch.utils.math import (rotmat_to_quat_numpy,
                                             se3_inverse, se3_matrix)
from photo_slam_tpu_torch.utils.profiling import device_memory_stats
from photo_slam_tpu_torch.utils.trajectory import save_all_formats


def save_trajectory_tum(path, keyframes) -> None:
    """Camera trajectory in TUM format: t tx ty tz qx qy qz qw (camera-to-
    world), the format the reference's trajectory savers emit for
    evaluation (reference: ORB-SLAM3/src/System.cc SaveTrajectoryTUM)."""
    lines = []
    for fid, kf in sorted(keyframes.items()):
        twc = se3_inverse(se3_matrix(kf.quat, kf.trans))
        q = rotmat_to_quat_numpy(twc[:3, :3])
        t = twc[:3, 3]
        lines.append(f"{fid} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                     f"{q[1]:.6f} {q[2]:.6f} {q[3]:.6f} {q[0]:.6f}")
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text("\n".join(lines) + "\n")


def _make_tracker(frontend: str, dataset, sensor: SensorType,
                  keyframe_every: int, num_keypoints: int,
                  async_mapping: bool = True, use_imu: bool = False, *,
                  device):
    if frontend == "gt":
        return GroundTruthTracker(dataset.camera,
                                  keyframe_every=keyframe_every,
                                  num_keypoints=num_keypoints)
    if frontend == "vo":
        from photo_slam_tpu_torch.tracking.vo_tracker import OrbVoTracker
        return OrbVoTracker(dataset.camera, device=device)
    if frontend != "slam":
        raise ValueError(f"unknown frontend {frontend!r}")
    from photo_slam_tpu_torch.tracking.frontend import SlamFrontend
    sensor_name = {SensorType.MONOCULAR: "mono", SensorType.STEREO: "stereo",
                   SensorType.RGBD: "rgbd"}[sensor]
    imu_calib = getattr(dataset, "imu_calib", None)
    if use_imu and imu_calib is None:
        raise ValueError("--imu requested but the dataset has no IMU "
                         "channel/calibration (expected mav0/imu0)")
    return SlamFrontend(dataset.camera, sensor=sensor_name,
                        num_features=max(num_keypoints, 1000),
                        async_local_mapping=async_mapping,
                        use_imu=use_imu, imu_calib=imu_calib, device=device)


def run_online(dataset, sensor: SensorType, cfg: Config, out_dir,
               keyframe_every: int = 10, num_keypoints: int = 800,
               max_iterations=None, threaded: bool = True,
               frontend: str = "slam", viewer: bool = False,
               viewer_port: int = 8090, batch: int = 1,
               async_mapping: bool = True, use_imu: bool = False,
               *, device) -> GaussianMapper:
    """Drive a sequence through tracker + mapper on `device` (reference:
    examples/replica_rgbd.cpp main). `dataset` is any object with a
    `camera` and a `frames()` iterator of gt_tracker.Frame. `frontend`
    selects the tracking stack: "slam" (feature SLAM: local map, local BA,
    loop closing), "vo" (ORB + PnP odometry) or "gt" (the dataset's
    ground-truth poses); the feature frontends extract ORB and compute
    stereo disparity on `device`. `use_imu` runs the slam frontend's
    visual-inertial path on the dataset's `imu_calib` (ValueError when it
    has none). `viewer` serves viewer/server.ViewerServer on `viewer_port`
    (0 picks a free port) for the run; `batch` keyframes train per step.
    With threaded=True the tracker runs on its own thread beside the
    mapper, as in the reference; with threaded=False it pushes the whole
    sequence first, so the queue's contents do not depend on thread
    timing."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    mapper = GaussianMapper(cfg, sensor, result_dir=out, device=device)
    mapper.add_camera(dataset.camera)
    tracker = _make_tracker(frontend, dataset, sensor, keyframe_every,
                            num_keypoints, async_mapping, use_imu,
                            device=mapper.device)
    server = None
    if viewer:
        from photo_slam_tpu_torch.viewer.server import ViewerServer
        server = ViewerServer(mapper, port=viewer_port)
        server.frontend = tracker
        server.start()
        print(f"[online_slam] viewer at http://127.0.0.1:{server.port}/")

    # Stream frames through the tracker while recording GT for ATE.
    gt_poses: list = []
    stamps: list = []

    def frames_with_gt():
        for i, fr in enumerate(dataset.frames()):
            gt_poses.append(se3_matrix(fr.quat_wxyz, fr.trans)
                            if fr.quat_wxyz is not None else None)
            stamps.append(fr.timestamp if fr.timestamp is not None
                          else float(i))
            yield fr

    try:
        t0 = time.time()
        if threaded:
            # Tracker on its own thread, like the reference's tracking
            # thread beside the mapper thread (reference:
            # examples/replica_rgbd.cpp:112). A tracker crash must still
            # flip `done`, or the mapper waits on the queue forever; the
            # exception is re-raised after the join.
            tracker_error: list[BaseException] = []

            def run_tracker():
                try:
                    tracker.run(frames_with_gt(), mapper.queue.push)
                except BaseException as e:  # noqa: BLE001 - re-raised below
                    tracker_error.append(e)
                    tracker.done = True

            th = threading.Thread(target=run_tracker, daemon=True)
            th.start()
            try:
                mapper.run(is_tracker_done=lambda: tracker.done,
                           live_kf_ids=lambda: tracker.live_kf_ids,
                           max_iterations=max_iterations, batch=batch)
            finally:
                th.join()
            if tracker_error:
                raise tracker_error[0]
        else:
            tracker.run(frames_with_gt(), mapper.queue.push)
            mapper.run(is_tracker_done=lambda: True,
                       live_kf_ids=lambda: tracker.live_kf_ids,
                       max_iterations=max_iterations, batch=batch)
        wall = time.time() - t0
    finally:
        if server is not None:
            server.stop()

    # Trajectory outputs, the reference's 5-file set, and the ATE RMSE
    # when the tracker estimated poses and the dataset has ground truth;
    # with the GT frontend the keyframe poses are the trajectory.
    ate = None
    est_tcw = getattr(tracker, "trajectory", None)
    kf_stamps, kf_tcw = [], []
    for fid, kf in sorted(mapper.scene.keyframes.items()):
        kf_stamps.append(float(fid))
        kf_tcw.append(se3_matrix(kf.quat, kf.trans))
    if est_tcw:
        n = min(len(est_tcw), len(stamps))
        save_all_formats(out, stamps[:n], est_tcw[:n], kf_stamps, kf_tcw)
        pairs = [(g, e) for g, e in zip(gt_poses[:n], est_tcw[:n])
                 if g is not None]
        if len(pairs) >= 3:
            gt_pos = np.stack([se3_inverse(g)[:3, 3] for g, _ in pairs])
            est_pos = np.stack([se3_inverse(e)[:3, 3] for _, e in pairs])
            ate = float(ate_rmse(est_pos, gt_pos))
    else:
        save_all_formats(out, kf_stamps, kf_tcw, kf_stamps, kf_tcw)

    # Per-frame tracking time + device-memory artifacts (reference:
    # examples/replica_rgbd.cpp:164-172 TrackingTime.txt, :235-249
    # GpuPeakUsageMB.txt).
    track_times = getattr(tracker, "track_times", [])
    if track_times:
        (out / "TrackingTime.txt").write_text(
            "\n".join(f"{t:.6f}" for t in track_times) + "\n")
    mem = device_memory_stats(mapper.device)
    peak = mem.get("peak_bytes_in_use") or mem.get("bytes_in_use")
    (out / "GpuPeakUsageMB.txt").write_text(
        f"{(peak or 0) / (1 << 20):.1f}\n")
    (out / "run_summary.json").write_text(json.dumps({
        "wall_seconds": wall,
        "frontend": frontend,
        "iterations": mapper.trainer.iteration,
        "iters_per_sec": mapper.trainer.iteration / max(wall, 1e-9),
        "num_keyframes": len(mapper.scene.keyframes),
        "num_gaussians": mapper.trainer.metrics.num_live,
        "ema_loss": mapper.trainer.ema_loss,
        "ate_rmse": ate,
        "loops_closed": getattr(tracker, "num_loops_closed", 0),
        "imu_initialized": getattr(tracker, "imu_initialized", None),
        "scale_refinements": getattr(tracker, "num_scale_refinements",
                                     None),
        "mean_tracking_ms": (1000.0 * float(np.mean(track_times))
                             if track_times else None),
        "device_memory": mem,
        "device": str(mapper.device),
    }, indent=2))
    print(f"[online_slam] {mapper.trainer.iteration} iters, "
          f"{len(mapper.scene.keyframes)} kfs, "
          f"{mapper.trainer.metrics.num_live} gaussians, "
          f"ate={ate}, {wall:.1f}s on {mapper.device} -> {out}")
    if not mapper.scene.keyframes:
        # Tracking produced nothing: a failure, not an empty "successful"
        # run (the feature frontends need trackable texture; --frontend gt
        # always works on GT-pose datasets).
        raise SystemExit(
            "[online_slam] ERROR: no keyframes were produced; tracking "
            f"failed on every frame (frontend={frontend}). Check image "
            "texture/resolution or rerun with --frontend gt.")
    return mapper


def cli_device(name: str) -> torch.device:
    """The device of a --device option: raises when cuda is asked for and
    there is no card, and keeps the card's float32 products full
    precision."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu to map on the CPU)")
    # The renderer's float32 products stay full precision on the card.
    torch.backends.cuda.matmul.allow_tf32 = False
    return device


def _common_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", required=True, help="sequence directory")
    ap.add_argument("--out", required=True)
    ap.add_argument("--cfg", default=None, help="gaussian_mapper yaml")
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--keyframe-every", type=int, default=10)
    ap.add_argument("--frontend", choices=("slam", "vo", "gt"),
                    default="slam",
                    help="tracking stack: full feature SLAM (default), "
                         "plain ORB+PnP odometry, or ground-truth poses")
    ap.add_argument("--viewer", action="store_true",
                    help="serve the live web viewer during the run")
    ap.add_argument("--viewer-port", type=int, default=8090,
                    help="the viewer's port (0 picks a free one)")
    ap.add_argument("--batch", type=int, default=1,
                    help="keyframes per optimization step (multi-view "
                         "batched training when > 1)")
    ap.add_argument("--imu", action="store_true",
                    help="visual-inertial tracking (slam frontend; needs "
                         "the dataset's IMU channel)")
    ap.add_argument("--async-mapping", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="run the SLAM frontend's local mapping (cull, "
                         "local BA, loop verification) on its own thread, "
                         "the reference's LocalMapping-thread architecture "
                         "(ORB-SLAM3/src/System.cc:194-213)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to map and extract ORB on "
                         "(default: cuda)")
    return ap


def _run(args, ds, sensor, app):
    cfg = load_reference_yaml(args.cfg) if args.cfg else dataset_config(app)
    return run_online(ds, sensor, cfg, args.out,
                      keyframe_every=args.keyframe_every,
                      max_iterations=args.iters, frontend=args.frontend,
                      viewer=args.viewer, viewer_port=args.viewer_port,
                      batch=args.batch,
                      async_mapping=args.async_mapping, use_imu=args.imu,
                      device=cli_device(args.device))


def replica_rgbd(argv=None):
    from photo_slam_tpu_torch.io.datasets import ReplicaDataset
    args = _common_parser().parse_args(argv)
    return _run(args, ReplicaDataset(args.data), SensorType.RGBD,
                "replica_rgbd")


def replica_mono(argv=None):
    from photo_slam_tpu_torch.io.datasets import ReplicaDataset
    args = _common_parser().parse_args(argv)
    # Monocular: the feature frontends triangulate (the GT tracker seeds
    # sparse keypoints from GT depth instead), the mapper runs the
    # monocular densification path.
    ds = ReplicaDataset(args.data, load_depth_maps=(args.frontend == "gt"))
    return _run(args, ds, SensorType.MONOCULAR, "replica_mono")


def _tum_camera(args) -> Camera:
    return Camera(camera_id=0, model_id=PINHOLE, width=args.width,
                  height=args.height, fx=args.fx, fy=args.fy, cx=args.cx,
                  cy=args.cy)


def _tum_parser(fx, fy, cx, cy):
    ap = _common_parser()
    ap.add_argument("--fx", type=float, default=fx)
    ap.add_argument("--fy", type=float, default=fy)
    ap.add_argument("--cx", type=float, default=cx)
    ap.add_argument("--cy", type=float, default=cy)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    return ap


def tum_rgbd(argv=None):
    from photo_slam_tpu_torch.io.datasets import TumDataset
    args = _tum_parser(517.3, 516.5, 318.6, 255.3).parse_args(argv)
    return _run(args, TumDataset(args.data, _tum_camera(args)),
                SensorType.RGBD, "tum_rgbd")


def tum_mono(argv=None):
    from photo_slam_tpu_torch.io.datasets import TumDataset
    args = _tum_parser(535.4, 539.2, 320.1, 247.6).parse_args(argv)
    # Monocular: depth maps (when present) only seed sparse keypoints, the
    # mapper runs the monocular neighbor-depth densification path.
    ds = TumDataset(args.data, _tum_camera(args),
                    with_depth=(args.frontend == "gt"))
    return _run(args, ds, SensorType.MONOCULAR, "tum_mono")


def euroc_stereo(argv=None):
    from photo_slam_tpu_torch.io.datasets import EurocDataset
    ap = _common_parser()
    ap.add_argument("--bf", type=float, default=47.9)  # baseline * fx
    args = ap.parse_args(argv)
    # Fallback intrinsics only: with sensor.yaml calibration present the
    # loader rectifies and derives the camera itself.
    cam = Camera(camera_id=0, model_id=PINHOLE, width=752, height=480,
                 fx=458.654, fy=457.296, cx=367.215, cy=248.375,
                 stereo_bf=args.bf)
    return _run(args, EurocDataset(args.data, cam), SensorType.STEREO,
                "euroc_stereo")


APPS = {"replica_rgbd": replica_rgbd, "replica_mono": replica_mono,
        "tum_rgbd": tum_rgbd, "tum_mono": tum_mono,
        "euroc_stereo": euroc_stereo}


if __name__ == "__main__":
    import sys

    APPS[sys.argv[1] if len(sys.argv) > 1 else "replica_rgbd"](sys.argv[2:])
