"""The SLAM frontend alone on tools/synth_euroc.py's stereo-inertial
sequence: ATE and the inertial initialization without the mapper.

Renders the sequence (or loads a EuRoC tree with --data), runs
`SlamFrontend(sensor="stereo")` over it with the IMU unless --no-imu and
async local mapping unless --sync, and prints one JSON line: frames
tracked, keyframes, map points, ATE RMSE against the ground truth after the
similarity alignment, ScaleRefinement ops, the gravity error, and the
tracking time per frame by stage. With --opencv (needs cv2) OpenCV's ORB,
solvePnPRansac and StereoSGBM take the port's places, as the JAX package
calls them; --without-photograph renders the world with the pink-noise
atlas alone, as machines without the photograph did before it was kept
beside tools/synth_replica.py.

Usage:
  python -m photo_slam_tpu_torch.tools.track_euroc [--frames 120] \
      [--data <EuRoC tree>] [--no-imu] [--sync] [--opencv] \
      [--without-photograph] [--device cuda]
"""
from __future__ import annotations

import argparse
import functools
import json

import numpy as np

from photo_slam_tpu_torch.tools import synth_euroc, synth_replica
from photo_slam_tpu_torch.utils.evaluate import ate_rmse
from photo_slam_tpu_torch.utils.math import se3_inverse, se3_matrix


def use_opencv():
    """OpenCV's ORB, solvePnPRansac and StereoSGBM in the port's places."""
    import cv2

    from photo_slam_tpu_torch.ops import stereo
    from photo_slam_tpu_torch.tracking import vision

    def orb(gray, nfeatures, device):
        kps, desc = cv2.ORB_create(nfeatures=nfeatures).detectAndCompute(
            gray, None)
        return vision.OrbFeatures(
            np.array([k.pt for k in kps], np.float32).reshape(-1, 2),
            desc if desc is not None else np.zeros((0, 32), np.uint8),
            np.array([k.response for k in kps], np.float32),
            np.array([k.angle for k in kps], np.float32),
            np.array([k.octave for k in kps], np.int32))

    def pnp(obj, img, K, rvec0=None, tvec0=None, use_guess=False,
            reproj_err=8.0, iters=100):
        kw = dict(reprojectionError=reproj_err, iterationsCount=iters,
                  flags=cv2.SOLVEPNP_ITERATIVE)
        if use_guess:
            kw.update(rvec=rvec0.copy(), tvec=tvec0.copy(),
                      useExtrinsicGuess=True)
        return cv2.solvePnPRansac(obj, img, K, None, **kw)

    vision.orb_detect_and_compute = orb
    vision.solve_pnp_ransac = pnp
    stereo.disparity_u8 = lambda left, right, device: cv2.StereoSGBM_create(
        0, 128, 5).compute(left, right).astype(np.float32) / 16.0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--data", default=None,
                    help="a EuRoC tree to load instead of rendering")
    ap.add_argument("--no-imu", action="store_true")
    ap.add_argument("--sync", action="store_true",
                    help="local mapping on the tracking thread")
    ap.add_argument("--opencv", action="store_true")
    ap.add_argument("--without-photograph", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from photo_slam_tpu_torch.apps.online_slam import cli_device
    from photo_slam_tpu_torch.tracking.frontend import SlamFrontend
    from photo_slam_tpu_torch.tracking.imu import so3_log

    dev = cli_device(args.device)
    if args.opencv:
        use_opencv()
    if args.data:
        from photo_slam_tpu_torch.io.datasets import EurocDataset
        seq = EurocDataset(args.data, max_frames=args.frames)
    else:
        if args.without_photograph:
            synth_replica.photo_atlas = functools.partial(
                synth_replica.photo_atlas, photo=None)
        seq = synth_euroc.SynthEuroc(args.frames, device=dev)
    frames = list(seq.frames())
    fe = SlamFrontend(seq.camera, sensor="stereo", num_features=1000,
                      async_local_mapping=not args.sync,
                      use_imu=not args.no_imu, imu_calib=seq.imu_calib,
                      device=dev)
    ops = []
    fe.run(iter(frames), ops.append)
    gt = [se3_matrix(f.quat_wxyz, f.trans) for f in frames]
    est = np.stack([se3_inverse(T)[:3, 3] for T in fe.trajectory])
    ref = np.stack([se3_inverse(T)[:3, 3] for T in gt])
    refine = [o for o in ops if o.kind.name == "SCALE_REFINEMENT"]
    R = np.eye(3)
    for o in refine:
        R = np.asarray(o.transform, np.float64)[:3, :3] @ R
    down = np.array([0.0, 0.0, -1.0])
    cos = float(np.dot(R.T @ down, gt[0][:3, :3] @ down))
    ms = {k: float(1e3 * np.mean(v)) if v else None
          for k, v in fe.stage_times.items()}
    print(json.dumps({
        "frames": len(frames), "tracked": fe.tracked_frames,
        "relocalizations": fe.num_relocalizations,
        "sub_maps": len(fe._old_maps), "keyframes": len(fe.map.keyframes),
        "map_points": fe.map.num_points, "ate_rmse": float(ate_rmse(est, ref)),
        "imu_initialized": fe.imu_initialized,
        "scale_refinements": [float(o.scale) for o in refine],
        "refinement_rotation_deg": [float(np.degrees(np.linalg.norm(
            so3_log(np.asarray(o.transform, np.float64)[:3, :3]))))
            for o in refine],
        "gravity_error_deg": float(np.degrees(np.arccos(min(1.0, cos)))),
        "tracking_ms": float(1e3 * np.mean(fe.track_times)),
        "stage_ms": ms, "device": str(dev),
        "options": {k: v for k, v in vars(args).items()}}))


if __name__ == "__main__":
    main()
