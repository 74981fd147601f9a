"""A synthetic EuRoC-format stereo-inertial sequence, rendered by the port.

Counterpart of tools/gen_synth_euroc.py: the cylinder room of
tools/synth_replica.py (`cylinder_world`) and its out-and-back pan, seen
by TWO cameras 0.11 m apart along cam0's x axis (ideal pinholes, 752x480,
20 Hz), each frame with the sensor model of bench.py::corrupt_frame and
independent shot noise per eye (seeds 99 and 199), converted to 8-bit
gray, plus an analytically exact 200 Hz IMU (body == cam0) and the
ground-truth body poses. Frames render through the port's own `render` on
the given device.

`SynthEuroc` holds the sequence in host memory: `frames()` serves it as
io/datasets.EurocDataset serves a sequence (three equal gray channels,
the right image, timestamps, each frame's IMU span, ground truth), and
`write(out_dir)` writes the mav0/ tree the loader reads, through the
port's PNG writer (no image library needed):

  mav0/cam0/{data.csv, sensor.yaml, data/<ts>.png}   (left, grayscale)
  mav0/cam1/{data.csv, sensor.yaml, data/<ts>.png}   (right)
  mav0/imu0/{data.csv, sensor.yaml}                  (200 Hz, exact)
  mav0/state_groundtruth_estimate0/data.csv          (T_WB body poses)

Usage:
  python -m photo_slam_tpu_torch.tools.synth_euroc <out_dir> \
      [--frames 120] [--clean] [--device cuda]
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from photo_slam_tpu_torch.io.datasets import imu_span
from photo_slam_tpu_torch.io.images import write_png
from photo_slam_tpu_torch.models.camera import PINHOLE, Camera
from photo_slam_tpu_torch.ops.camera_math import build_camera_matrices
from photo_slam_tpu_torch.ops.render import (RenderSettings, principal_for,
                                             render)
from photo_slam_tpu_torch.tools.synth_replica import (N_SPLATS,
                                                      corrupt_frame,
                                                      cylinder_depth,
                                                      cylinder_world)
from photo_slam_tpu_torch.tracking.gt_tracker import Frame
from photo_slam_tpu_torch.tracking.imu import GRAVITY, ImuCalib, so3_log
from photo_slam_tpu_torch.utils.math import rotmat_to_quat_numpy

WIDTH, HEIGHT = 752, 480
FX = FY = 458.0
CX, CY = 376.0, 240.0  # centered principal (ideal synthetic pinholes)
BASELINE = 0.11  # meters, cam1 at +x of cam0 (EuRoC-like)
T0_NS = 1_400_000_000_000_000_000  # EuRoC-era epoch
DT_NS = 50_000_000  # 20 Hz
IMU_HZ = 200.0
LEFT_SEED, RIGHT_SEED = 99, 199
IMU_NOISE = dict(noise_gyro=1.6968e-4, walk_gyro=1.9393e-5,
                 noise_acc=2.0e-3, walk_acc=3.0e-3)


def sensor_yaml(t_bs: np.ndarray, width: int = WIDTH, height: int = HEIGHT,
                fx: float = FX, fy: float = FY) -> str:
    rows = ", ".join(f"{v:.9f}" for v in t_bs.reshape(-1))
    return (
        "sensor_type: camera\n"
        "T_BS:\n"
        "  cols: 4\n"
        "  rows: 4\n"
        f"  data: [{rows}]\n"
        "rate_hz: 20\n"
        f"resolution: [{width}, {height}]\n"
        "camera_model: pinhole\n"
        f"intrinsics: [{fx}, {fy}, {width / 2}, {height / 2}]\n"
        "distortion_model: radial-tangential\n"
        "distortion_coefficients: [0.0, 0.0, 0.0, 0.0]\n"
    )


def imu_yaml() -> str:
    rows = ", ".join(f"{v:.1f}" for v in np.eye(4).reshape(-1))
    return (
        "sensor_type: imu\n"
        "T_BS:\n"
        "  cols: 4\n"
        "  rows: 4\n"
        f"  data: [{rows}]\n"
        "rate_hz: 200\n"
        "gyroscope_noise_density: 1.6968e-04\n"
        "gyroscope_random_walk: 1.9393e-05\n"
        "accelerometer_noise_density: 2.0000e-3\n"
        "accelerometer_random_walk: 3.0000e-3\n"
    )


def trajectory(num: int, yaw_max: float = 1.1):
    """Continuous-time out-and-back trajectory (t in seconds; the 20 Hz
    frames sample it at t = i/20). Returns pose_of_time(t) -> (R_cw, c_w)."""
    half = max(num // 2, 1)

    def pose_of_time(t: float):
        x = t * 20.0
        f = x / half
        yaw = yaw_max * (f if x < half else max(2.0 - f, 0.0))
        cy_, sy_ = np.cos(yaw), np.sin(yaw)
        R = np.array([[cy_, 0, -sy_], [0, 1, 0], [sy_, 0, cy_]])
        c = np.array([0.25 * np.sin(2 * np.pi * x / num),
                      0.05 * np.sin(4 * np.pi * x / num),
                      0.25 * np.cos(2 * np.pi * x / num) - 0.25])
        return R, c

    return pose_of_time


def imu_samples(t_end: float, pose_of_time):
    """(stamps_ns [M] int64, gyro [M, 3], acc [M, 3]) at 200 Hz from 0 to
    t_end seconds, exact for the first-order preintegrator: each sample
    holds over [t, t + 1/hz], so it is the MIDPOINT angular rate (central
    difference on SO(3)) and the midpoint specific force expressed in the
    START orientation, R_wb(t)^T (a_w(mid) - g_w)."""
    g_w = np.array([0.0, 0.0, -GRAVITY])
    h = 1e-4
    stamps, gyros, accs = [], [], []
    k = 0
    while k / IMU_HZ <= t_end + 1e-9:
        t = k / IMU_HZ
        tm = t + 0.5 / IMU_HZ
        R0, _ = pose_of_time(t)
        Rm, cm = pose_of_time(tm - h)
        _, cc = pose_of_time(tm)
        Rp, cp = pose_of_time(tm + h)
        # R_wb(tm-h)^T R_wb(tm+h) = R(tm-h) R(tm+h)^T over 2h (central).
        gyros.append(so3_log(Rm @ Rp.T) / (2.0 * h))
        accs.append(R0 @ ((cm - 2.0 * cc + cp) / (h * h) - g_w))
        stamps.append(T0_NS + int(round(t * 1e9)))
        k += 1
    return np.array(stamps, np.int64), np.array(gyros), np.array(accs)


def write_imu(mav, num: int, pose_of_time) -> None:
    """mav0/imu0/{sensor.yaml, data.csv}: the 200 Hz exact IMU stream."""
    d = Path(mav) / "imu0"
    d.mkdir(parents=True, exist_ok=True)
    (d / "sensor.yaml").write_text(imu_yaml())
    lines = ["#timestamp [ns],w_RS_S_x [rad s^-1],w_RS_S_y [rad s^-1],"
             "w_RS_S_z [rad s^-1],a_RS_S_x [m s^-2],a_RS_S_y [m s^-2],"
             "a_RS_S_z [m s^-2]"]
    for ts, w, a in zip(*imu_samples((num - 1) / 20.0, pose_of_time)):
        lines.append(f"{ts},{w[0]:.9f},{w[1]:.9f},{w[2]:.9f},"
                     f"{a[0]:.9f},{a[1]:.9f},{a[2]:.9f}")
    (d / "data.csv").write_text("\n".join(lines) + "\n")


def to_gray_u8(chw: np.ndarray) -> np.ndarray:
    """[3, H, W] float RGB -> [H, W] uint8 gray (the JAX tool's weights,
    truncated)."""
    gray = 0.299 * chw[0] + 0.587 * chw[1] + 0.114 * chw[2]
    return (np.clip(gray, 0, 1) * 255).astype(np.uint8)


class SynthEuroc:
    """The sequence in host memory: `num_frames` stereo pairs rendered on
    `device` (uint8 gray `left`, `right`), cam0's analytic depth, the
    ground-truth body poses and the exact IMU stream. `width` and `height`
    shrink the cameras for tests (the focal length scales with the
    width)."""

    def __init__(self, num_frames: int = 120, width: int = WIDTH,
                 height: int = HEIGHT, *, device, n_splats: int = N_SPLATS,
                 clean: bool = False):
        device = torch.device(device)
        self.num_frames = num_frames
        self.width, self.height = width, height
        self.fx = self.fy = FX * width / WIDTH
        self.camera = Camera(camera_id=0, model_id=PINHOLE, width=width,
                             height=height, fx=self.fx, fy=self.fy,
                             cx=width / 2, cy=height / 2,
                             stereo_bf=self.fx * BASELINE)
        self.imu_calib = ImuCalib(Tbc=np.eye(4), freq=IMU_HZ, **IMU_NOISE)
        cam = self.camera
        pts, scales, quats, opac, cols = (
            torch.from_numpy(x).to(device) for x in cylinder_world(n_splats))
        settings = RenderSettings(
            width=width, height=height,
            tan_fovx=float(np.tan(cam.fovx / 2)),
            tan_fovy=float(np.tan(cam.fovy / 2)),
            principal=principal_for(cam, width, height),
            max_per_tile=1024, max_tiles_per_gaussian=8, mode="pallas")

        def render_gray(R, c_w, rng, i):
            mats = build_camera_matrices(R, -R @ c_w, 0.01, 100.0, cam.fovx,
                                         cam.fovy, device=device)
            with torch.no_grad():
                chw = render(pts, scales, quats, opac, mats, settings,
                             torch.zeros(3, device=device),
                             colors_precomp=cols).image.cpu().numpy()
            if not clean:
                chw = corrupt_frame(chw, i, rng)
            return to_gray_u8(chw)

        self.pose_of_time = trajectory(num_frames)
        rng_l = np.random.RandomState(LEFT_SEED)
        rng_r = np.random.RandomState(RIGHT_SEED)
        self.stamps_ns = [T0_NS + i * DT_NS for i in range(num_frames)]
        self.left, self.right, self.T_WB = [], [], []
        for i in range(num_frames):
            R, c_w0 = self.pose_of_time(i / 20.0)
            # cam1 center: offset along cam0's +x axis expressed in world.
            c_w1 = c_w0 + R.T @ np.array([BASELINE, 0.0, 0.0])
            self.left.append(render_gray(R, c_w0, rng_l, i))
            self.right.append(render_gray(R, c_w1, rng_r, i))
            T = np.eye(4)
            T[:3, :3], T[:3, 3] = R.T, c_w0  # body == cam0
            self.T_WB.append(T)
        self.imu = imu_samples((num_frames - 1) / 20.0, self.pose_of_time)

    def __len__(self):
        return self.num_frames

    def depth(self, i: int) -> np.ndarray:
        """cam0's analytic z-depth [H, W] at frame i."""
        R, c_w = self.pose_of_time(i / 20.0)
        return cylinder_depth(self.camera, R, c_w)

    def frames(self):
        """Frames as EurocDataset yields them for this sequence (its
        rectification is the identity: ideal pinholes, a pure x
        baseline)."""
        stamps_s, prev_t = self.imu[0] * 1e-9, None
        for i, ts in enumerate(self.stamps_ns):
            t = ts * 1e-9
            imu = imu_span(stamps_s, self.imu[2], self.imu[1], prev_t, t,
                           IMU_HZ)
            prev_t = t
            tcw = np.linalg.inv(self.T_WB[i])
            yield Frame(
                image=np.repeat(self.left[i][None], 3, 0).astype(
                    np.float32) / 255.0,
                quat_wxyz=rotmat_to_quat_numpy(tcw[:3, :3]),
                trans=tcw[:3, 3], depth=None,
                right=np.repeat(self.right[i][None], 3, 0).astype(
                    np.float32) / 255.0,
                filename=f"{ts}.png", timestamp=t, imu=imu)

    def write(self, out_dir) -> Path:
        """The EuRoC mav0/ tree under out_dir, images as 8-bit gray PNG."""
        out = Path(out_dir)
        mav = out / "mav0"
        t_bs1 = np.eye(4)
        t_bs1[0, 3] = BASELINE
        cam_csv = ["#timestamp [ns],filename"]
        for name, t_bs, images in (("cam0", np.eye(4), self.left),
                                   ("cam1", t_bs1, self.right)):
            (mav / name / "data").mkdir(parents=True, exist_ok=True)
            (mav / name / "sensor.yaml").write_text(sensor_yaml(
                t_bs, self.width, self.height, self.fx, self.fy))
            for ts, img in zip(self.stamps_ns, images):
                write_png(mav / name / "data" / f"{ts}.png", img)
        cam_csv += [f"{ts},{ts}.png" for ts in self.stamps_ns]
        for name in ("cam0", "cam1"):
            (mav / name / "data.csv").write_text("\n".join(cam_csv) + "\n")
        write_imu(mav, self.num_frames, self.pose_of_time)
        gt_csv = ["#timestamp, p_RS_R_x [m], p_RS_R_y [m], p_RS_R_z [m], "
                  "q_RS_w [], q_RS_x [], q_RS_y [], q_RS_z []"]
        for ts, T in zip(self.stamps_ns, self.T_WB):
            q, c = rotmat_to_quat_numpy(T[:3, :3]), T[:3, 3]
            gt_csv.append(f"{ts},{c[0]:.9f},{c[1]:.9f},{c[2]:.9f},"
                          f"{q[0]:.9f},{q[1]:.9f},{q[2]:.9f},{q[3]:.9f}")
        gt = mav / "state_groundtruth_estimate0"
        gt.mkdir(parents=True, exist_ok=True)
        (gt / "data.csv").write_text("\n".join(gt_csv) + "\n")
        return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--clean", action="store_true",
                    help="the raw renders, without the sensor model")
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default: cuda)")
    args = ap.parse_args(argv)
    from photo_slam_tpu_torch.apps.online_slam import cli_device

    seq = SynthEuroc(args.frames, device=cli_device(args.device),
                     clean=args.clean)
    print(f"wrote {len(seq)} stereo pairs -> {seq.write(args.out)}")


if __name__ == "__main__":
    main()
