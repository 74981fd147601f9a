"""Dataset loaders: Replica, TUM RGB-D, EuRoC stereo.

Counterpart of photo_slam_tpu/io/datasets.py (numpy only; reference:
examples/replica_rgbd.cpp:43-110 LoadImages, examples/tum_rgbd.cpp
association parsing, examples/euroc_stereo.cpp timestamp lists) with
ground-truth trajectory loading, so the GT-pose tracker drives the mapper
without a live feature tracker. Loaders yield `tracking.gt_tracker.Frame`
objects lazily: images are read on demand, on the tracker's thread. The
EuRoC loader's rectification goes through tracking/vision.py (OpenCV's
stereoRectify, initUndistortRectifyMap and remap, owned by the port) and
its images through io/images.py, so it needs neither cv2 nor PIL.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

from photo_slam_tpu_torch.io.images import load_depth, load_image_chw
from photo_slam_tpu_torch.models.camera import PINHOLE, Camera
from photo_slam_tpu_torch.tracking import vision
from photo_slam_tpu_torch.tracking.gt_tracker import Frame
from photo_slam_tpu_torch.tracking.imu import ImuCalib
from photo_slam_tpu_torch.utils.math import (quat_to_rotmat_numpy,
                                             rotmat_to_quat_numpy,
                                             se3_inverse)


@dataclass
class SequenceInfo:
    camera: Camera
    num_frames: int
    depth_scale: float = 1.0


# ---------------------------------------------------------------------------
# Replica (as packaged for Photo-SLAM: <seq>/results/frame*.jpg depth*.png,
# <seq>/traj.txt with per-frame 4x4 row-major camera-to-world)
# ---------------------------------------------------------------------------

REPLICA_DEPTH_SCALE = 6553.5  # cfg/ORB_SLAM3/RGB-D/Replica/*.yaml DepthMapFactor
REPLICA_CAMERA = dict(fx=600.0, fy=600.0, cx=599.5, cy=339.5,
                      width=1200, height=680)


class ReplicaDataset:
    def __init__(self, seq_dir, camera_id: int = 0, load_depth_maps=True):
        self.seq_dir = Path(seq_dir)
        results = self.seq_dir / "results"
        if not results.is_dir():
            raise FileNotFoundError(
                f"not a Replica sequence: {results} does not exist "
                f"(expected <seq>/results/frame*, depth*)")
        self.rgb_files = sorted(results.glob("frame*"))
        self.depth_files = sorted(results.glob("depth*"))
        if not self.rgb_files:
            raise FileNotFoundError(f"no frame* images under {results}")
        self.load_depth_maps = load_depth_maps
        self.poses = self._load_traj(self.seq_dir / "traj.txt")
        # Replica ships 1200x680; scale the intrinsics if the sequence was
        # resized (half-res exports, synthetic mini-sequences) instead of
        # silently sampling outside the actual images.
        cam = dict(REPLICA_CAMERA)
        probe = load_image_chw(self.rgb_files[0])
        h, w = probe.shape[1], probe.shape[2]
        if (w, h) != (cam["width"], cam["height"]):
            sx = w / cam["width"]
            sy = h / cam["height"]
            cam.update(width=w, height=h, fx=cam["fx"] * sx,
                       fy=cam["fy"] * sy,
                       cx=(cam["cx"] + 0.5) * sx - 0.5,
                       cy=(cam["cy"] + 0.5) * sy - 0.5)
        self.camera = Camera(camera_id=camera_id, model_id=PINHOLE, **cam)

    @staticmethod
    def _load_traj(path) -> Optional[np.ndarray]:
        """traj.txt: one 4x4 row-major camera-to-world matrix per line."""
        if not Path(path).exists():
            return None
        rows = np.loadtxt(path)
        return rows.reshape(-1, 4, 4)

    def __len__(self):
        return len(self.rgb_files)

    def frames(self) -> Iterator[Frame]:
        for i, rgb_path in enumerate(self.rgb_files):
            img = load_image_chw(rgb_path)
            depth = None
            if self.load_depth_maps and i < len(self.depth_files):
                depth = load_depth(self.depth_files[i], REPLICA_DEPTH_SCALE)
            quat, trans = np.array([1.0, 0, 0, 0]), np.zeros(3)
            if self.poses is not None:
                c2w = self.poses[i]
                w2c = np.linalg.inv(c2w)
                quat = rotmat_to_quat_numpy(w2c[:3, :3])
                trans = w2c[:3, 3]
            yield Frame(image=img, quat_wxyz=quat, trans=trans, depth=depth,
                        filename=rgb_path.name)


# ---------------------------------------------------------------------------
# TUM RGB-D (rgb.txt / depth.txt / groundtruth.txt, optional associations)
# ---------------------------------------------------------------------------

TUM_DEPTH_SCALE = 5000.0


def _read_tum_list(path):
    entries = []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        entries.append((float(parts[0]), parts[1:]))
    return entries


def _associate(a, b, max_dt=0.02):
    """Greedy nearest-timestamp association (the role of the reference's
    associate.py, ORB-SLAM3/evaluation)."""
    out = []
    bi = 0
    for ta, va in a:
        while bi + 1 < len(b) and abs(b[bi + 1][0] - ta) <= abs(b[bi][0] - ta):
            bi += 1
        if abs(b[bi][0] - ta) <= max_dt:
            out.append((ta, va, b[bi][0], b[bi][1]))
    return out


class TumDataset:
    def __init__(self, seq_dir, camera: Camera, camera_id: int = 0,
                 with_depth=True):
        self.seq_dir = Path(seq_dir)
        self.camera = camera
        if not (self.seq_dir / "rgb.txt").exists():
            raise FileNotFoundError(
                f"not a TUM sequence: {self.seq_dir}/rgb.txt missing")
        rgb = _read_tum_list(self.seq_dir / "rgb.txt")
        self.with_depth = with_depth and (self.seq_dir / "depth.txt").exists()
        if self.with_depth:
            depth = _read_tum_list(self.seq_dir / "depth.txt")
            self.assoc = _associate(rgb, depth)
        else:
            self.assoc = [(t, v, t, None) for t, v in rgb]
        gt_path = self.seq_dir / "groundtruth.txt"
        self.gt = _read_tum_list(gt_path) if gt_path.exists() else None

    def __len__(self):
        return len(self.assoc)

    def _pose_at(self, t):
        """Nearest GT pose: tx ty tz qx qy qz qw (camera-to-world)."""
        if not self.gt:
            return np.array([1.0, 0, 0, 0]), np.zeros(3)
        times = np.array([g[0] for g in self.gt])
        i = int(np.argmin(np.abs(times - t)))
        vals = [float(x) for x in self.gt[i][1]]
        t_wc = np.array(vals[0:3])
        qx, qy, qz, qw = vals[3:7]
        R_wc = quat_to_rotmat_numpy(np.array([qw, qx, qy, qz]))
        Twc = np.eye(4)
        Twc[:3, :3] = R_wc
        Twc[:3, 3] = t_wc
        Tcw = se3_inverse(Twc)
        return (rotmat_to_quat_numpy(Tcw[:3, :3]),
                Tcw[:3, 3])

    def frames(self) -> Iterator[Frame]:
        for t_rgb, rgb_v, t_d, d_v in self.assoc:
            img = load_image_chw(self.seq_dir / rgb_v[0])
            depth = (load_depth(self.seq_dir / d_v[0], TUM_DEPTH_SCALE)
                     if d_v is not None else None)
            quat, trans = self._pose_at(t_rgb)
            yield Frame(image=img, quat_wxyz=quat, trans=trans, depth=depth,
                        filename=Path(rgb_v[0]).name)


# ---------------------------------------------------------------------------
# EuRoC stereo (mav0/cam0, mav0/cam1 + data.csv timestamps, sensor.yaml
# calibration, state_groundtruth_estimate0 trajectory)
# ---------------------------------------------------------------------------


def _parse_euroc_sensor_yaml(path):
    """Parse the fields we need from a EuRoC sensor.yaml without a YAML
    dependency: T_BS (4x4 sensor-to-body), intrinsics [fu fv cu cv],
    distortion_coefficients, resolution."""
    text = Path(path).read_text()

    def grab_list(key):
        m = re.search(key + r":.*?\[(.*?)\]", text, re.S)
        if m is None:
            return None
        return [float(x) for x in m.group(1).replace("\n", " ").split(",")]

    t_bs = grab_list(r"T_BS:\s*\n.*?data")
    intr = grab_list("intrinsics")
    dist = grab_list("distortion_coefficients")
    res = grab_list("resolution")
    out = {}
    if t_bs and len(t_bs) == 16:
        out["T_BS"] = np.array(t_bs).reshape(4, 4)
    if intr:
        out["intrinsics"] = intr
    if dist:
        out["distortion"] = dist
    if res:
        out["resolution"] = [int(r) for r in res]
    return out


def _read_csv_rows(path, ncols: int) -> Optional[np.ndarray]:
    """The first `ncols` numbers of each data row of a EuRoC csv."""
    rows = []
    for line in Path(path).read_text().splitlines():
        if line.startswith("#") or not line.strip():
            continue
        vals = [float(v) for v in line.strip().split(",")[:ncols]]
        if len(vals) == ncols:
            rows.append(vals)
    return np.array(rows) if rows else None


def imu_span(stamps, acc, gyro, prev_t, t, freq):
    """The IMU measurements of a frame at t seconds after one at prev_t:
    (stamps, acc, gyro) over (prev_t - half a sample, t], None for the
    first frame or an empty span. The frontend's integrate_span clips them
    to the exact frame boundaries: the per-frame vImuMeas the reference
    mains hand to TrackStereo/TrackMonocular (mono_inertial_euroc.cc)."""
    if prev_t is None:
        return None
    i0 = int(np.searchsorted(stamps, prev_t - 0.5 / max(freq, 1.0)))
    i1 = int(np.searchsorted(stamps, t, "right"))
    return (stamps[i0:i1], acc[i0:i1], gyro[i0:i1]) if i1 > i0 else None


class EurocDataset:
    """EuRoC MAV stereo loader with calibrated rectification and GT poses.

    The reference feeds raw EuRoC pairs to ORB-SLAM3, which rectifies
    internally from the settings yaml (reference: examples/euroc_stereo.cpp +
    ORB-SLAM3 Settings.cc rectification); here rectification happens in the
    loader (stereo_rectify from the two sensor.yaml calibrations) so every
    consumer — the SLAM frontend's SGM disparity, the mapper's stereo
    densify — sees rectified pinhole images. Ground truth comes from
    mav0/state_groundtruth_estimate0/data.csv (body poses T_WB), converted
    to rectified-cam0 world->camera transforms via T_BS and the rectifying
    rotation R1. The mav0/imu0 channel, when present, gives `imu_calib`
    (Tbc from rectified cam0 to the IMU body) and each frame's span of
    measurements since the previous one.
    """

    def __init__(self, seq_dir, camera: Optional[Camera] = None,
                 camera_id: int = 0, max_frames: Optional[int] = None):
        self.seq_dir = Path(seq_dir)
        mav = self.seq_dir / "mav0"
        self.left = self._read_cam(mav / "cam0")
        self.right = self._read_cam(mav / "cam1")
        self.max_frames = max_frames
        self._maps = None
        self.R1 = np.eye(3)
        self.T_BC0 = np.eye(4)

        def calib(name):
            path = mav / name / "sensor.yaml"
            return _parse_euroc_sensor_yaml(path) if path.exists() else {}

        cal0, cal1 = calib("cam0"), calib("cam1")
        if ("intrinsics" in cal0 and "intrinsics" in cal1
                and "T_BS" in cal0 and "T_BS" in cal1):
            self._setup_rectification(cal0, cal1, camera_id)
        else:
            if camera is None:
                raise FileNotFoundError(
                    f"no sensor.yaml calibration under {mav}/cam*/ and no "
                    f"explicit camera given")
            self.camera = camera

        # IMU channel (mav0/imu0): measurements + body-from-rectified-cam0
        # calibration for the visual-inertial frontend (reference:
        # ORB-SLAM3 mono_inertial_euroc.cc LoadIMU + Tracking's mTbc).
        self.imu_stamps = None      # [M] seconds
        self.imu_gyro = None        # [M,3] rad/s
        self.imu_acc = None         # [M,3] m/s^2
        self.imu_calib = None
        imu_csv = mav / "imu0" / "data.csv"
        if imu_csv.exists():
            arr = _read_csv_rows(imu_csv, 7)
            if arr is not None:
                self.imu_stamps = arr[:, 0] * 1e-9
                self.imu_gyro = arr[:, 1:4]
                self.imu_acc = arr[:, 4:7]
            yaml = mav / "imu0" / "sensor.yaml"
            text = yaml.read_text() if yaml.exists() else ""

            def scalar(key, default):
                m = re.search(key + r":\s*([0-9eE.+-]+)", text)
                return float(m.group(1)) if m else default

            # Tbc maps rectified-cam0 coords to the IMU (body) frame:
            # T_S_imu<-B @ T_B<-C0 @ (rectifying R1)^T.
            T_B_Simu = calib("imu0").get("T_BS", np.eye(4))
            R1h = np.eye(4)
            R1h[:3, :3] = self.R1.T
            self.imu_calib = ImuCalib(
                Tbc=np.linalg.inv(T_B_Simu) @ self.T_BC0 @ R1h,
                noise_gyro=scalar("gyroscope_noise_density", 1.7e-4),
                noise_acc=scalar("accelerometer_noise_density", 2.0e-3),
                walk_gyro=scalar("gyroscope_random_walk", 1.9e-5),
                walk_acc=scalar("accelerometer_random_walk", 3.0e-3),
                freq=scalar("rate_hz", 200.0))

        # Ground truth: body poses in world (p_RS_R, q_RS in w,x,y,z order).
        self.gt_times = None
        self.gt_T_WB = None
        gt_csv = mav / "state_groundtruth_estimate0" / "data.csv"
        arr = _read_csv_rows(gt_csv, 8) if gt_csv.exists() else None
        if arr is not None:
            self.gt_times = arr[:, 0]  # ns
            mats = []
            for r in arr:
                q = np.array([r[4], r[5], r[6], r[7]])  # w x y z
                T = np.eye(4)
                T[:3, :3] = quat_to_rotmat_numpy(q / np.linalg.norm(q))
                T[:3, 3] = r[1:4]
                mats.append(T)
            self.gt_T_WB = np.stack(mats)

    def _setup_rectification(self, cal0, cal1, camera_id):
        fu0, fv0, cu0, cv0_ = cal0["intrinsics"]
        fu1, fv1, cu1, cv1_ = cal1["intrinsics"]
        K0 = np.array([[fu0, 0, cu0], [0, fv0, cv0_], [0, 0, 1]])
        K1 = np.array([[fu1, 0, cu1], [0, fv1, cv1_], [0, 0, 1]])
        D0 = np.array(cal0.get("distortion", [0, 0, 0, 0])[:4])
        D1 = np.array(cal1.get("distortion", [0, 0, 0, 0])[:4])
        w, h = cal0.get("resolution", [752, 480])
        self.T_BC0 = cal0["T_BS"]
        T_BC1 = cal1["T_BS"]
        # cam1 <- cam0 transform: T_C1C0 = inv(T_BC1) @ T_BC0.
        T_10 = np.linalg.inv(T_BC1) @ self.T_BC0
        R1, R2, P1, P2 = vision.stereo_rectify(
            K0, D0, K1, D1, (int(w), int(h)), T_10[:3, :3], T_10[:3, 3])
        self.R1 = R1
        # Kept for diagnostics/tests of the rectification geometry.
        self._T_BC1 = T_BC1
        self._R1dbg, self._R2dbg = R1, R2
        self._P1dbg, self._P2dbg = P1, P2
        self._maps = (
            vision.init_undistort_rectify_map(K0, D0, R1, P1, (w, h)),
            vision.init_undistort_rectify_map(K1, D1, R2, P2, (w, h)))
        baseline = abs(P2[0, 3] / P2[0, 0])
        self.camera = Camera(camera_id=camera_id, model_id=PINHOLE,
                             width=int(w), height=int(h),
                             fx=float(P1[0, 0]), fy=float(P1[1, 1]),
                             cx=float(P1[0, 2]), cy=float(P1[1, 2]),
                             stereo_bf=float(P1[0, 0] * baseline))

    @staticmethod
    def _read_cam(cam_dir):
        csv = cam_dir / "data.csv"
        if not csv.exists():
            raise FileNotFoundError(
                f"not a EuRoC sequence: {csv} missing")
        entries = []
        for line in csv.read_text().splitlines():
            if line.startswith("#") or not line.strip():
                continue
            ts, name = line.strip().split(",")[:2]
            entries.append((int(ts), cam_dir / "data" / name.strip()))
        return entries

    def __len__(self):
        n = min(len(self.left), len(self.right))
        return n if self.max_frames is None else min(n, self.max_frames)

    @staticmethod
    def _rectify(img_chw, maps):
        """Remap a [3, H, W] image; a gray image (three equal channels, as
        the loader reads EuRoC's) is remapped once and repeated."""
        if (img_chw[0] == img_chw[1]).all() and (
                img_chw[1] == img_chw[2]).all():
            out = vision.remap_linear(img_chw[0], maps[0], maps[1])
            return np.repeat(out[None], 3, axis=0)
        hwc = np.transpose(img_chw, (1, 2, 0))
        out = vision.remap_linear(hwc, maps[0], maps[1])
        return np.transpose(out, (2, 0, 1))

    def _pose_at(self, ts_ns):
        """world->rectified-cam0 at the nearest GT timestamp."""
        if self.gt_times is None:
            return None, None
        i = int(np.argmin(np.abs(self.gt_times - ts_ns)))
        if abs(self.gt_times[i] - ts_ns) > 50e6:  # >50ms gap: no GT
            return None, None
        T_WB = self.gt_T_WB[i]
        T_WC = T_WB @ self.T_BC0          # raw cam0 in world
        # Rectified cam frame: X_rect = R1 @ X_cam -> T_WCrect = T_WC @ R1^T.
        T_WCr = T_WC.copy()
        T_WCr[:3, :3] = T_WC[:3, :3] @ self.R1.T
        T_CrW = np.linalg.inv(T_WCr)
        q = rotmat_to_quat_numpy(T_CrW[:3, :3])
        return q, T_CrW[:3, 3]

    def frames(self) -> Iterator[Frame]:
        n = len(self)
        # Pair cam0/cam1 by TIMESTAMP, not list index: EuRoC sequences drop
        # frames on one camera (V2_03 drops ~400 on cam1), and index-zipping
        # would misalign every stereo pair after the first gap.
        right_by_ts = {ts: rp for ts, rp in self.right}
        right_times = np.array(sorted(right_by_ts)) if right_by_ts else None
        count = 0
        prev_t = None
        for ts, lp in self.left:
            if count >= n:
                break
            rp = right_by_ts.get(ts)
            if rp is None and right_times is not None and len(right_times):
                j = int(np.argmin(np.abs(right_times - ts)))
                # Tolerate sub-half-frame jitter (EuRoC is 20 Hz -> 50 ms).
                if abs(int(right_times[j]) - ts) <= 25e6:
                    rp = right_by_ts[int(right_times[j])]
            if rp is None:
                continue  # unmatched left frame: skip, do not misalign
            count += 1
            img = load_image_chw(lp)
            right = load_image_chw(rp)
            if self._maps is not None:
                img = self._rectify(img, self._maps[0])
                right = self._rectify(right, self._maps[1])
            quat, trans = self._pose_at(ts)
            if quat is None:
                quat, trans = np.array([1.0, 0, 0, 0]), np.zeros(3)
            t_sec = ts * 1e-9
            imu = None
            if self.imu_stamps is not None:
                imu = imu_span(self.imu_stamps, self.imu_acc, self.imu_gyro,
                               prev_t, t_sec, self.imu_calib.freq)
            prev_t = t_sec
            yield Frame(image=img, quat_wxyz=quat, trans=trans, depth=None,
                        right=right, filename=lp.name, timestamp=t_sec,
                        imu=imu)
