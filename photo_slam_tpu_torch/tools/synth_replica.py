"""A synthetic Replica-format RGB-D sequence, rendered by the port.

Counterpart of tools/gen_synth_replica.py: a textured splat cylinder room
(60,000 splats, seed 3, full angular coverage) seen by a camera that pans
out and back with a small circular translation, so the return sweep
revisits the start views. Frames render through the port's own `render`
on the given device, at the Replica camera (io/datasets.REPLICA_CAMERA,
1200x680, its intrinsics scaled when another size is asked for, as the
Replica loader scales them); depth is the analytic cylinder intersection.
By default the frames carry the sensor model of bench.py::corrupt_frame
(exposure drift, shot noise, motion blur on every third frame).

`SynthReplica` holds the whole sequence in host memory and is a dataset
for apps/online_slam.run_online (`camera`, `frames()`), so the sequence
needs no image files and no image library.
`write()` writes the Replica layout (results/frame*.jpg, depth*.png,
traj.txt) for the CLI apps; where neither cv2 nor PIL (a JPEG encoder)
imports, the frames are frame*.png, which the loader globs alike.
`write_tum()` writes the same frames in the TUM RGB-D layout (rgb/ and
depth/ PNGs, rgb.txt, depth.txt, groundtruth.txt) for `online_slam
tum_rgbd` and `tum_mono`, which take the camera (`replica_camera(width,
height)`) through --fx --fy --cx --cy --width --height.

Usage:
  python -m photo_slam_tpu_torch.tools.synth_replica <out_dir> \
      [--frames 120] [--width 1200] [--height 680] [--clean] [--tum] \
      [--device cuda]
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from photo_slam_tpu_torch.io.datasets import (REPLICA_CAMERA,
                                              REPLICA_DEPTH_SCALE,
                                              TUM_DEPTH_SCALE)
from photo_slam_tpu_torch.io.images import read_png
from photo_slam_tpu_torch.models.camera import PINHOLE, Camera
from photo_slam_tpu_torch.ops.camera_math import build_camera_matrices
from photo_slam_tpu_torch.ops.render import (RenderSettings, principal_for,
                                             render)
from photo_slam_tpu_torch.tracking.gt_tracker import Frame
from photo_slam_tpu_torch.utils.math import rotmat_to_quat_numpy

CYL_R = 5.0
N_SPLATS = 60_000
WORLD_SEED = 3
SENSOR_SEED = 99
TUM_T0 = 1305031102.175304   # write_tum's first stamp (s), a TUM-like one
TUM_HZ = 30.0


# ---------------------------------------------------------------------------
# Texture and sensor model: bench.py:119-173, copied (bench.py installs
# signal handlers when imported).
# ---------------------------------------------------------------------------

def pink_texture(size, seed):
    """1/f ("pink") noise texture: the spatial power spectrum of natural
    photographs, so splat colors sampled from it carry photographic
    statistics instead of the white noise a uniform rand() gives."""
    r = np.random.RandomState(seed)
    f = np.fft.fftfreq(size)
    fx, fy = np.meshgrid(f, f)
    amp = 1.0 / np.maximum(np.sqrt(fx * fx + fy * fy), 1.0 / size) ** 1.1
    spec = amp * np.exp(2j * np.pi * r.rand(size, size))
    t = np.real(np.fft.ifft2(spec))
    return (t - t.min()) / (np.ptp(t) + 1e-9)


PHOTO = Path(__file__).resolve().parent / "data" / "grace_hopper.png"


def photo_atlas(size=1024, photo=PHOTO):
    """Texture atlas with photographic statistics: a real photograph
    (matplotlib's bundled grace_hopper.jpg, which bench.py decodes with
    PIL; its decoded pixels are kept beside this module as a PNG, so the
    machines without PIL or matplotlib build the same atlas) pasted over
    correlated pink-noise channels; the pink noise alone with photo=None."""
    base = np.stack([pink_texture(size, 11), pink_texture(size, 12),
                     pink_texture(size, 13)], -1)
    base = 0.15 + 0.7 * (0.6 * base + 0.4 * base.mean(-1, keepdims=True))
    if photo is not None:
        ph = read_png(photo).astype(np.float32) / 255.0
        h, w = ph.shape[:2]
        base[:h, :w, :] = ph[:size, :size]
        base[h:, :w, :] = ph[: size - h, :size][::-1]
    return base.astype(np.float32)


def photo_colors(pts, atlas):
    """Sample splat colors from the atlas by a surface chart: ~4 mm/texel at
    room scale, so neighboring splats (4 cm spacing) see coherent image
    structure."""
    size = atlas.shape[0]
    u = ((pts[:, 0] * 0.27 + pts[:, 2] * 0.113) % 1.0) * (size - 1)
    v = ((pts[:, 1] * 0.31 + pts[:, 2] * 0.071) % 1.0) * (size - 1)
    return atlas[v.astype(np.int64), u.astype(np.int64)]


def corrupt_frame(img_chw, i, rng):
    """Sensor model for the training frames: slow exposure drift, Gaussian
    shot noise, and motion blur on every third frame."""
    out = img_chw * (1.0 + 0.08 * np.sin(0.9 * i))
    if i % 3 == 0:
        out = 0.25 * np.roll(out, 1, axis=2) + 0.5 * out + \
            0.25 * np.roll(out, -1, axis=2)
    out = out + rng.randn(*out.shape).astype(np.float32) * 0.015
    return np.clip(out, 0.0, 1.0).astype(np.float32)


# ---------------------------------------------------------------------------
# World, trajectory, depth (tools/gen_synth_replica.py:30-45, 68-120)
# ---------------------------------------------------------------------------

def cylinder_world(n=N_SPLATS, seed=WORLD_SEED):
    """(points, scales, quats, opacities, colors) of the cylinder room."""
    rng = np.random.RandomState(seed)
    phi = rng.uniform(-np.pi, np.pi, n)
    y = rng.uniform(-2.2, 2.2, n)
    r = CYL_R + rng.uniform(-0.12, 0.12, n)
    pts = np.stack([r * np.sin(phi), y, r * np.cos(phi)], 1).astype(
        np.float32)
    scales = np.full((n, 3), 0.045, np.float32)
    quats = np.tile(np.array([1.0, 0, 0, 0], np.float32), (n, 1))
    opac = rng.uniform(0.75, 0.98, n).astype(np.float32)
    cols = photo_colors(pts, photo_atlas()).astype(np.float32)
    return pts, scales, quats, opac, cols


def replica_camera(width: int, height: int) -> Camera:
    """The Replica camera at (width, height), its intrinsics scaled as
    io/datasets.ReplicaDataset scales them for a resized sequence."""
    sx = width / REPLICA_CAMERA["width"]
    sy = height / REPLICA_CAMERA["height"]
    return Camera(camera_id=0, model_id=PINHOLE, width=width, height=height,
                  fx=REPLICA_CAMERA["fx"] * sx, fy=REPLICA_CAMERA["fy"] * sy,
                  cx=(REPLICA_CAMERA["cx"] + 0.5) * sx - 0.5,
                  cy=(REPLICA_CAMERA["cy"] + 0.5) * sy - 0.5)


def pose(i: int, num: int):
    """(R world->camera [3,3], camera center in the world [3]) of frame i:
    a yaw out to 1.1 rad and back, on a small circle."""
    half = num // 2
    f = i / max(half, 1)
    yaw = 1.1 * (f if i < half else max(2.0 - f, 0.0))
    cy_, sy_ = np.cos(yaw), np.sin(yaw)
    R = np.array([[cy_, 0, -sy_], [0, 1, 0], [sy_, 0, cy_]])
    c_w = np.array([0.25 * np.sin(2 * np.pi * i / num),
                    0.05 * np.sin(4 * np.pi * i / num),
                    0.25 * np.cos(2 * np.pi * i / num) - 0.25])
    return R, c_w


def cylinder_depth(cam: Camera, R: np.ndarray, c_w: np.ndarray) -> np.ndarray:
    """Analytic z-depth [H, W] float32 of the cylinder of radius CYL_R: the
    ray o + s d (d with camera z 1, so s is the z-depth) meets
    |(x, z)| = CYL_R."""
    u, v = np.meshgrid(np.arange(cam.width), np.arange(cam.height))
    d_cam = np.stack([(u - cam.cx) / cam.fx, (v - cam.cy) / cam.fy,
                      np.ones((cam.height, cam.width))], -1)
    d_w = d_cam @ R  # rows: R^T d_cam
    ox, oz = c_w[0], c_w[2]
    a = d_w[..., 0] ** 2 + d_w[..., 2] ** 2
    b = 2 * (ox * d_w[..., 0] + oz * d_w[..., 2])
    c0 = ox * ox + oz * oz - CYL_R * CYL_R
    disc = np.maximum(b * b - 4 * a * c0, 0.0)
    return ((-b + np.sqrt(disc)) / np.maximum(2 * a, 1e-12)).astype(
        np.float32)


class SynthReplica:
    """The sequence in host memory: `num_frames` Frames rendered on
    `device`, with world->camera poses, analytic depth and file names in
    the Replica layout."""

    def __init__(self, num_frames: int = 120, width: int = 1200,
                 height: int = 680, *, device, n_splats: int = N_SPLATS,
                 clean: bool = False):
        device = torch.device(device)
        self.camera = cam = replica_camera(width, height)
        pts, scales, quats, opac, cols = (
            torch.from_numpy(x).to(device) for x in cylinder_world(n_splats))
        settings = RenderSettings(
            width=width, height=height,
            tan_fovx=float(np.tan(cam.fovx / 2)),
            tan_fovy=float(np.tan(cam.fovy / 2)),
            principal=principal_for(cam, width, height),
            max_per_tile=1024, max_tiles_per_gaussian=8, mode="pallas")
        sensor_rng = np.random.RandomState(SENSOR_SEED)
        self.c2w: list[np.ndarray] = []
        self._frames: list[Frame] = []
        for i in range(num_frames):
            R, c_w = pose(i, num_frames)
            t = -R @ c_w  # world->camera translation
            mats = build_camera_matrices(R, t, 0.01, 100.0, cam.fovx,
                                         cam.fovy, device=device)
            with torch.no_grad():
                chw = render(pts, scales, quats, opac, mats, settings,
                             torch.zeros(3, device=device),
                             colors_precomp=cols).image.cpu().numpy()
            if not clean:
                chw = corrupt_frame(chw, i, sensor_rng)
            c2w = np.eye(4)
            c2w[:3, :3] = R.T
            c2w[:3, 3] = c_w
            self.c2w.append(c2w)
            self._frames.append(Frame(
                image=chw, quat_wxyz=rotmat_to_quat_numpy(R), trans=t,
                depth=cylinder_depth(cam, R, c_w),
                filename=f"frame{i:06d}.jpg"))

    def __len__(self):
        return len(self._frames)

    def frames(self):
        return iter(self._frames)

    def write(self, out_dir) -> Path:
        """The Replica layout under out_dir: results/frame*.jpg (frame*.png
        where no JPEG encoder imports), results/depth*.png (16 bit,
        REPLICA_DEPTH_SCALE units per meter) and traj.txt (4x4
        camera-to-world rows)."""
        from photo_slam_tpu_torch.io import images

        out = Path(out_dir)
        results = out / "results"
        results.mkdir(parents=True, exist_ok=True)
        encoder = images.cv2 is not None or images.Image is not None
        for i, fr in enumerate(self._frames):
            name = Path(fr.filename)
            images.save_image_chw(
                results / (name if encoder else name.with_suffix(".png")),
                fr.image)
            images.write_png(results / f"depth{i:06d}.png",
                             depth_units(fr.depth, REPLICA_DEPTH_SCALE))
        np.savetxt(out / "traj.txt",
                   np.stack([c.reshape(-1) for c in self.c2w]))
        return out

    def write_tum(self, out_dir) -> Path:
        """The TUM RGB-D layout under out_dir: rgb/<stamp>.png (8-bit RGB),
        depth/<stamp>.png (16 bit, TUM_DEPTH_SCALE units per meter), each
        listed with its stamp in rgb.txt and depth.txt, and
        groundtruth.txt (stamp tx ty tz qx qy qz qw, camera-to-world, at
        the RGB stamps). The frames are TUM_HZ apart from TUM_T0; a depth
        stamp lies tum_depth_offset(i) after its RGB stamp, so the loader's
        association has to pick the nearest. groundtruth.txt holds every
        number to full precision; the lists give stamps to the microsecond,
        as TUM's do."""
        from photo_slam_tpu_torch.io import images

        out = Path(out_dir)
        for sub in ("rgb", "depth"):
            (out / sub).mkdir(parents=True, exist_ok=True)
        head = "# {} written by photo_slam_tpu_torch.tools.synth_replica\n"
        rgb, depth, gt = ([head.format(k)] for k in ("rgb", "depth",
                                                      "groundtruth"))
        for i, fr in enumerate(self._frames):
            t = TUM_T0 + i / TUM_HZ
            td = t + tum_depth_offset(i)
            images.save_image_chw(out / "rgb" / f"{t:.6f}.png", fr.image)
            images.write_png(out / "depth" / f"{td:.6f}.png",
                             depth_units(fr.depth, TUM_DEPTH_SCALE))
            rgb.append(f"{t:.6f} rgb/{t:.6f}.png\n")
            depth.append(f"{td:.6f} depth/{td:.6f}.png\n")
            c2w = self.c2w[i]
            qw, qx, qy, qz = rotmat_to_quat_numpy(c2w[:3, :3])
            gt.append(" ".join(repr(float(x)) for x in (
                t, *c2w[:3, 3], qx, qy, qz, qw)) + "\n")
        for name, lines in (("rgb", rgb), ("depth", depth),
                            ("groundtruth", gt)):
            (out / f"{name}.txt").write_text("".join(lines))
        return out


def depth_units(depth_m: np.ndarray, scale: float) -> np.ndarray:
    """Metric depth [H, W] as the 16-bit units a depth PNG holds."""
    return np.clip(depth_m * scale, 0, 65535).astype(np.uint16)


def tum_depth_offset(i: int) -> float:
    """Seconds from frame i's RGB stamp to its depth stamp in write_tum:
    2-8 ms, within the loader's 20 ms association window and far nearer
    its own RGB frame than the next (1 / TUM_HZ away)."""
    return 0.002 + 0.001 * (i % 7)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--width", type=int, default=1200)
    ap.add_argument("--height", type=int, default=680)
    ap.add_argument("--clean", action="store_true",
                    help="the raw renders, without the sensor model")
    ap.add_argument("--tum", action="store_true",
                    help="write the TUM RGB-D layout (write_tum) and print "
                         "the camera flags of the TUM apps")
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default: cuda)")
    args = ap.parse_args(argv)
    from photo_slam_tpu_torch.apps.online_slam import cli_device

    seq = SynthReplica(args.frames, args.width, args.height,
                       device=cli_device(args.device), clean=args.clean)
    out = seq.write_tum(args.out) if args.tum else seq.write(args.out)
    print(f"wrote {len(seq)} frames -> {out}")
    if args.tum:
        print("camera flags: " + " ".join(tum_camera_flags(seq.camera)))


def tum_camera_flags(cam: Camera) -> list:
    """The `online_slam tum_rgbd|tum_mono` options that give it `cam`."""
    return ["--fx", repr(cam.fx), "--fy", repr(cam.fy), "--cx",
            repr(cam.cx), "--cy", repr(cam.cy), "--width", str(cam.width),
            "--height", str(cam.height)]


if __name__ == "__main__":
    main()
