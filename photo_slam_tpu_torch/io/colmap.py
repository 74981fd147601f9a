"""COLMAP binary reconstruction reader (cameras.bin / images.bin / points3D.bin).

photo_slam_tpu/io/colmap.py, copied (numpy only).

Equivalent of the reference's offline loader
(reference: examples/train_colmap.cpp:32-237 + third_party/colmap/utils/endian.h):
parses the standard little-endian COLMAP binary format into numpy arrays.
Only PINHOLE / SIMPLE_PINHOLE camera models feed the mapper (the reference
rejects others as well, src/gaussian_keyframe.cpp:82-99).
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path

import numpy as np

# model_id -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}


@dataclass
class ColmapCamera:
    camera_id: int
    model: str
    width: int
    height: int
    params: np.ndarray  # model-specific


@dataclass
class ColmapImage:
    image_id: int
    quat_wxyz: np.ndarray  # world->camera rotation
    trans: np.ndarray      # world->camera translation
    camera_id: int
    name: str
    xys: np.ndarray        # [K, 2]
    point3d_ids: np.ndarray  # [K] int64, -1 where unmatched


def _read(fmt: str, f) -> tuple:
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, f.read(size))


def read_cameras_bin(path) -> dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        (num,) = _read("<Q", f)
        for _ in range(num):
            cam_id, model_id = _read("<ii", f)
            width, height = _read("<QQ", f)
            name, num_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f"<{num_params}d", f))
            cams[cam_id] = ColmapCamera(cam_id, name, int(width), int(height),
                                        params)
    return cams


def read_images_bin(path) -> dict[int, ColmapImage]:
    images = {}
    with open(path, "rb") as f:
        (num,) = _read("<Q", f)
        for _ in range(num):
            (image_id,) = _read("<i", f)
            qw, qx, qy, qz, tx, ty, tz = _read("<7d", f)
            (camera_id,) = _read("<i", f)
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (num_pts,) = _read("<Q", f)
            data = np.frombuffer(f.read(24 * num_pts),
                                 dtype=[("x", "<f8"), ("y", "<f8"),
                                        ("id", "<i8")])
            images[image_id] = ColmapImage(
                image_id=image_id,
                quat_wxyz=np.array([qw, qx, qy, qz]),
                trans=np.array([tx, ty, tz]),
                camera_id=camera_id,
                name=name.decode("utf-8"),
                xys=np.stack([data["x"], data["y"]], axis=1),
                point3d_ids=np.ascontiguousarray(data["id"]),
            )
    return images


def read_points3d_bin(path) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (ids [N], xyz [N,3], rgb [N,3] float in [0,1])."""
    ids, xyzs, rgbs = [], [], []
    with open(path, "rb") as f:
        (num,) = _read("<Q", f)
        for _ in range(num):
            (pid,) = _read("<q", f)
            xyz = _read("<3d", f)
            rgb = _read("<3B", f)
            _read("<d", f)  # reprojection error
            (track_len,) = _read("<Q", f)
            f.seek(8 * track_len, 1)
            ids.append(pid)
            xyzs.append(xyz)
            rgbs.append(rgb)
    return (
        np.asarray(ids, np.int64),
        np.asarray(xyzs, np.float32),
        np.asarray(rgbs, np.float32) / 255.0,
    )


def load_reconstruction(sparse_dir):
    """Read a COLMAP sparse model directory (cameras/images/points3D.bin)."""
    d = Path(sparse_dir)
    cams = read_cameras_bin(d / "cameras.bin")
    images = read_images_bin(d / "images.bin")
    ids, xyz, rgb = read_points3d_bin(d / "points3D.bin")
    return cams, images, (ids, xyz, rgb)


# -- writers (for tests and for recording our own reconstructions) -----------

def write_cameras_bin(path, cams: dict[int, ColmapCamera]) -> None:
    model_ids = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for cam in cams.values():
            mid = model_ids[cam.model]
            f.write(struct.pack("<ii", cam.camera_id, mid))
            f.write(struct.pack("<QQ", cam.width, cam.height))
            f.write(struct.pack(f"<{len(cam.params)}d", *cam.params))


def write_images_bin(path, images: dict[int, ColmapImage]) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<i", im.image_id))
            f.write(struct.pack("<7d", *im.quat_wxyz, *im.trans))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            f.write(struct.pack("<Q", im.xys.shape[0]))
            for (x, y), pid in zip(im.xys, im.point3d_ids):
                f.write(struct.pack("<ddq", x, y, int(pid)))


def write_points3d_bin(path, ids, xyz, rgb_float) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(ids)))
        for pid, p, c in zip(ids, xyz, rgb_float):
            f.write(struct.pack("<q", int(pid)))
            f.write(struct.pack("<3d", *p))
            f.write(struct.pack("<3B", *(np.clip(c * 255, 0, 255).astype(np.uint8))))
            f.write(struct.pack("<d", 1.0))
            f.write(struct.pack("<Q", 0))
