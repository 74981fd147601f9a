"""3DGS-standard PLY checkpoint I/O (binary little-endian), numpy-only.

photo_slam_tpu/utils/ply.py, copied: files written by either package load
in the other bit for bit.

Byte-layout compatible with the reference's savePly/loadPly
(reference: src/gaussian_model.cpp:838-1047, written via tinyply): vertex
properties x,y,z, nx,ny,nz (zeros), f_dc_0..2, f_rest_0..(3K-1) in
channel-major order ([N,3,K_rest] flattened), opacity (logit), scale_0..2
(log), rot_0..3 (wxyz, unnormalized). Any 3DGS viewer/tool can open these
files, and the reference's outputs load here.

Also writes input.ply sparse point clouds (saveSparsePointsPly,
src/gaussian_model.cpp:1049-1088: x,y,z,nx,ny,nz,red,green,blue uchar).
"""
from __future__ import annotations

import io
from pathlib import Path

import numpy as np


def _header(num: int, props: list[tuple[str, str]]) -> bytes:
    lines = [
        "ply",
        "format binary_little_endian 1.0",
        f"element vertex {num}",
    ]
    lines += [f"property {t} {n}" for n, t in props]
    lines.append("end_header")
    return ("\n".join(lines) + "\n").encode("ascii")


def save_gaussian_ply(path, xyz: np.ndarray, features_dc: np.ndarray,
                      features_rest: np.ndarray, opacity_logit: np.ndarray,
                      log_scales: np.ndarray, quats: np.ndarray) -> None:
    """Write the model checkpoint. Inputs are RAW (pre-activation) values for
    live Gaussians only: xyz [N,3], features_dc [N,1,3],
    features_rest [N,K,3], opacity_logit [N,1], log_scales [N,3], quats [N,4].
    """
    n = xyz.shape[0]
    k_rest = features_rest.shape[1]
    # Channel-major flattening, like torch .transpose(1,2).flatten(1).
    f_dc = np.ascontiguousarray(np.transpose(features_dc, (0, 2, 1))).reshape(n, -1)
    f_rest = np.ascontiguousarray(np.transpose(features_rest, (0, 2, 1))).reshape(n, -1)

    names = (
        ["x", "y", "z", "nx", "ny", "nz"]
        + [f"f_dc_{i}" for i in range(3)]
        + [f"f_rest_{i}" for i in range(3 * k_rest)]
        + ["opacity"]
        + [f"scale_{i}" for i in range(3)]
        + [f"rot_{i}" for i in range(4)]
    )
    cols = np.concatenate(
        [
            xyz.astype(np.float32),
            np.zeros((n, 3), np.float32),
            f_dc.astype(np.float32),
            f_rest.astype(np.float32),
            opacity_logit.reshape(n, 1).astype(np.float32),
            log_scales.astype(np.float32),
            quats.astype(np.float32),
        ],
        axis=1,
    )
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(_header(n, [(nm, "float") for nm in names]))
        f.write(np.ascontiguousarray(cols, dtype="<f4").tobytes())


def _parse_header(f: io.BufferedReader):
    line = f.readline().strip()
    if line != b"ply":
        raise ValueError("not a PLY file")
    fmt = None
    num = 0
    props: list[tuple[str, str]] = []
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unterminated PLY header")
        tok = line.strip().split()
        if not tok:
            continue
        if tok[0] == b"format":
            fmt = tok[1].decode()
        elif tok[0] == b"element" and tok[1] == b"vertex":
            num = int(tok[2])
        elif tok[0] == b"property" and len(tok) == 3:
            props.append((tok[2].decode(), tok[1].decode()))
        elif tok[0] == b"end_header":
            break
    if fmt != "binary_little_endian":
        raise ValueError(f"unsupported PLY format {fmt}")
    return num, props


_DTYPES = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "short": "<i2", "ushort": "<u2", "int": "<i4", "int32": "<i4",
    "uint": "<u4", "uint32": "<u4",
}


def read_ply_fields(path) -> dict[str, np.ndarray]:
    """Read every vertex property into a dict of [N] arrays."""
    with open(path, "rb") as f:
        num, props = _parse_header(f)
        dtype = np.dtype([(name, _DTYPES[typ]) for name, typ in props])
        data = np.frombuffer(f.read(num * dtype.itemsize), dtype=dtype,
                             count=num)
    return {name: np.ascontiguousarray(data[name]) for name, _ in props}


def load_gaussian_ply(path):
    """Read a 3DGS checkpoint -> raw parameter arrays
    (reference loadPly: src/gaussian_model.cpp:838-954).

    Returns (xyz, features_dc [N,1,3], features_rest [N,K,3],
    opacity_logit [N,1], log_scales [N,3], quats [N,4]).
    """
    fields = read_ply_fields(path)
    n = fields["x"].shape[0]
    xyz = np.stack([fields["x"], fields["y"], fields["z"]], axis=1)
    f_dc = np.stack([fields[f"f_dc_{i}"] for i in range(3)], axis=1)  # [N,3]
    rest_names = sorted(
        (k for k in fields if k.startswith("f_rest_")),
        key=lambda s: int(s.split("_")[-1]),
    )
    k_rest = len(rest_names) // 3
    if rest_names:
        f_rest = np.stack([fields[k] for k in rest_names], axis=1)  # [N, 3K]
        f_rest = f_rest.reshape(n, 3, k_rest).transpose(0, 2, 1)    # [N,K,3]
    else:
        f_rest = np.zeros((n, 0, 3), np.float32)
    opacity = fields["opacity"].reshape(n, 1)
    log_scales = np.stack([fields[f"scale_{i}"] for i in range(3)], axis=1)
    quats = np.stack([fields[f"rot_{i}"] for i in range(4)], axis=1)
    return (
        xyz.astype(np.float32),
        f_dc.astype(np.float32).reshape(n, 3, 1).transpose(0, 2, 1),
        f_rest.astype(np.float32),
        opacity.astype(np.float32),
        log_scales.astype(np.float32),
        quats.astype(np.float32),
    )


def save_points_ply(path, xyz: np.ndarray, colors_uint8: np.ndarray) -> None:
    """Sparse input point cloud (input.ply) with uchar RGB
    (reference: src/gaussian_model.cpp:1049-1088)."""
    n = xyz.shape[0]
    props = (
        [(nm, "float") for nm in ("x", "y", "z", "nx", "ny", "nz")]
        + [(nm, "uchar") for nm in ("red", "green", "blue")]
    )
    dtype = np.dtype([
        ("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
        ("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4"),
        ("red", "u1"), ("green", "u1"), ("blue", "u1"),
    ])
    rec = np.zeros(n, dtype=dtype)
    rec["x"], rec["y"], rec["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    rec["red"], rec["green"], rec["blue"] = (
        colors_uint8[:, 0], colors_uint8[:, 1], colors_uint8[:, 2])
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(_header(n, props))
        f.write(rec.tobytes())


def load_points_ply(path):
    """Read x,y,z (+ RGB if present) from a generic vertex PLY."""
    fields = read_ply_fields(path)
    xyz = np.stack([fields["x"], fields["y"], fields["z"]], axis=1).astype(np.float32)
    if "red" in fields:
        rgb = np.stack([fields["red"], fields["green"], fields["blue"]],
                       axis=1)
        if rgb.dtype == np.uint8:
            rgb = rgb.astype(np.float32) / 255.0
        return xyz, rgb.astype(np.float32)
    return xyz, None
