"""Camera matrices and the per-point transforms (natural convention:
p' = M @ [p, 1]); matrices on the host in float64, float32 results."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32 (10 mantissa bits, to nearest, ties to
    even), as the tensor cores round a TF32 product's operands. The
    gradient passes through the rounding unchanged."""
    with torch.no_grad():
        bits = x.detach().contiguous().view(torch.int32)
        lsb = (bits >> 13) & 1
        rounded = ((bits + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)
        rounded = torch.where(torch.isfinite(x), rounded, x)
    return x + (rounded - x).detach() if x.requires_grad else rounded


def matmul(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    """a @ b in float32, or with TF32 operands for prec == "tf32"."""
    if prec == "tf32":
        return tf32(a) @ tf32(b)
    return a @ b


class Matrices(NamedTuple):
    viewmatrix: torch.Tensor   # [4, 4] world -> camera
    full_proj: torch.Tensor    # [4, 4] projection @ viewmatrix
    cam_center: torch.Tensor   # [3]


def focal2fov(focal: float, pixels: int) -> float:
    return 2.0 * np.arctan(pixels / (2.0 * focal))


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Unit (w, x, y, z) quaternion -> [3, 3], in the tensor's precision."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [[1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - w * z),
             2.0 * (x * z + w * y)],
            [2.0 * (x * y + w * z), 1.0 - 2.0 * (x * x + z * z),
             2.0 * (y * z - w * x)],
            [2.0 * (x * z - w * y), 2.0 * (y * z + w * x),
             1.0 - 2.0 * (x * x + y * y)]]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def rotation_of(quat_wxyz) -> np.ndarray:
    """The rotation of a pose's quaternion, computed in float32 from the
    normalized float64 quaternion."""
    q = np.asarray(quat_wxyz, np.float64)
    return quat_to_rotmat(torch.tensor(q / np.linalg.norm(q),
                                       dtype=torch.float32)).numpy()


def projection_matrix(znear: float, zfar: float, fovx: float,
                      fovy: float) -> np.ndarray:
    """OpenGL-style perspective projection with w' = z_view."""
    top = np.tan(fovy / 2.0) * znear
    right = np.tan(fovx / 2.0) * znear
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def matrices(R: np.ndarray, t, znear: float, zfar: float, fovx: float,
             fovy: float, device) -> Matrices:
    """The transform bundle of a world -> camera pose (R, t)."""
    w2v = np.eye(4, dtype=np.float64)
    w2v[:3, :3] = R
    w2v[:3, 3] = np.asarray(t, np.float64)
    w2v = w2v.astype(np.float32)
    proj = projection_matrix(znear, zfar, fovx, fovy)
    full = (proj.astype(np.float64) @ w2v.astype(np.float64)).astype(
        np.float32)
    center = np.linalg.inv(w2v.astype(np.float64))[:3, 3].astype(np.float32)
    return Matrices(*(torch.from_numpy(x).to(device)
                      for x in (w2v, full, center)))


def ndc_to_pixel(v: torch.Tensor, size: int) -> torch.Tensor:
    return ((v + 1.0) * size - 1.0) * 0.5


def transform_43(points: torch.Tensor, M: torch.Tensor,
                 prec: str) -> torch.Tensor:
    """[N, 3] points through the affine part of M -> [N, 3]."""
    return matmul(points, M[:3, :3].T, prec) + M[:3, 3]


def transform_44(points: torch.Tensor, M: torch.Tensor,
                 prec: str) -> torch.Tensor:
    """[N, 3] points through M -> homogeneous [N, 4]."""
    out = matmul(points, M[:3, :3].T, prec) + M[:3, 3]
    w = matmul(points, M[3, :3], prec) + M[3, 3]
    return torch.cat([out, w[:, None]], dim=-1)
