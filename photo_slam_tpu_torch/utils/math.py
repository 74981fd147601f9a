"""Small math helpers shared across the port.

Counterpart of photo_slam_tpu/utils/math.py: the tensor helpers are PyTorch
and work on the device of the tensors they are given; the host-side numpy
helpers are the JAX package's, unchanged.
"""
from __future__ import annotations

import numpy as np
import torch


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """logit; inverse of sigmoid (reference: include/general_utils.h:26-29)."""
    return torch.log(x / (1.0 - x))


def fov2focal(fov: float, pixels: int) -> float:
    """(reference: include/graphics_utils.h:28-31)."""
    return pixels / (2.0 * np.tan(fov / 2.0))


def focal2fov(focal: float, pixels: int) -> float:
    """(reference: include/graphics_utils.h:33-36)."""
    return 2.0 * np.arctan(pixels / (2.0 * focal))


def round_to_multiple_of_16(x: int) -> int:
    """(reference: include/graphics_utils.h:38-52)."""
    return ((x + 15) // 16) * 16


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Batched unit-quaternion (w, x, y, z) -> rotation matrix [..., 3, 3].

    Normalizes the quaternion first, matching the reference's
    general_utils::build_rotation (include/general_utils.h:31-57).
    """
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1.0 - 2.0 * (y * y + z * z)
    r01 = 2.0 * (x * y - w * z)
    r02 = 2.0 * (x * z + w * y)
    r10 = 2.0 * (x * y + w * z)
    r11 = 1.0 - 2.0 * (x * x + z * z)
    r12 = 2.0 * (y * z - w * x)
    r20 = 2.0 * (x * z - w * y)
    r21 = 2.0 * (y * z + w * x)
    r22 = 1.0 - 2.0 * (x * x + y * y)
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def quat_to_rotmat_nonorm(q: torch.Tensor) -> torch.Tensor:
    """Same as :func:`quat_to_rotmat` but WITHOUT normalization.

    The rasterizer's covariance builder assumes unit quaternions and skips
    normalization (reference: cuda_rasterizer/forward.cu:126-138); keeping
    the same structure keeps gradients identical when the caller
    normalizes.
    """
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1.0 - 2.0 * (y * y + z * z)
    r01 = 2.0 * (x * y - w * z)
    r02 = 2.0 * (x * z + w * y)
    r10 = 2.0 * (x * y + w * z)
    r11 = 1.0 - 2.0 * (x * x + z * z)
    r12 = 2.0 * (y * z - w * x)
    r20 = 2.0 * (x * z - w * y)
    r21 = 2.0 * (y * z + w * x)
    r22 = 1.0 - 2.0 * (x * x + y * y)
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Batched rotation matrix [..., 3, 3] -> unit quaternion (w, x, y, z).

    Branch-free Shoemake-style conversion (the reference uses the same
    method on the device for loop-closure point transforms,
    cuda_rasterizer/operate_points.h:100-180): each element takes the
    numerically best of the four candidate constructions.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def root(x):
        return torch.sqrt(torch.clamp(x, min=1e-12)) * 2.0

    s0 = root(tr + 1.0)
    q0 = torch.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0,
                      (m10 - m01) / s0], dim=-1)
    s1 = root(1.0 + m00 - m11 - m22)
    q1 = torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1,
                      (m02 + m20) / s1], dim=-1)
    s2 = root(1.0 + m11 - m00 - m22)
    q2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2,
                      (m12 + m21) / s2], dim=-1)
    s3 = root(1.0 + m22 - m00 - m11)
    q3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3,
                      0.25 * s3], dim=-1)

    cond0 = (tr > 0.0)[..., None]
    cond1 = ((m00 >= m11) & (m00 >= m22))[..., None]
    cond2 = (m11 >= m22)[..., None]
    q = torch.where(cond0, q0,
                    torch.where(cond1, q1, torch.where(cond2, q2, q3)))
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of (w, x, y, z) quaternions, batched."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_to_rotmat_numpy(q: np.ndarray) -> np.ndarray:
    """Host-side 3x3 rotation from a (w,x,y,z) quaternion. The tracking
    frontend converts poses per frame — routing these tiny ops through JAX
    costs milliseconds of dispatch each (measured in the frontend profile)."""
    w, x, y, z = (float(v) for v in np.asarray(q, np.float64))
    n = (w * w + x * x + y * y + z * z) ** 0.5
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float64)


def rotmat_to_quat_numpy(R: np.ndarray) -> np.ndarray:
    """Host-side 3x3 rotation -> (w,x,y,z) quaternion (Shoemake)."""
    R = np.asarray(R, np.float64)
    m00, m11, m22 = R[0, 0], R[1, 1], R[2, 2]
    tr = m00 + m11 + m22
    if tr > 0.0:
        s = np.sqrt(tr + 1.0) * 2.0
        q = np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                      (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    elif m00 >= m11 and m00 >= m22:
        s = np.sqrt(max(1.0 + m00 - m11 - m22, 1e-12)) * 2.0
        q = np.array([(R[2, 1] - R[1, 2]) / s, 0.25 * s,
                      (R[0, 1] + R[1, 0]) / s, (R[0, 2] + R[2, 0]) / s])
    elif m11 >= m22:
        s = np.sqrt(max(1.0 + m11 - m00 - m22, 1e-12)) * 2.0
        q = np.array([(R[0, 2] - R[2, 0]) / s, (R[0, 1] + R[1, 0]) / s,
                      0.25 * s, (R[1, 2] + R[2, 1]) / s])
    else:
        s = np.sqrt(max(1.0 + m22 - m00 - m11, 1e-12)) * 2.0
        q = np.array([(R[1, 0] - R[0, 1]) / s, (R[0, 2] + R[2, 0]) / s,
                      (R[1, 2] + R[2, 1]) / s, 0.25 * s])
    return q / np.linalg.norm(q)


def se3_matrix(quat_wxyz: np.ndarray, t: np.ndarray) -> np.ndarray:
    """4x4 rigid transform from unit quaternion (w,x,y,z) + translation."""
    T = np.eye(4, dtype=np.float64)
    T[:3, :3] = quat_to_rotmat_numpy(quat_wxyz)
    T[:3, 3] = np.asarray(t, dtype=np.float64)
    return T


def se3_inverse(T: np.ndarray) -> np.ndarray:
    """Inverse of a 4x4 rigid transform."""
    R = T[:3, :3]
    t = T[:3, 3]
    Ti = np.eye(4, dtype=T.dtype)
    Ti[:3, :3] = R.T
    Ti[:3, 3] = -R.T @ t
    return Ti


def _skew(w: np.ndarray) -> np.ndarray:
    return np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]],
                    dtype=np.float64)


def se3_exp_numpy(xi: np.ndarray) -> np.ndarray:
    """SE3 exponential map; xi = (t[3], w[3]) -> 4x4 (numpy, host-side)."""
    xi = np.asarray(xi, np.float64)
    t, w = xi[:3], xi[3:]
    theta = np.linalg.norm(w)
    K = _skew(w)
    if theta < 1e-9:
        R = np.eye(3) + K + 0.5 * K @ K
        V = np.eye(3) + 0.5 * K + K @ K / 6.0
    else:
        a = np.sin(theta) / theta
        b = (1 - np.cos(theta)) / theta**2
        c = (theta - np.sin(theta)) / theta**3
        R = np.eye(3) + a * K + b * K @ K
        V = np.eye(3) + b * K + c * K @ K
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = V @ t
    return T


def se3_log_numpy(T: np.ndarray) -> np.ndarray:
    """SE3 logarithm map; 4x4 -> xi = (t[3], w[3]) (numpy, host-side)."""
    R = np.asarray(T[:3, :3], np.float64)
    tr = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    theta = np.arccos(tr)
    if theta < 1e-9:
        w = 0.5 * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                            R[1, 0] - R[0, 1]])
    elif theta > np.pi - 1e-6:
        # Near pi: R ~ 2 u u^T - I. Pivot on the largest diagonal element
        # (its axis component is safely nonzero) and derive the others from
        # the symmetric off-diagonals — fixed-component sign tests fail for
        # axes like (0, a, -a) where the tested products vanish.
        k = int(np.argmax(np.diag(R)))
        i, j = (k + 1) % 3, (k + 2) % 3
        ax = np.zeros(3)
        ax[k] = np.sqrt(max((R[k, k] + 1.0) / 2.0, 1e-12))
        ax[i] = (R[k, i] + R[i, k]) / (4.0 * ax[k])
        ax[j] = (R[k, j] + R[j, k]) / (4.0 * ax[k])
        n = np.linalg.norm(ax)
        w = theta * ax / n if n > 1e-12 else np.zeros(3)
    else:
        w = theta / (2.0 * np.sin(theta)) * np.array(
            [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    K = _skew(w)
    theta2 = max(theta * theta, 1e-18)
    if theta < 1e-9:
        Vi = np.eye(3) - 0.5 * K + K @ K / 12.0
    else:
        c = (1.0 - theta * np.cos(theta / 2.0)
             / (2.0 * np.sin(theta / 2.0))) / theta2
        Vi = np.eye(3) - 0.5 * K + c * K @ K
    t = Vi @ np.asarray(T[:3, 3], np.float64)
    return np.concatenate([t, w])
