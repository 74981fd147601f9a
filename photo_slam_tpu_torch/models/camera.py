"""Camera model: intrinsics, FoV, undistortion maps/masks, image pyramid.

photo_slam_tpu/models/camera.py, copied (numpy only). Host-side analog of the reference's Camera (reference: include/camera.h:31-139)
without the OpenCV-CUDA dependency: undistortion uses an inverse-mapping
remap computed in numpy, masks come from warping a white image exactly like
the reference's undistort_mask computation (include/camera.h:88-111). Pinhole
inputs with no distortion skip the remap entirely (the common case for
Replica/COLMAP).

Two distortion models are supported:
  * PINHOLE + Brown-Conrady (k1 k2 p1 p2 k3) — the reference mapper's only
    model (src/gaussian_mapper.cpp:217-222);
  * FISHEYE = Kannala-Brandt8 (k1..k4 equidistant), the model the reference
    SLAM supports natively (ORB-SLAM3/include/CameraModels/KannalaBrandt8.h)
    but its mapper rejects. Here fisheye inputs are rectified to the pinhole
    view through the same remap machinery, so the whole tracking + mapping
    stack runs on fisheye sequences.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from photo_slam_tpu_torch.utils.math import focal2fov

PINHOLE = 1
FISHEYE = 2


@dataclass
class Camera:
    camera_id: int
    model_id: int              # PINHOLE (Brown-Conrady) or FISHEYE (KB8)
    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float
    dist_coeffs: np.ndarray = field(
        default_factory=lambda: np.zeros(5, np.float32))
    # PINHOLE: k1 k2 p1 p2 k3 (Brown-Conrady); FISHEYE: k1 k2 k3 k4 (KB8)
    stereo_bf: float = 0.0
    num_pyramid_levels: int = 0
    _remap: Optional[tuple[np.ndarray, np.ndarray]] = None
    _mask: Optional[np.ndarray] = None

    @property
    def fovx(self) -> float:
        return focal2fov(self.fx, self.width)

    @property
    def fovy(self) -> float:
        return focal2fov(self.fy, self.height)

    @property
    def has_distortion(self) -> bool:
        # The equidistant fisheye projection is nonlinear even with all
        # k coefficients zero (theta != tan(theta)), so fisheye always remaps.
        return self.model_id == FISHEYE or bool(
            np.any(np.abs(self.dist_coeffs) > 1e-12))

    def _distort_normalized(self, x, y):
        """Distorted normalized coords for ideal pinhole normalized (x, y)."""
        if self.model_id == FISHEYE:
            # Kannala-Brandt8 equidistant model (reference:
            # ORB-SLAM3/src/CameraModels/KannalaBrandt8.cpp project()).
            k1, k2, k3, k4 = self.dist_coeffs[:4]
            r = np.sqrt(x * x + y * y)
            theta = np.arctan(r)
            t2 = theta * theta
            theta_d = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 *
                                                      (k3 + t2 * k4))))
            scale = np.where(r > 1e-9, theta_d / np.maximum(r, 1e-9), 1.0)
            return x * scale, y * scale
        # Brown-Conrady (k1 k2 p1 p2 k3).
        k1, k2, p1, p2, k3 = self.dist_coeffs[:5]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        return xd, yd

    def undistort_remap(self) -> tuple[np.ndarray, np.ndarray]:
        """(map_x, map_y) [H, W]: source pixel for each undistorted pixel —
        the same mapping cv::initUndistortRectifyMap produces
        (reference: include/camera.h:74-87)."""
        if self._remap is not None:
            return self._remap
        ys, xs = np.mgrid[0:self.height, 0:self.width].astype(np.float64)
        xn = (xs - self.cx) / self.fx
        yn = (ys - self.cy) / self.fy
        xd, yd = self._distort_normalized(xn, yn)
        map_x = (xd * self.fx + self.cx).astype(np.float32)
        map_y = (yd * self.fy + self.cy).astype(np.float32)
        self._remap = (map_x, map_y)
        return self._remap

    def undistort_image(self, img: np.ndarray) -> np.ndarray:
        """Bilinear remap of an HWC (or HW) image through the undistort map."""
        if not self.has_distortion:
            return img
        map_x, map_y = self.undistort_remap()
        return bilinear_remap(img, map_x, map_y)

    def undistort_mask(self, scale: float = 1.0) -> np.ndarray:
        """Valid-pixel mask = white image warped through the undistortion
        (reference: include/camera.h:88-111). [h, w] float32 in {0, 1}."""
        if not self.has_distortion:
            h = int(round(self.height * scale))
            w = int(round(self.width * scale))
            return np.ones((h, w), np.float32)
        if self._mask is None:
            white = np.ones((self.height, self.width), np.float32)
            m = self.undistort_image(white)
            self._mask = (m > 0.999).astype(np.float32)
        if scale == 1.0:
            return self._mask
        return resize_image(self._mask, int(round(self.height * scale)),
                            int(round(self.width * scale)))


def bilinear_remap(img: np.ndarray, map_x: np.ndarray,
                   map_y: np.ndarray) -> np.ndarray:
    """numpy bilinear remap with zero border (cv::remap BORDER_CONSTANT)."""
    h, w = img.shape[:2]
    x0 = np.floor(map_x).astype(np.int64)
    y0 = np.floor(map_y).astype(np.int64)
    fx = (map_x - x0)[..., None] if img.ndim == 3 else map_x - x0
    fy = (map_y - y0)[..., None] if img.ndim == 3 else map_y - y0

    def sample(yy, xx):
        valid = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        v = img[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)]
        if img.ndim == 3:
            return np.where(valid[..., None], v, 0.0)
        return np.where(valid, v, 0.0)

    v00 = sample(y0, x0)
    v01 = sample(y0, x0 + 1)
    v10 = sample(y0 + 1, x0)
    v11 = sample(y0 + 1, x0 + 1)
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    return (top * (1 - fy) + bot * fy).astype(img.dtype)


def resize_image(img: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    """Bilinear resize (align_corners=False convention, like cv::resize)."""
    h, w = img.shape[:2]
    ys = (np.arange(new_h) + 0.5) * h / new_h - 0.5
    xs = (np.arange(new_w) + 0.5) * w / new_w - 0.5
    map_y, map_x = np.meshgrid(ys, xs, indexing="ij")
    return bilinear_remap(img, map_x.astype(np.float32),
                          map_y.astype(np.float32))


def build_pyramid(img: np.ndarray, num_sub_levels: int) -> list[np.ndarray]:
    """Gaussian-pyramid-style image stack: [coarsest..finest-sub] halved per
    level (reference keeps `num_gaus_pyramid_sub_levels_` scaled copies,
    include/camera.h:95-105; level i has size / 2^(levels - i))."""
    h, w = img.shape[:2]
    out = []
    for i in range(num_sub_levels):
        f = 2 ** (num_sub_levels - i)
        out.append(resize_image(img, max(1, h // f), max(1, w // f)))
    return out
