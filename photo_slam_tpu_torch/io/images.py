"""Image file loading -> CHW float32 [0,1] numpy arrays.

Host-side replacement for the reference's cv::imread + tensor_utils converters
(reference: include/tensor_utils.h:30-196). Uses OpenCV when present (fast
path, matches the reference's BGR->RGB handling), falls back to PIL; both are
optional so the core framework stays importable without them.
photo_slam_tpu/io/images.py, copied.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

try:
    import cv2  # type: ignore
except Exception:  # pragma: no cover
    cv2 = None

try:
    from PIL import Image  # type: ignore
except Exception:  # pragma: no cover
    Image = None


def load_image_chw(path) -> np.ndarray:
    """RGB image as [3, H, W] float32 in [0, 1]."""
    path = str(path)
    if cv2 is not None:
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(path)
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    elif Image is not None:
        img = np.asarray(Image.open(path).convert("RGB"))
    else:  # pragma: no cover
        raise RuntimeError("no image backend available (need cv2 or PIL)")
    return np.transpose(img.astype(np.float32) / 255.0, (2, 0, 1))


def load_depth(path, depth_scale: float = 1.0) -> np.ndarray:
    """Depth image as [H, W] float32 (meters after dividing by depth_scale)."""
    path = str(path)
    if cv2 is not None:
        d = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if d is None:
            raise FileNotFoundError(path)
    elif Image is not None:
        d = np.asarray(Image.open(path))
    else:  # pragma: no cover
        raise RuntimeError("no image backend available (need cv2 or PIL)")
    if d.ndim == 3:
        d = d[..., 0]
    return d.astype(np.float32) / depth_scale


def save_image_chw(path, img_chw: np.ndarray) -> None:
    """Write a [3, H, W] float image in [0,1] to disk."""
    arr = np.clip(np.transpose(img_chw, (1, 2, 0)) * 255.0, 0, 255).astype(
        np.uint8)
    path = str(path)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    if cv2 is not None:
        cv2.imwrite(path, cv2.cvtColor(arr, cv2.COLOR_RGB2BGR))
    elif Image is not None:
        Image.fromarray(arr).save(path)
    else:  # pragma: no cover
        raise RuntimeError("no image backend available (need cv2 or PIL)")
