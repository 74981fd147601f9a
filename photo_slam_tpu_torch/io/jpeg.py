"""Baseline JPEG reading owned by the port, for machines without cv2 or PIL.

The decoding is host C++ (`photo_slam_tpu_torch/csrc_host/jpeg.cpp`),
built by g++ at first use into `<checkout>/build/torch_native/` through
native.py (a failed build raises with g++'s output). It reads 8-bit
Huffman-coded sequential JPEG (SOF0, SOF1) with 1 or 3 components, chroma
at 4:4:4, 4:2:2 and 4:2:0, restart intervals, and skips APPn and COM
segments; it computes libjpeg-turbo's default decode (the ISLOW integer
IDCT, fancy upsampling, jdcolor's fixed-point tables), so its pixels equal
cv2.imread's (tests/test_torch_jpeg.py). Progressive, arithmetic-coded,
lossless, hierarchical and 12-bit files, other sampling factors and an
EXIF orientation other than 1 raise ValueError naming the kind, as does a
truncated file; a missing file raises FileNotFoundError.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from photo_slam_tpu_torch import native

SOI = b"\xff\xd8"
_ERR_CAP = 256


def is_jpeg(data: bytes) -> bool:
    return data[:2] == SOI


def decode_jpeg(data: bytes, gray: bool = False, name: str = "JPEG"):
    """[H, W, 3] uint8 RGB of JPEG bytes, or [H, W] uint8 for a
    one-component file or when `gray` (the luma plane, as cv2's
    IMREAD_GRAYSCALE reads it)."""
    lib = native._lib("jpeg")
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(_ERR_CAP)
    if lib.jpeg_info(data, len(data), ctypes.byref(h), ctypes.byref(w),
                     ctypes.byref(c), err, _ERR_CAP):
        raise ValueError(f"{name}: {err.value.decode()}")
    channels = 1 if gray or c.value == 1 else 3
    out = np.empty((h.value, w.value, channels), np.uint8)
    if lib.jpeg_decode(data, len(data), int(gray), out.ctypes.data, err,
                       _ERR_CAP):
        raise ValueError(f"{name}: {err.value.decode()}")
    return out[..., 0] if channels == 1 else out


def read_jpeg(path, gray: bool = False) -> np.ndarray:
    """decode_jpeg of a file."""
    p = Path(path)
    if not p.is_file():
        raise FileNotFoundError(str(path))
    return decode_jpeg(p.read_bytes(), gray, str(path))
