"""Image file loading -> CHW float32 [0,1] numpy arrays.

Host-side replacement for the reference's cv::imread + tensor_utils converters
(reference: include/tensor_utils.h:30-196). Uses OpenCV when present (fast
path, matches the reference's BGR->RGB handling), falls back to PIL; both are
optional so the core framework stays importable without them.
photo_slam_tpu/io/images.py, copied, plus codecs of the port's own for the
machines that have neither: PNG (`read_png`, `write_png` over
`decode_png`, `encode_png`, zlib and numpy:
the kinds the datasets use, 8-bit gray, 8-bit RGB, 16-bit gray, not
interlaced) and baseline JPEG (io/jpeg.py, host C++ equal to cv2.imread),
chosen by the file's signature; any other kind raises.
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

from photo_slam_tpu_torch.io.jpeg import is_jpeg, read_jpeg

try:
    import cv2  # type: ignore
except Exception:  # pragma: no cover
    cv2 = None

try:
    from PIL import Image  # type: ignore
except Exception:  # pragma: no cover
    Image = None

# ---------------------------------------------------------------------------
# PNG (ISO/IEC 15948): the three kinds the datasets use
# ---------------------------------------------------------------------------

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# (color type, bit depth) -> (channels, numpy dtype of a sample)
_PNG_KINDS = {(0, 8): (1, np.uint8), (0, 16): (1, np.dtype(">u2")),
              (2, 8): (3, np.uint8)}
_COLOR_NAMES = {0: "gray", 2: "RGB", 3: "palette", 4: "gray+alpha",
                6: "RGBA"}


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters: [height, stride] uint8 scanlines."""
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != height * (stride + 1):
        raise ValueError(f"PNG data holds {rows.size} bytes, expected "
                         f"{height * (stride + 1)}")
    rows = rows.reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:      # None
            cur = line.copy()
        elif kind == 1:    # Sub: a running byte sum per channel byte
            cur = np.cumsum(line.reshape(-1, bpp), 0, dtype=np.uint8).reshape(
                -1)
        elif kind == 2:    # Up
            cur = line + prev
        elif kind in (3, 4):  # Average, Paeth: serial along the row
            cur = _unfilter_serial(kind, line, prev, bpp)
        else:
            raise ValueError(f"PNG row filter {kind} does not exist")
        out[y] = prev = cur
    return out


def _unfilter_serial(kind, line, prev, bpp) -> np.ndarray:
    cur = line.astype(np.int64)
    up = prev.astype(np.int64)
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = up[i]
        if kind == 3:
            cur[i] = (cur[i] + ((a + b) >> 1)) & 255
            continue
        c = up[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 255
    return cur.astype(np.uint8)


def read_png(path) -> np.ndarray:
    """A PNG file as [H, W] uint8 / uint16 (gray) or [H, W, 3] uint8 (RGB,
    in that order). Raises FileNotFoundError for a missing file and
    ValueError for a PNG kind outside 8-bit gray, 8-bit RGB, 16-bit gray
    or an interlaced one."""
    p = Path(path)
    if not p.is_file():
        raise FileNotFoundError(str(path))
    try:
        return decode_png(p.read_bytes())
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes as read_png returns a file's: [H, W] uint8 / uint16 (gray)
    or [H, W, 3] uint8 (RGB). ValueError for another kind."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG file")
    pos, header, idat = len(PNG_SIGNATURE), None, []
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    width, height, depth, color, _comp, _filt, interlace = header
    kind = _PNG_KINDS.get((color, depth))
    if kind is None or interlace:
        raise ValueError(
            f"PNG kind {_COLOR_NAMES.get(color, color)} at "
            f"{depth} bits{' interlaced' if interlace else ''} is not "
            f"supported (8-bit gray, 8-bit RGB, 16-bit gray only)")
    channels, dtype = kind
    bpp = channels * np.dtype(dtype).itemsize
    rows = _unfilter(zlib.decompress(b"".join(idat)), height, width * bpp,
                     bpp)
    img = rows.view(dtype).reshape(height, width, channels)
    img = img.astype(np.uint16 if depth == 16 else np.uint8)
    return img[..., 0] if channels == 1 else img


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))


def write_png(path, img: np.ndarray) -> None:
    """Write [H, W] uint8 / uint16 (gray) or [H, W, 3] uint8 (RGB) as a
    PNG file (encode_png at zlib level 6)."""
    data = encode_png(img, level=6)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_bytes(data)


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """[H, W] uint8 / uint16 (gray) or [H, W, 3] uint8 (RGB) as PNG bytes:
    no row filters, one IDAT chunk at zlib `level` (which changes the
    size and the time, never the pixels)."""
    img = np.asarray(img)
    color = {2: 0, 3: 2}.get(img.ndim)
    if img.ndim == 3 and img.shape[2] != 3:
        color = None
    depth = {np.dtype(np.uint8): 8, np.dtype(np.uint16): 16}.get(img.dtype)
    if color is None or depth is None or (color, depth) not in _PNG_KINDS:
        raise ValueError(f"encode_png: {img.dtype} {img.shape} is not 8-bit "
                         f"gray, 8-bit RGB or 16-bit gray")
    h, w = img.shape[:2]
    samples = img.astype(">u2") if depth == 16 else img
    rows = np.ascontiguousarray(samples).view(np.uint8).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], 1).tobytes()
    return (PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0,
                                          0, 0))
            + _chunk(b"IDAT", zlib.compress(raw, level))
            + _chunk(b"IEND", b""))


def _read_own(path) -> np.ndarray:
    """A PNG or JPEG file through the port's own codecs, by its signature
    (as cv2.imread picks its decoder)."""
    p = Path(path)
    if not p.is_file():
        raise FileNotFoundError(str(path))
    with open(p, "rb") as f:
        head = f.read(len(PNG_SIGNATURE))
    if head == PNG_SIGNATURE:
        return read_png(p)
    if is_jpeg(head):
        return read_jpeg(p)
    raise RuntimeError(f"no image backend for {path}: cv2 and PIL are "
                       f"missing and the port's own codecs read PNG and "
                       f"JPEG only")


# ---------------------------------------------------------------------------
# The loaders' entry points
# ---------------------------------------------------------------------------

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
    else:
        img = _read_own(path)
        if img.dtype == np.uint16:  # as cv2.IMREAD_COLOR reduces 16 bits
            img = (img >> 8).astype(np.uint8)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=2)
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
    else:
        d = _read_own(path)
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
    elif Path(path).suffix.lower() == ".png":
        write_png(path, arr)
    else:
        raise RuntimeError(f"no image backend for {path}: cv2 and PIL are "
                           f"missing and the port's own codec writes PNG "
                           f"only")
