"""MappingOperation: the tracker -> mapper bridge, plus a thread-safe queue.

photo_slam_tpu/mapper/mapping_ops.py, copied (numpy only): the Python
equivalent of the reference's Atlas mapping-operation machinery
(reference: ORB-SLAM3/include/Atlas.h:52-308). A frontend (tracking, local
mapping, loop closing, in other threads or processes) pushes operations;
the mapper drains them before each training iteration. save_stream and
load_stream record and replay operation streams in one .npz file, with the
JAX package's keys, so a stream recorded by either package replays in the
other. Payloads are host numpy arrays: the tracker side never touches the
device.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass, field
from enum import Enum
from pathlib import Path
from typing import Optional

import numpy as np


class OprType(Enum):
    LOCAL_MAPPING_BA = 0
    LOOP_CLOSING_BA = 1
    SCALE_REFINEMENT = 2


@dataclass
class KeyframeData:
    """One keyframe payload inside an operation (reference: the 9-tuple in
    Atlas.h:52-184: kfid, camid, pose, RGB, isLoopKF, auxImg, kps_pixel,
    kps_local3D, filename)."""

    kfid: int
    camera_id: int
    quat_wxyz: np.ndarray          # world->camera
    trans: np.ndarray
    image: Optional[np.ndarray] = None       # [3,H,W] float32 RGB
    is_loop_kf: bool = False
    aux_image: Optional[np.ndarray] = None   # depth [H,W] or right image
    kps_pixel: Optional[np.ndarray] = None   # [K,2]
    kps_point_local: Optional[np.ndarray] = None  # [K,3] camera frame
    filename: str = ""
    # Per-keyframe similarity scale for LoopClosingBA corrections (Sim3
    # essential graphs give each keyframe its own scale; the reference's
    # single per-op scale is the degenerate uniform case).
    scale: float = 1.0


@dataclass
class MappingOperation:
    kind: OprType
    keyframes: list[KeyframeData] = field(default_factory=list)
    points: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))
    colors: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))
    scale: float = 1.0
    # 4x4 transform for ScaleRefinement (Tyw)
    transform: np.ndarray = field(default_factory=lambda: np.eye(4, dtype=np.float32))


class MappingOpQueue:
    """Mutex-guarded FIFO (reference: Atlas.h:280-308)."""

    def __init__(self):
        self._q: queue.Queue[MappingOperation] = queue.Queue()
        self._lock = threading.Lock()

    def push(self, op: MappingOperation) -> None:
        self._q.put(op)

    def has(self) -> bool:
        return not self._q.empty()

    def get_and_pop(self) -> MappingOperation:
        return self._q.get_nowait()

    def clear(self) -> None:
        with self._lock:
            while not self._q.empty():
                try:
                    self._q.get_nowait()
                except queue.Empty:
                    break


# ---------------------------------------------------------------------------
# Record / replay
# ---------------------------------------------------------------------------

def save_stream(path, ops: list[MappingOperation]) -> None:
    """Serialize an operation stream to one .npz file."""
    payload: dict[str, np.ndarray] = {"num_ops": np.array(len(ops))}
    for i, op in enumerate(ops):
        p = f"op{i}_"
        payload[p + "kind"] = np.array(op.kind.value)
        payload[p + "scale"] = np.array(op.scale)
        payload[p + "transform"] = op.transform
        payload[p + "points"] = op.points
        payload[p + "colors"] = op.colors
        payload[p + "num_kfs"] = np.array(len(op.keyframes))
        for j, kf in enumerate(op.keyframes):
            k = f"{p}kf{j}_"
            payload[k + "meta"] = np.array([kf.kfid, kf.camera_id,
                                            int(kf.is_loop_kf)])
            payload[k + "scale"] = np.array(kf.scale)
            payload[k + "quat"] = kf.quat_wxyz
            payload[k + "trans"] = kf.trans
            if kf.image is not None:
                payload[k + "image"] = kf.image
            if kf.aux_image is not None:
                payload[k + "aux"] = kf.aux_image
            if kf.kps_pixel is not None:
                payload[k + "kps_pixel"] = kf.kps_pixel
            if kf.kps_point_local is not None:
                payload[k + "kps_local"] = kf.kps_point_local
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **payload)


def load_stream(path) -> list[MappingOperation]:
    raw = np.load(path)
    files = set(raw.files)

    class _D:
        def __getitem__(self, k):
            return raw[k]

        def get(self, k):
            return raw[k] if k in files else None

    data = _D()
    ops = []
    for i in range(int(data["num_ops"])):
        p = f"op{i}_"
        op = MappingOperation(
            kind=OprType(int(data[p + "kind"])),
            scale=float(data[p + "scale"]),
            transform=data[p + "transform"],
            points=data[p + "points"],
            colors=data[p + "colors"],
        )
        for j in range(int(data[p + "num_kfs"])):
            k = f"{p}kf{j}_"
            meta = data[k + "meta"]
            op.keyframes.append(KeyframeData(
                kfid=int(meta[0]),
                camera_id=int(meta[1]),
                is_loop_kf=bool(meta[2]),
                quat_wxyz=data[k + "quat"],
                trans=data[k + "trans"],
                image=data.get(k + "image"),
                aux_image=data.get(k + "aux"),
                kps_pixel=data.get(k + "kps_pixel"),
                kps_point_local=data.get(k + "kps_local"),
                scale=(float(data[k + "scale"])
                       if k + "scale" in files else 1.0),
            ))
        ops.append(op)
    return ops
