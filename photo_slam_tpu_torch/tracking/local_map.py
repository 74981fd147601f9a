"""Sparse SLAM map: keyframes, map points, covisibility.

photo_slam_tpu/tracking/local_map.py, copied (numpy only, on the host).

The host-side map state behind the tracking frontend — the role of
ORB-SLAM3's Map/Atlas + KeyFrame + MapPoint classes (reference:
ORB-SLAM3/src/{Map,KeyFrame,MapPoint}.cc), reduced to the parts the
tracking/local-mapping/loop-closing pipeline needs: poses, keypoints,
descriptors, point observations and the covisibility weights derived from
shared observations. Map points live in growable struct-of-arrays storage so
per-frame projection matching is vectorized numpy.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class KeyframeNode:
    kfid: int
    tcw: np.ndarray                  # [4,4] world->camera
    kps_px: np.ndarray               # [K,2] float32 keypoint pixels
    desc: np.ndarray                 # [K,32] uint8 ORB descriptors
    mp_ids: np.ndarray               # [K] int64 map-point id per kp, -1 none
    image: Optional[np.ndarray] = None   # [3,H,W] float32 (for op payloads)
    depth: Optional[np.ndarray] = None   # [H,W] or None
    resp: Optional[np.ndarray] = None    # [K] detector responses at extraction


class LocalMap:
    """Struct-of-arrays map-point store + keyframe graph."""

    _GROW = 4096

    def __init__(self):
        self.keyframes: dict[int, KeyframeNode] = {}
        self._cap = 0
        self._n = 0
        self.xyz = np.zeros((0, 3), np.float64)
        self.desc = np.zeros((0, 32), np.uint8)
        self.color = np.zeros((0, 3), np.float32)
        self.alive = np.zeros(0, bool)
        # Tracking statistics for culling (reference: MapPoint::mnFound /
        # mnVisible, LocalMapping::MapPointCulling).
        self.n_obs = np.zeros(0, np.int32)
        self.first_kf = np.zeros(0, np.int64)
        # observations: mp id -> {kfid: keypoint index}
        self.obs: list[dict[int, int]] = []

    # ------------------------------------------------------------------

    def _ensure(self, extra: int) -> None:
        need = self._n + extra
        if need <= self._cap:
            return
        new_cap = max(need, self._cap + self._GROW)
        grow = new_cap - self._cap

        def pad(a, fill=0):
            return np.concatenate(
                [a, np.full((grow,) + a.shape[1:], fill, a.dtype)])

        self.xyz = pad(self.xyz)
        self.desc = pad(self.desc)
        self.color = pad(self.color)
        self.alive = pad(self.alive, False)
        self.n_obs = pad(self.n_obs)
        self.first_kf = pad(self.first_kf, -1)
        self._cap = new_cap

    def add_points(self, xyz: np.ndarray, desc: np.ndarray,
                   color: np.ndarray, first_kf: int) -> np.ndarray:
        """Insert new map points; returns their ids."""
        k = len(xyz)
        self._ensure(k)
        ids = np.arange(self._n, self._n + k)
        self.xyz[ids] = xyz
        self.desc[ids] = desc
        self.color[ids] = color
        self.alive[ids] = True
        self.n_obs[ids] = 0
        self.first_kf[ids] = first_kf
        self.obs.extend({} for _ in range(k))
        self._n += k
        return ids

    def add_observation(self, mp_id: int, kfid: int, kp_idx: int) -> None:
        if kfid not in self.obs[mp_id]:
            self.n_obs[mp_id] += 1
        self.obs[mp_id][kfid] = kp_idx

    def remove_point(self, mp_id: int) -> None:
        self.alive[mp_id] = False
        for kfid, kp in self.obs[mp_id].items():
            kf = self.keyframes.get(kfid)
            if kf is not None and kf.mp_ids[kp] == mp_id:
                kf.mp_ids[kp] = -1
        self.obs[mp_id] = {}

    @property
    def num_points(self) -> int:
        return int(self.alive[:self._n].sum())

    def point_ids_of_kfs(self, kfids) -> np.ndarray:
        """Unique live map-point ids observed by the given keyframes."""
        ids = []
        for kfid in kfids:
            kf = self.keyframes.get(kfid)
            if kf is not None:
                ids.append(kf.mp_ids[kf.mp_ids >= 0])
        if not ids:
            return np.zeros(0, np.int64)
        out = np.unique(np.concatenate(ids))
        return out[self.alive[out]]

    # ------------------------------------------------------------------

    def add_keyframe(self, node: KeyframeNode) -> None:
        self.keyframes[node.kfid] = node
        for kp_idx, mp_id in enumerate(node.mp_ids):
            if mp_id >= 0:
                self.add_observation(int(mp_id), node.kfid, kp_idx)

    def covisible_kfs(self, kfid: int, min_shared: int = 15) -> list[int]:
        """Keyframes sharing >= min_shared map points with `kfid`, sorted by
        weight (reference: KeyFrame::UpdateConnections)."""
        kf = self.keyframes.get(kfid)
        if kf is None:
            return []
        counts: dict[int, int] = {}
        for mp_id in kf.mp_ids:
            if mp_id < 0 or not self.alive[mp_id]:
                continue
            for other in self.obs[mp_id]:
                if other != kfid:
                    counts[other] = counts.get(other, 0) + 1
        pairs = [(w, k) for k, w in counts.items() if w >= min_shared]
        pairs.sort(reverse=True)
        return [k for _, k in pairs]

    def cull_points(self, current_kfid: int, min_obs: int = 2,
                    max_age_kfs: int = 3) -> int:
        """Drop recent points that failed to gather observations (reference:
        ORB-SLAM3/src/LocalMapping.cc MapPointCulling). Returns count."""
        dropped = 0
        recent = (self.first_kf[:self._n] >= 0) & self.alive[:self._n]
        age = current_kfid - self.first_kf[:self._n]
        weak = recent & (age >= max_age_kfs) & (self.n_obs[:self._n] < min_obs)
        for mp_id in np.where(weak)[0]:
            self.remove_point(int(mp_id))
            self.first_kf[mp_id] = -1
            dropped += 1
        return dropped

    # ------------------------------------------------------------------

    def gather(self, ids: np.ndarray):
        """(xyz, desc, color) for the given point ids."""
        return self.xyz[ids], self.desc[ids], self.color[ids]
