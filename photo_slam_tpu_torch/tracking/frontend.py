"""Full SLAM tracking frontend: local-map tracking, local mapping, loop
closing, relocalization, monocular initialization.

This is the framework's replacement for the reference's ORB-SLAM3 pipeline
(reference layers: Tracking.cc pose tracking + keyframe decision,
LocalMapping.cc map-point creation/culling + local BA,
LoopClosing.cc place recognition + pose-graph correction), emitting the same
MappingOperation stream the Gaussian mapper consumes
(reference: ORB-SLAM3/include/Atlas.h:52-184). Host-side numpy; the
optimization cores are native C++ (native.local_ba /
pose_graph_optimize / pose_optimize).

Per frame:
  1. ORB extraction;
  2. constant-velocity pose prediction, projection matching against the
     local map (covisible keyframes' points), PnP-RANSAC + motion-only BA
     (the role of Tracking::TrackWithMotionModel / TrackLocalMap);
  3. keyframe decision (tracked-ratio + interval,
     Tracking::NeedNewKeyFrame in spirit);
  4. on keyframe: map-point creation (depth-backprojection for RGBD/stereo,
     two-view triangulation for monocular), map-point culling, windowed
     local BA, LocalMappingBA push (LocalMapping.cc:149-160);
  5. loop detection by descriptor voting + PnP verification; on success a
     pose-graph correction over all keyframes and a LoopClosingBA push
     (LoopClosing.cc:1201).
Monocular initialization is two-view: essential matrix + recoverPose +
triangulation, scene scaled to unit median depth
(Tracking::MonocularInitialization).

Counterpart of photo_slam_tpu/tracking/frontend.py for sensor "rgbd" and
"mono". The OpenCV calls of the JAX frontend go through the port's own
tracking/vision.py (a test swaps OpenCV's versions in there); ORB runs in
torch on the frontend's `device`, on its own CUDA stream when that is a
card, and everything else stays numpy on the host. The frontend never
touches the mapper's device tensors: it hands over numpy payloads in
MappingOperation. The stereo sensor, the inertial frontend (`use_imu`) and
distorted cameras (the JAX `_rectify_frame`) wait for the EuRoC
stereo-inertial slice of the port and raise NotImplementedError.

Per-frame stage times (`stage_times`): ORB, matching and PnP on the
tracking thread per frame, local BA per call on whichever thread runs it.
"""
from __future__ import annotations

import contextlib
import queue
import threading
import time
from typing import Optional

import numpy as np
import torch

from photo_slam_tpu_torch.mapper.mapping_ops import (KeyframeData,
                                                     MappingOperation, OprType)
from photo_slam_tpu_torch.models.camera import Camera
from photo_slam_tpu_torch.native import (local_ba, pose_graph_optimize,
                                         pose_optimize)
from photo_slam_tpu_torch.tracking import vision
from photo_slam_tpu_torch.tracking.gt_tracker import Frame
from photo_slam_tpu_torch.tracking.local_map import KeyframeNode, LocalMap
from photo_slam_tpu_torch.tracking.vocab import KeyframeDatabase
from photo_slam_tpu_torch.utils.math import (rotmat_to_quat_numpy,
                                             se3_inverse, se3_matrix)
from photo_slam_tpu_torch.utils.sim3 import Sim3, sim3_pose_graph_optimize

NEXT_SLICE = ("waits for the EuRoC stereo-inertial slice of the port "
              "(ROADMAP Queue 1)")


# ---------------------------------------------------------------------------
# Hamming distance helpers (descriptor voting without DBoW2)
# ---------------------------------------------------------------------------

_POPCOUNT = np.array([bin(i).count("1") for i in range(256)], np.uint8)


def _sig_distances(qsig: np.ndarray, sigs: np.ndarray) -> np.ndarray:
    """Hamming distance of one packed signature [32] to many [K,32]."""
    x = np.bitwise_xor(sigs, qsig[None])
    if hasattr(np, "bitwise_count"):
        return np.bitwise_count(x).sum(1)
    return _POPCOUNT[x].sum(1)


def hamming_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise Hamming distances between uint8 descriptor rows [A,32]x[B,32]."""
    x = np.bitwise_xor(a[:, None, :], b[None, :, :])
    if hasattr(np, "bitwise_count"):
        return np.bitwise_count(x).sum(axis=2).astype(np.int32)
    return _POPCOUNT[x].sum(axis=2).astype(np.int32)


def match_descriptors(a: np.ndarray, b: np.ndarray, max_dist: int = 50,
                      ratio: float = 0.8):
    """Mutual-best descriptor matching with a Lowe ratio test.

    Returns (idx_a, idx_b) index arrays.
    """
    if len(a) == 0 or len(b) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    d = hamming_matrix(a, b)
    best_b = np.argmin(d, axis=1)
    best_d = d[np.arange(len(a)), best_b]
    d2 = d.copy()
    d2[np.arange(len(a)), best_b] = 1 << 16
    second = d2.min(axis=1)
    ok = (best_d <= max_dist) & (best_d <= ratio * second)
    # Mutual check.
    best_a = np.argmin(d, axis=0)
    ok &= best_a[best_b] == np.arange(len(a))
    ia = np.where(ok)[0]
    return ia, best_b[ia]


class FeatureGrid:
    """Uniform pixel grid over keypoints with a fixed per-cell capacity —
    gives fully vectorized 3x3-neighborhood candidate lookup."""

    CAP = 10

    def __init__(self, px: np.ndarray, width: int, height: int,
                 cell: int = 20):
        self.cell = cell
        self.nx = max(1, (width + cell - 1) // cell)
        self.ny = max(1, (height + cell - 1) // cell)
        self.table = np.full((self.ny * self.nx, self.CAP), -1, np.int64)
        fill = np.zeros(self.ny * self.nx, np.int32)
        cx = np.clip((px[:, 0] // cell).astype(np.int64), 0, self.nx - 1)
        cy = np.clip((px[:, 1] // cell).astype(np.int64), 0, self.ny - 1)
        for i, key in enumerate(cy * self.nx + cx):
            if fill[key] < self.CAP:
                self.table[key, fill[key]] = i
                fill[key] += 1

    def candidates(self, uv: np.ndarray) -> np.ndarray:
        """[Q, 9*CAP] feature indices (-1 padded) in the 3x3 cells around
        each query point."""
        cx = np.clip((uv[:, 0] // self.cell).astype(np.int64), 0, self.nx - 1)
        cy = np.clip((uv[:, 1] // self.cell).astype(np.int64), 0, self.ny - 1)
        out = []
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                qx = cx + dx
                qy = cy + dy
                inside = (qx >= 0) & (qx < self.nx) & (qy >= 0) & (
                    qy < self.ny)
                kx = np.clip(qx, 0, self.nx - 1)
                ky = np.clip(qy, 0, self.ny - 1)
                cells = self.table[ky * self.nx + kx]
                out.append(np.where(inside[:, None], cells, -1))
        return np.concatenate(out, axis=1)


# ---------------------------------------------------------------------------


class SlamFrontend:
    """Feature-based SLAM frontend over the MappingOperation protocol."""

    def __init__(self, camera: Camera, sensor: str = "rgbd",
                 num_features: int = 1500, min_tracked: int = 25,
                 kf_min_interval: int = 3, kf_max_interval: int = 30,
                 kf_tracked_ratio: float = 0.6,
                 min_depth: float = 0.05, max_depth: float = 40.0,
                 ba_window: int = 6,
                 match_radius: float = 16.0,
                 enable_loop_closing: bool = True,
                 loop_min_score: int = 60, loop_min_inliers: int = 25,
                 max_new_points_per_kf: int = 400,
                 async_local_mapping: bool = False,
                 use_imu: bool = False, *, device):
        if sensor == "stereo":
            raise NotImplementedError("sensor='stereo' " + NEXT_SLICE)
        if use_imu:
            raise NotImplementedError("use_imu " + NEXT_SLICE)
        if camera.has_distortion:
            raise NotImplementedError("distorted cameras (rectification) "
                                      + NEXT_SLICE)
        assert sensor in ("rgbd", "mono")
        self.camera = camera
        self.sensor = sensor
        self.device = torch.device(device)
        self.num_features = num_features
        self._orb_stream = (torch.cuda.Stream(self.device)
                            if self.device.type == "cuda" else None)
        self.stage_times: dict[str, list[float]] = {
            "orb": [], "match": [], "pnp": [], "ba": []}
        self.min_tracked = min_tracked
        self.kf_min_interval = kf_min_interval
        self.kf_max_interval = kf_max_interval
        self.kf_tracked_ratio = kf_tracked_ratio
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.ba_window = ba_window
        self.match_radius = match_radius
        self.enable_loop_closing = enable_loop_closing
        self.loop_min_score = loop_min_score
        self.loop_min_inliers = loop_min_inliers
        self.max_new_points_per_kf = max_new_points_per_kf

        self.map = LocalMap()
        # Multi-map recovery (the role of ORB-SLAM3's Atlas): on persistent
        # tracking loss the active map is stashed and a fresh sub-map starts
        # at the last known pose; a loop-style detection against a stashed
        # map merges them.
        self._old_maps: list[LocalMap] = []
        self._submap_seed: Optional[np.ndarray] = None
        self.submap_after_lost = 12
        self.num_maps_merged = 0
        self.K = np.array([[camera.fx, 0, camera.cx],
                           [0, camera.fy, camera.cy], [0, 0, 1]], np.float64)

        self.tcw = np.eye(4)
        self.velocity = np.eye(4)          # T_cur_prev
        self.trajectory: list[np.ndarray] = []
        self.traj_times: list[float] = []
        self.track_times: list[float] = []  # per-frame tracking seconds
        self.frames_since_kf = 0
        self.last_kfid = -1
        self.ref_tracked = 0               # tracked count at last keyframe
        self.done = False
        self.lost_frames = 0
        self.tracked_frames = 0            # frames with a tracked pose
        self.num_relocalizations = 0
        self.num_loops_closed = 0
        self._frame_idx = 0
        self._kf_count = 0
        self.live_kf_ids: set[int] = set()
        # Loop detection database: kfid -> strongest descriptors, plus a
        # TF-IDF bag-of-binary-words index (the DBoW2 role; the vocabulary
        # trains itself from the first keyframes' descriptors). Majority-bit
        # signatures remain as the pre-training fallback.
        self._loop_db: dict[int, np.ndarray] = {}
        self._loop_sigs: dict[int, np.ndarray] = {}
        self.kfdb = KeyframeDatabase()
        self.loop_min_db_score = 0.05
        self._last_loop_kfid = -(1 << 30)
        self._mono_init: Optional[tuple] = None  # (px, desc, img, raw, resp)
        self._last_resp: Optional[np.ndarray] = None
        self._frame_grid: Optional[FeatureGrid] = None
        self.last_frame_vis: Optional[tuple] = None

        # --- Asynchronous local mapping (the reference's architecture:
        # ORB-SLAM3 runs LocalMapping and LoopClosing on their OWN threads,
        # System.cc:194-213, so the tracking thread holds camera rate).
        # When enabled, the per-keyframe tail work (map-point culling,
        # windowed local BA, loop retrieval + PnP verification, op build)
        # runs on a worker thread; only the map INSERT stays synchronous.
        # Verified loops and BA pose corrections are handed back to the
        # tracking thread and applied at the next frame boundary, so every
        # whole-map mutation stays single-threaded.
        # The inertial frontend is not ported: these stay as the JAX
        # frontend reports them without an IMU.
        self.imu_initialized = False
        self.num_scale_refinements = 0

        self.async_local_mapping = async_local_mapping
        self._lock = threading.RLock()
        self._push_cb = None                 # set by run(); worker emits here
        self._pending_ops: list[MappingOperation] = []
        self._pending_pose_fix: Optional[np.ndarray] = None
        self._pending_loop: Optional[tuple] = None
        self._lm_exc: Optional[BaseException] = None
        self._map_version = 0                # bumped on whole-map transforms
        self._kf_jobs: Optional[queue.Queue] = None
        self._lm_thread: Optional[threading.Thread] = None
        if async_local_mapping:
            self._kf_jobs = queue.Queue()
            self._lm_thread = threading.Thread(
                target=self._lm_worker, name="local-mapping", daemon=True)
            self._lm_thread.start()

    # ------------------------------------------------------------------
    # Basics
    # ------------------------------------------------------------------

    @staticmethod
    def _to_gray(img_chw: np.ndarray) -> np.ndarray:
        u8 = (np.clip(np.transpose(img_chw, (1, 2, 0)), 0, 1) * 255).astype(
            np.uint8)
        return vision.rgb_to_gray(u8)

    def _extract(self, frame: Frame):
        t0 = time.perf_counter()
        gray = self._to_gray(frame.image)
        with (torch.cuda.stream(self._orb_stream) if self._orb_stream
              else contextlib.nullcontext()):
            f = vision.orb_detect_and_compute(gray, self.num_features,
                                              self.device)
        self.stage_times["orb"][-1] += time.perf_counter() - t0
        return f.px, f.desc, f.resp

    def _depth_of(self, frame: Frame) -> Optional[np.ndarray]:
        return frame.depth

    def _depth_at(self, depth_map, px):
        cam = self.camera
        u = np.clip(px[:, 0].astype(np.int64), 0, cam.width - 1)
        v = np.clip(px[:, 1].astype(np.int64), 0, cam.height - 1)
        d = depth_map[v, u]
        ok = (d > self.min_depth) & (d < self.max_depth)
        return d, ok, u, v

    def _backproject(self, px, d):
        cam = self.camera
        x = (px[:, 0] - cam.cx) * d / cam.fx
        y = (px[:, 1] - cam.cy) * d / cam.fy
        return np.stack([x, y, d], 1)

    def _project(self, tcw, xyz):
        cam = self.camera
        xc = xyz @ tcw[:3, :3].T + tcw[:3, 3]
        z = xc[:, 2]
        zs = np.where(np.abs(z) > 1e-9, z, 1e-9)
        u = cam.fx * xc[:, 0] / zs + cam.cx
        v = cam.fy * xc[:, 1] / zs + cam.cy
        return np.stack([u, v], 1), z

    # ------------------------------------------------------------------
    # Tracking
    # ------------------------------------------------------------------

    def _timed(self, stage: str, fn, *args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            self.stage_times[stage][-1] += time.perf_counter() - t0

    def _track_local_map(self, px, desc, tcw_pred):
        """Match local-map points to current features by projection.

        Returns (mp_ids [F] with -1 for unmatched, matched_count)."""
        with self._lock:
            window = ([self.last_kfid]
                      + self.map.covisible_kfs(self.last_kfid))
            ids = self.map.point_ids_of_kfs(window[:10])
            mp_of_feat = np.full(len(px), -1, np.int64)
            if len(ids) == 0 or len(px) == 0:
                return mp_of_feat, 0
            xyz = self.map.xyz[ids]
        uv, z = self._project(tcw_pred, xyz)
        cam = self.camera
        vis = ((z > self.min_depth) & (uv[:, 0] >= -20)
               & (uv[:, 0] < cam.width + 20) & (uv[:, 1] >= -20)
               & (uv[:, 1] < cam.height + 20))
        ids, uv = ids[vis], uv[vis]
        if len(ids) == 0:
            return mp_of_feat, 0
        mdesc = self.map.desc[ids]
        # The grid depends only on this frame's keypoints — reuse it across
        # the (up to 3) tracking retries instead of rebuilding per attempt.
        grid = self._frame_grid
        if grid is None:
            grid = FeatureGrid(px, cam.width, cam.height,
                               cell=max(8, int(self.match_radius)))
            self._frame_grid = grid
        cand = grid.candidates(uv)                       # [M, C]
        cand_ok = cand >= 0
        cand_safe = np.where(cand_ok, cand, 0)
        # Radius mask in pixels.
        du = np.abs(px[cand_safe, 0] - uv[:, None, 0])
        dv = np.abs(px[cand_safe, 1] - uv[:, None, 1])
        cand_ok &= (du <= self.match_radius) & (dv <= self.match_radius)
        # Hamming only on the surviving (point, candidate) PAIRS — the grid
        # + radius mask leaves ~10-20% of the [M, C] rectangle, and the xor
        # + popcount over the dense rectangle was the frame budget's single
        # largest term (measured 22 ms dense vs 5 ms sparse at M=3000).
        ri, ci = np.nonzero(cand_ok)
        x = np.bitwise_xor(mdesc[ri], desc[cand_safe[ri, ci]])
        if hasattr(np, "bitwise_count"):
            dp = np.bitwise_count(x).sum(axis=1).astype(np.int32)
        else:
            dp = _POPCOUNT[x].sum(axis=1).astype(np.int32)
        dist = np.full(cand.shape, 256, np.int32)
        dist[ri, ci] = dp
        best_c = np.argmin(dist, axis=1)                 # per map point
        best_d = dist[np.arange(len(ids)), best_c]
        feat_idx = cand_safe[np.arange(len(ids)), best_c]
        # Resolve collisions vectorized: per feature, the lowest-distance
        # map point wins. Sort (feature, distance) and keep each feature's
        # first row (the Python loop this replaces cost ~10-20 ms/frame).
        ok = best_d < 60
        fi, bd, mi = feat_idx[ok], best_d[ok], ids[ok]
        if len(fi):
            order = np.lexsort((bd, fi))
            fi, mi = fi[order], mi[order]
            first = np.ones(len(fi), bool)
            first[1:] = fi[1:] != fi[:-1]
            mp_of_feat[fi[first]] = mi[first]
        return mp_of_feat, int((mp_of_feat >= 0).sum())

    def _track_reference_kf(self, px, desc):
        """Wide-baseline fallback: pure descriptor matching against the last
        keyframe's map-pointed features, no projection window (the role of
        Tracking::TrackReferenceKeyFrame) — catches motions larger than the
        projection search radius."""
        mp_of_feat = np.full(len(px), -1, np.int64)
        with self._lock:
            kf = self.map.keyframes.get(self.last_kfid)
            if kf is None:
                return mp_of_feat, 0
            has = kf.mp_ids >= 0
            if has.sum() < 10:
                return mp_of_feat, 0
            kf_desc = kf.desc[has]
            kf_mp = kf.mp_ids[has].copy()
        ia, ib = match_descriptors(kf_desc, desc, max_dist=60, ratio=0.8)
        mp_of_feat[ib] = kf_mp[ia]
        return mp_of_feat, len(ia)

    def _pose_from_matches(self, px, mp_of_feat, tcw_init):
        sel = mp_of_feat >= 0
        if sel.sum() < 6:
            return None, 0, sel
        with self._lock:
            obj = self.map.xyz[mp_of_feat[sel]]
        img = px[sel].astype(np.float64)
        rvec0 = vision.rodrigues_inverse(tcw_init[:3, :3])
        ok, rvec, tvec, inliers = vision.solve_pnp_ransac(
            obj, img, self.K, rvec0.copy(),
            tcw_init[:3, 3].reshape(3, 1).copy(), use_guess=True,
            reproj_err=4.0, iters=100)
        if not ok or inliers is None or len(inliers) < self.min_tracked:
            return None, 0 if inliers is None else len(inliers), sel
        R = vision.rodrigues(rvec)
        tcw = np.eye(4)
        tcw[:3, :3] = R
        tcw[:3, 3] = tvec.ravel()
        inl = inliers.ravel()
        n_inl, tcw, _ = pose_optimize(obj[inl], img[inl], self.camera.fx,
                                      self.camera.fy, self.camera.cx,
                                      self.camera.cy, tcw)
        return tcw, n_inl, sel

    # ------------------------------------------------------------------
    # Initialization
    # ------------------------------------------------------------------

    def _init_with_depth(self, frame, px, desc, depth_map):
        tcw = np.eye(4)
        if frame.quat_wxyz is not None:
            tcw = se3_matrix(frame.quat_wxyz, frame.trans)
        elif self._submap_seed is not None:
            tcw = self._submap_seed.copy()
        self._submap_seed = None
        d, ok, u, v = self._depth_at(depth_map, px)
        if ok.sum() < 20:
            return None
        local = self._backproject(px[ok], d[ok])
        twc = se3_inverse(tcw)
        world = local @ twc[:3, :3].T + twc[:3, 3]
        colors = frame.image[:, v[ok], u[ok]].T.astype(np.float32)
        kfid = self._new_kfid()
        ids = self.map.add_points(world, desc[ok], colors, kfid)
        mp_ids = np.full(len(px), -1, np.int64)
        mp_ids[ok] = ids
        node = KeyframeNode(kfid=kfid, tcw=tcw.copy(), kps_px=px, desc=desc,
                            mp_ids=mp_ids, image=frame.image,
                            depth=depth_map, resp=self._last_resp)
        self.map.add_keyframe(node)
        self._register_kf(node)
        self.tcw = tcw
        op = self._make_local_ba_op([node], new_points=world,
                                    new_colors=colors, frame=frame,
                                    new_node=node)
        return op

    def _init_mono(self, frame, px, desc):
        """Two-view initialization (reference: ORB-SLAM3/src/Tracking.cc
        MonocularInitialization): E-matrix + recoverPose + triangulation,
        scene scaled to unit median depth."""
        if self._mono_init is None:
            if len(px) >= 100:
                self._mono_init = (px, desc, frame.image,
                                   getattr(frame, "raw_image", frame.image),
                                   self._last_resp)
            return None
        # img0 (rectified) samples keypoint colors; raw0 is the op payload —
        # the mapper undistorts incoming keyframe images itself.
        px0, desc0, img0, raw0, resp0 = self._mono_init
        ia, ib = match_descriptors(desc0, desc, max_dist=60, ratio=0.9)
        if len(ia) < 80:
            # Replace the init frame if matching degrades.
            if len(px) >= 100:
                self._mono_init = (px, desc, frame.image,
                                   getattr(frame, "raw_image", frame.image),
                                   self._last_resp)
            return None
        p0 = px0[ia].astype(np.float64)
        p1 = px[ib].astype(np.float64)
        parallax = np.linalg.norm(p1 - p0, axis=1)
        if np.median(parallax) < 12.0:
            return None
        E, mask = vision.find_essential_mat(p0, p1, self.K, prob=0.999,
                                            threshold=1.0)
        if E is None or E.shape != (3, 3):
            return None
        n_ok, R, t, mask = vision.recover_pose(E, p0, p1, self.K, mask=mask)
        if n_ok < 50:
            return None
        m = mask.ravel() > 0
        P0 = self.K @ np.eye(4)[:3]
        T1 = np.eye(4)
        T1[:3, :3] = R
        T1[:3, 3] = t.ravel()
        P1 = self.K @ T1[:3]
        pts4 = vision.triangulate_points(P0, P1, p0[m].T, p1[m].T)
        pts3 = (pts4[:3] / pts4[3:4]).T
        z0 = pts3[:, 2]
        z1 = (pts3 @ R.T + t.ravel())[:, 2]
        good = (z0 > 0.01) & (z1 > 0.01)
        if good.sum() < 40:
            return None
        pts3 = pts3[good]
        # Scale: unit median depth in the first camera.
        med = np.median(pts3[:, 2])
        if med <= 1e-6:
            return None
        pts3 = pts3 / med
        T1[:3, 3] /= med

        # Sub-map restarts seed the init at the last known pose so the new
        # map continues in (approximately) the old frame.
        T0 = np.eye(4)
        T1_rel = T1.copy()
        if self._submap_seed is not None:
            T0 = self._submap_seed.copy()
            self._submap_seed = None
            pts3 = (pts3 - T0[:3, 3]) @ T0[:3, :3]  # inv(T0) applied
            T1 = T1 @ T0

        # Build the two keyframes + map points.
        sel0 = ia[m][good]
        sel1 = ib[m][good]
        u = np.clip(px0[sel0, 0].astype(np.int64), 0, self.camera.width - 1)
        v = np.clip(px0[sel0, 1].astype(np.int64), 0, self.camera.height - 1)
        colors = img0[:, v, u].T.astype(np.float32)

        kfid0 = self._new_kfid()
        ids = self.map.add_points(pts3, desc0[sel0], colors, kfid0)
        mp0 = np.full(len(px0), -1, np.int64)
        mp0[sel0] = ids
        node0 = KeyframeNode(kfid=kfid0, tcw=T0, kps_px=px0,
                             desc=desc0, mp_ids=mp0, image=img0, resp=resp0)
        self.map.add_keyframe(node0)
        self._register_kf(node0)

        kfid1 = self._new_kfid()
        mp1 = np.full(len(px), -1, np.int64)
        mp1[sel1] = ids
        node1 = KeyframeNode(kfid=kfid1, tcw=T1.copy(), kps_px=px, desc=desc,
                             mp_ids=mp1, image=frame.image,
                             resp=self._last_resp)
        self.map.add_keyframe(node1)
        self._register_kf(node1)

        self.tcw = T1
        self.velocity = T1_rel
        self._mono_init = None
        ops = [
            self._make_local_ba_op([node0], new_points=pts3,
                                   new_colors=colors, frame=None,
                                   new_node=node0, image=raw0),
            self._make_local_ba_op([node1], new_points=np.zeros((0, 3)),
                                   new_colors=np.zeros((0, 3)), frame=frame,
                                   new_node=node1),
        ]
        return ops

    # ------------------------------------------------------------------
    # Keyframe machinery
    # ------------------------------------------------------------------

    def _new_kfid(self) -> int:
        kfid = self._kf_count
        self._kf_count += 1
        return kfid

    # ------------------------------------------------------------------
    # Asynchronous local mapping (worker thread)
    # ------------------------------------------------------------------

    def _lm_worker(self) -> None:
        """LocalMapping-thread role (reference: ORB-SLAM3/src/LocalMapping.cc
        Run loop): per new keyframe — map-point culling, windowed local BA,
        place-recognition indexing, LocalMappingBA op emission, and loop
        RETRIEVAL + geometric verification. Whole-map mutations (pose-graph
        correction, map merges) are NOT done here: a verified loop is posted
        to `_pending_loop` and applied by the tracking thread at the next
        frame boundary."""
        while True:
            job = self._kf_jobs.get()
            try:
                if job is None:
                    return
                jmap, node, frame, new_world, new_colors = job
                if jmap is not self.map:
                    continue  # map was stashed/merged since enqueue
                with self._lock:
                    self.map.cull_points(node.kfid)
                window = self._run_local_ba(node)
                self._register_kf_db(node)
                self._emit_op(self._make_local_ba_op(
                    window, new_world, new_colors, frame, node))
                if self.enable_loop_closing and self._pending_loop is None:
                    found = self._verify_loop(node)
                    if found is not None:
                        self._pending_loop = (node, found)
            except BaseException as e:  # surfaced by flush()
                self._lm_exc = e
            finally:
                self._kf_jobs.task_done()

    def _emit_op(self, op: Optional[MappingOperation]) -> None:
        if op is None:
            return
        cb = self._push_cb
        if cb is not None:
            cb(op)
        else:
            with self._lock:
                self._pending_ops.append(op)

    def _apply_pending(self) -> list[MappingOperation]:
        """Tracking-thread application of worker results: queued ops, the
        local-BA pose correction for the live pose, and a verified loop
        (pose graph / merge — the whole-map mutations stay on this thread)."""
        if self._lm_exc is not None:
            # Surface a dead local-mapping pipeline within a frame instead of
            # silently degrading tracking for the whole run (flush() only
            # runs at sequence end).
            e, self._lm_exc = self._lm_exc, None
            raise e
        ops: list[MappingOperation] = []
        with self._lock:
            if self._pending_ops:
                ops, self._pending_ops = self._pending_ops, []
            fix, self._pending_pose_fix = self._pending_pose_fix, None
        if fix is not None:
            self.tcw = fix @ self.tcw
        if self._pending_loop is not None:
            node, found = self._pending_loop
            self._pending_loop = None
            with self._lock:
                op = self._apply_loop(node, *found)
            if op is not None:
                ops.append(op)
        return ops

    def flush(self) -> None:
        """Drain the local-mapping queue and surface worker errors — call
        before reading final poses/trajectory."""
        if self._kf_jobs is not None:
            self._kf_jobs.join()
        if self._lm_exc is not None:
            e, self._lm_exc = self._lm_exc, None
            raise e

    def close(self) -> None:
        """Stop the local-mapping worker (idempotent)."""
        if self._lm_thread is not None and self._lm_thread.is_alive():
            self._kf_jobs.put(None)
            self._lm_thread.join(timeout=30.0)

    def _register_kf(self, node: KeyframeNode) -> None:
        self.last_kfid = node.kfid
        self.live_kf_ids.add(node.kfid)
        self.frames_since_kf = 0
        self.ref_tracked = int((node.mp_ids >= 0).sum())
        self._register_kf_db(node)

    def _register_kf_db(self, node: KeyframeNode) -> None:
        # Every keyframe enters the place-recognition database even while
        # detection is disabled (the reference's KeyFrameDatabase likewise
        # receives all keyframes) — detection toggles querying, not indexing.
        # Keep the STRONGEST 300 descriptors (by detector response when
        # available), plus a majority-bit signature for O(1) candidate
        # prefiltering (the compact stand-in for DBoW2's inverted index).
        # Sort by the node's OWN extraction-time responses — not the
        # frontend-global last extraction, which can belong to a different
        # frame (e.g. node0 in _init_mono).
        desc = node.desc
        resp = node.resp
        if resp is not None and len(resp) == len(desc):
            desc = desc[np.argsort(-resp)]
        db = desc[:300].copy()
        with self._lock:
            self._loop_db[node.kfid] = db
            if len(db):
                bits = np.unpackbits(db, axis=1)
                self._loop_sigs[node.kfid] = np.packbits(
                    bits.mean(axis=0) >= 0.5)
                self.kfdb.add(node.kfid, db)

    def _local_3d_of(self, node: KeyframeNode) -> np.ndarray:
        """Camera-local 3D per keypoint (0 where unknown) — the
        KeyFrame::GetKeypointInfo contract (reference:
        ORB-SLAM3/src/KeyFrame.cc:1169-1196)."""
        local = np.zeros((len(node.kps_px), 3), np.float32)
        with self._lock:
            has = node.mp_ids >= 0
            if has.any():
                xyz = self.map.xyz[node.mp_ids[has]]
                xc = xyz @ node.tcw[:3, :3].T + node.tcw[:3, 3]
                local[has] = xc.astype(np.float32)
        return local

    def _make_local_ba_op(self, window_nodes, new_points, new_colors, frame,
                          new_node, image=None) -> MappingOperation:
        kfs = []
        for node in window_nodes:
            # Snapshot the pose under the lock: scale normalization / loop
            # correction mutate node.tcw in place on the tracking thread
            # while the async worker builds ops.
            with self._lock:
                tcw = node.tcw.copy()
            quat = rotmat_to_quat_numpy(tcw[:3, :3])
            is_new = node.kfid == new_node.kfid
            kfs.append(KeyframeData(
                kfid=node.kfid, camera_id=self.camera.camera_id,
                quat_wxyz=quat, trans=tcw[:3, 3],
                image=(image if image is not None else
                       (getattr(frame, "raw_image", frame.image)
                        if frame is not None else None))
                if is_new else None,
                aux_image=(node.depth if is_new else None),
                kps_pixel=node.kps_px if is_new else None,
                kps_point_local=self._local_3d_of(node) if is_new else None,
                filename=(frame.filename if (is_new and frame is not None)
                          else ""),
            ))
        return MappingOperation(
            kind=OprType.LOCAL_MAPPING_BA, keyframes=kfs,
            points=np.asarray(new_points, np.float32),
            colors=np.asarray(new_colors, np.float32))

    def _create_keyframe(self, frame, px, desc, mp_of_feat, depth_map):
        """Insert a keyframe: associate tracked points, create new map
        points, cull, run local BA, emit the LocalMappingBA operation.
        With async local mapping the tail (cull/BA/loop/op) moves to the
        worker thread and this returns None; the map-point INSERT stays
        synchronous because the very next frame tracks against it."""
        kfid = self._new_kfid()
        mp_ids = mp_of_feat.copy()
        node = KeyframeNode(kfid=kfid, tcw=self.tcw.copy(), kps_px=px,
                            desc=desc, mp_ids=mp_ids, image=frame.image,
                            depth=depth_map, resp=self._last_resp)

        # New map points from unmatched features.
        new_world = np.zeros((0, 3), np.float64)
        new_colors = np.zeros((0, 3), np.float32)
        free = mp_ids < 0
        with self._lock:
            if depth_map is not None and free.any():
                d, ok, u, v = self._depth_at(depth_map, px)
                sel = np.where(free & ok)[0]
                if len(sel) > self.max_new_points_per_kf:
                    sel = np.random.RandomState(kfid).choice(
                        sel, self.max_new_points_per_kf, replace=False)
                if len(sel):
                    local = self._backproject(px[sel], d[sel])
                    twc = se3_inverse(self.tcw)
                    new_world = local @ twc[:3, :3].T + twc[:3, 3]
                    new_colors = frame.image[:, v[sel], u[sel]].T.astype(
                        np.float32)
                    ids = self.map.add_points(new_world, desc[sel],
                                              new_colors, kfid)
                    mp_ids[sel] = ids
            elif self.sensor == "mono" and free.any():
                new_world, new_colors = self._triangulate_new_points(
                    node, free)

            self.map.add_keyframe(node)
            # Tracking-state updates stay synchronous: the next frame's
            # matcher keys off last_kfid / ref_tracked. (Must come AFTER
            # _triangulate_new_points, which matches against the PREVIOUS
            # keyframe via last_kfid.)
            self.last_kfid = node.kfid
            self.live_kf_ids.add(node.kfid)
            self.frames_since_kf = 0
            self.ref_tracked = int((node.mp_ids >= 0).sum())

        if self.async_local_mapping:
            self._kf_jobs.put((self.map, node, frame, new_world, new_colors))
            return None
        self.map.cull_points(kfid)
        window = self._run_local_ba(node)
        self._register_kf_db(node)
        return self._make_local_ba_op(window, new_world, new_colors, frame,
                                      node)

    def _triangulate_new_points(self, node: KeyframeNode, free: np.ndarray):
        """Monocular new-point triangulation against the previous keyframe
        (the role of LocalMapping::CreateNewMapPoints)."""
        prev = self.map.keyframes.get(self.last_kfid)
        if prev is None:
            return np.zeros((0, 3)), np.zeros((0, 3), np.float32)
        free_prev = prev.mp_ids < 0
        if not free_prev.any() or not free.any():
            return np.zeros((0, 3)), np.zeros((0, 3), np.float32)
        ia, ib = match_descriptors(prev.desc[free_prev], node.desc[free],
                                   max_dist=50, ratio=0.8)
        if len(ia) < 10:
            return np.zeros((0, 3)), np.zeros((0, 3), np.float32)
        idx_prev = np.where(free_prev)[0][ia]
        idx_cur = np.where(free)[0][ib]
        P0 = self.K @ prev.tcw[:3]
        P1 = self.K @ node.tcw[:3]
        p0 = prev.kps_px[idx_prev].astype(np.float64)
        p1 = node.kps_px[idx_cur].astype(np.float64)
        pts4 = vision.triangulate_points(P0, P1, p0.T, p1.T)
        w = pts4[3:4]
        w = np.where(np.abs(w) > 1e-9, w, 1e-9)
        pts3 = (pts4[:3] / w).T
        z0 = (pts3 @ prev.tcw[:3, :3].T + prev.tcw[:3, 3])[:, 2]
        z1 = (pts3 @ node.tcw[:3, :3].T + node.tcw[:3, 3])[:, 2]
        uv0, _ = self._project(prev.tcw, pts3)
        uv1, _ = self._project(node.tcw, pts3)
        err0 = np.linalg.norm(uv0 - p0, axis=1)
        err1 = np.linalg.norm(uv1 - p1, axis=1)
        good = (z0 > self.min_depth) & (z1 > self.min_depth) & (
            err0 < 2.0) & (err1 < 2.0) & (z0 < self.max_depth * 2)
        if not good.any():
            return np.zeros((0, 3)), np.zeros((0, 3), np.float32)
        pts3 = pts3[good]
        idx_prev, idx_cur = idx_prev[good], idx_cur[good]
        u = np.clip(node.kps_px[idx_cur, 0].astype(np.int64), 0,
                    self.camera.width - 1)
        v = np.clip(node.kps_px[idx_cur, 1].astype(np.int64), 0,
                    self.camera.height - 1)
        colors = (node.image[:, v, u].T.astype(np.float32)
                  if node.image is not None
                  else np.zeros((len(u), 3), np.float32))
        ids = self.map.add_points(pts3, node.desc[idx_cur], colors,
                                  node.kfid)
        node.mp_ids[idx_cur] = ids
        prev.mp_ids[idx_prev] = ids
        for mp, kp in zip(ids, idx_prev):
            self.map.add_observation(int(mp), prev.kfid, int(kp))
        return pts3, colors

    def _run_ba(self, all_ids: list[int], n_fixed: int,
                max_iters: int = 8) -> bool:
        """Bundle-adjust the given keyframes (first `n_fixed` held fixed) and
        every map point they observe; writes results back into the map.
        Returns False if the problem was too small to solve."""
        cam = self.camera
        # Observation build + write-back run under the map lock; the native
        # solve (the expensive part — ctypes releases the GIL) runs outside
        # it so an async worker's BA never stalls the tracking thread.
        with self._lock:
            pt_ids = self.map.point_ids_of_kfs(all_ids)
            if len(pt_ids) < 20:
                return False
            # Vectorized observation build (the per-feature Python loop this
            # replaces cost ~10 ms per BA call at 1000 features x 8 kfs):
            # mp id -> slot via one searchsorted per keyframe.
            pt_arr = np.asarray(pt_ids, np.int64)
            sort_idx = np.argsort(pt_arr)
            sorted_pt = pt_arr[sort_idx]
            obs_pose, obs_point, obs_uv, obs_d, obs_w = [], [], [], [], []
            for kslot, kfid in enumerate(all_ids):
                kf = self.map.keyframes[kfid]
                mp = np.asarray(kf.mp_ids, np.int64)
                pos = np.clip(np.searchsorted(sorted_pt, mp), 0,
                              len(sorted_pt) - 1)
                hit = (mp >= 0) & (sorted_pt[pos] == mp)
                kp_idx = np.nonzero(hit)[0]
                if len(kp_idx) == 0:
                    continue
                uv = kf.kps_px[kp_idx]
                # Depth constraint where the sensor measured it (the role of
                # ORB-SLAM3's stereo/RGBD BA edges): weight ~ fx/d maps the
                # depth residual to pixel-comparable units.
                if kf.depth is not None:
                    u = np.clip(uv[:, 0].astype(np.int64), 0, cam.width - 1)
                    v = np.clip(uv[:, 1].astype(np.int64), 0, cam.height - 1)
                    d = kf.depth[v, u].astype(np.float64)
                else:
                    d = np.zeros(len(kp_idx))
                good = (d > self.min_depth) & (d < self.max_depth)
                obs_pose.append(np.full(len(kp_idx), kslot, np.int64))
                obs_point.append(sort_idx[pos[kp_idx]])
                obs_uv.append(uv)
                obs_d.append(np.where(good, d, 0.0))
                obs_w.append(np.where(good, cam.fx / np.maximum(d, 1e-9),
                                      0.0))
            n_obs = sum(len(p) for p in obs_pose)
            if n_obs < 40:
                return False
            poses = np.stack([self.map.keyframes[k].tcw for k in all_ids])
            xyz0 = self.map.xyz[pt_ids].copy()
            version = self._map_version
            bamap = self.map
        t0 = time.perf_counter()
        _, P, X = local_ba(poses, n_fixed, xyz0,
                           np.concatenate(obs_pose),
                           np.concatenate(obs_point),
                           np.concatenate(obs_uv), cam.fx, cam.fy, cam.cx,
                           cam.cy, max_iters=max_iters,
                           obs_depth=np.concatenate(obs_d),
                           obs_depth_weight=np.concatenate(obs_w))
        self.stage_times["ba"].append(time.perf_counter() - t0)
        with self._lock:
            if bamap is not self.map or version != self._map_version:
                # A whole-map transform (loop correction, scale normalize,
                # map swap) landed while the solve ran on the old gauge:
                # discard the stale solution rather than corrupt the map.
                return False
            for k, kfid in enumerate(all_ids):
                if k >= n_fixed:
                    self.map.keyframes[kfid].tcw = P[k]
            self.map.xyz[pt_ids] = X
        return True

    def _run_local_ba(self, node: KeyframeNode) -> list[KeyframeNode]:
        """Windowed BA over the keyframes COVISIBLE with the new one; other
        keyframes observing the window's points (up to 2, by covisibility)
        act as fixed anchors (reference: ORB-SLAM3/src/Optimizer.cc:1116
        LocalBundleAdjustment optimizes the covisible set — on revisits this
        re-optimizes old keyframes seeing the same structure, which a
        recency window never would)."""
        with self._lock:
            covis = self.map.covisible_kfs(node.kfid, min_shared=15)
            free_ids = sorted({node.kfid, *covis[:self.ba_window - 1]})
            # Anchors: the strongest covisible keyframes left out of the
            # window, falling back to the newest non-window keyframes.
            outside = [k for k in covis if k not in free_ids]
            outside += [k for k in sorted(self.map.keyframes, reverse=True)
                        if k not in free_ids and k not in outside]
        anchor_ids = outside[:2]
        all_ids = anchor_ids + free_ids
        n_fixed = len(anchor_ids)
        if len(free_ids) < 2:
            return [node]
        # ALWAYS anchor >= 2 poses: with a single anchor and free landmarks
        # the problem has a scale gauge (the BA can silently rescale the
        # map, which then drifts every subsequent PnP pose). With <= 2
        # keyframes total this makes the BA points-only — fine.
        while n_fixed < min(2, len(all_ids)):
            n_fixed += 1
        with self._lock:
            tcw_before = node.tcw.copy()
            version_before = self._map_version
        if self._run_ba(all_ids, n_fixed):
            with self._lock:
                if version_before != self._map_version:
                    # A whole-map transform landed between the tcw_before
                    # snapshot and the BA write-back: tcw_before is in the
                    # old gauge, the solution in the new — a delta mixing
                    # the two would corrupt self.tcw. Drop the fix (the next
                    # PnP/BA re-converges).
                    return [self.map.keyframes[k] for k in free_ids]
                new_tcw = self.map.keyframes[node.kfid].tcw
                if threading.current_thread() is self._lm_thread:
                    # The tracking thread owns self.tcw (it has advanced
                    # past this keyframe): hand it the left-multiplicative
                    # delta to apply at the next frame boundary. Compose
                    # with an unconsumed pending fix instead of losing it.
                    delta = new_tcw @ se3_inverse(tcw_before)
                    prev = self._pending_pose_fix
                    self._pending_pose_fix = (delta if prev is None
                                              else delta @ prev)
                else:
                    self.tcw = new_tcw.copy()
        return [self.map.keyframes[k] for k in free_ids]

    # ------------------------------------------------------------------
    # Loop closing
    # ------------------------------------------------------------------

    def _detect_loop(self, node: KeyframeNode) -> Optional[MappingOperation]:
        """Descriptor-voting place recognition + PnP verification + SE3
        pose-graph correction (reference: ORB-SLAM3/src/LoopClosing.cc).

        Returns the LoopClosingBA operation if a loop is accepted. (With
        async local mapping, _verify_loop runs on the worker thread and
        _apply_loop on the tracking thread at the next frame boundary.)"""
        found = self._verify_loop(node)
        if found is None:
            return None
        return self._apply_loop(node, *found)

    def _verify_loop(self, node: KeyframeNode) -> Optional[tuple]:
        """Read-only loop detection: retrieval + descriptor vote + PnP
        verification. Returns (best_kfid, R, tvec, inliers, ib, obj,
        matched_pt_ids) for _apply_loop, or None."""
        # Cooldown after a closed loop (the reference skips detection until
        # mnLastLoopKFid + 10, LoopClosing::DetectLoop): the correction
        # already pulled the whole graph; immediate re-detections would spam
        # near-identity LoopClosingBA ops at the mapper.
        if node.kfid < self._last_loop_kfid + 10:
            return None
        with self._lock:
            exclude = set([node.kfid]
                          + self.map.covisible_kfs(node.kfid, 5))
            exclude.update(k for k in self.map.keyframes
                           if node.kfid - k <= self.ba_window + 4)
        best_kfid, best_score = -1, 0
        q = self._loop_db.get(node.kfid)
        qsig = self._loop_sigs.get(node.kfid)
        if q is None or qsig is None:
            return None
        # Stage 1 — retrieval: the TF-IDF bag-of-binary-words index (the
        # DBoW2 inverted-index role) with ORB-SLAM3's covisibility
        # normalization: a candidate must look at least as similar as the
        # query's WORST covisible neighbor (LoopClosing::DetectLoop's
        # minScore) — the guard that keeps repetitive texture from producing
        # false loops. Falls back to the majority-bit signature prefilter
        # until the vocabulary has trained. The full ratio-test match costs
        # ~10 ms/pair, so a linear descriptor scan would stall tracking.
        with self._lock:
            if self.kfdb.trained:
                cov_scores = [self.kfdb.score(node.kfid, c)
                              for c in self.map.covisible_kfs(node.kfid, 15)
                              if c in self.kfdb]
                min_score = min(cov_scores) if cov_scores else 0.0
                thr = max(min_score, self.loop_min_db_score)
                hits = self.kfdb.query(node.kfid, exclude=exclude, topk=8)
                cands = [k for k, s in hits if s >= thr][:5]
                self.loop_debug = {"db_hits": hits[:3],
                                   "min_score": min_score}
            else:
                cand_ids = [k for k in self._loop_db
                            if k not in exclude and k != node.kfid
                            and k in self._loop_sigs]
                if not cand_ids:
                    return None
                sigs = np.stack([self._loop_sigs[k] for k in cand_ids])
                sig_d = _sig_distances(qsig, sigs)
                cands = [cand_ids[int(j)] for j in np.argsort(sig_d)[:5]]
                self.loop_debug = {}
        for kfid in cands:
            ia, _ = match_descriptors(q, self._loop_db[kfid], max_dist=45,
                                      ratio=0.85)
            if len(ia) > best_score:
                best_score, best_kfid = len(ia), kfid
        self.loop_debug.update({"cand": best_kfid, "score": best_score})
        if best_kfid < 0 or best_score < self.loop_min_score:
            return None

        # Geometric verification: candidate's map points vs current features.
        # The candidate may live in a STASHED map (multi-map recovery): a
        # verified match then merges the active sub-map into it.
        cand_map = (self.map if best_kfid in self.map.keyframes
                    else self._find_map_of(best_kfid))
        if cand_map is None:
            return None
        with self._lock:
            cand = cand_map.keyframes[best_kfid]
            has_mp = cand.mp_ids >= 0
            if has_mp.sum() < 20:
                return None
            cand_desc = cand.desc[has_mp]
            cand_mp_ids = cand.mp_ids[has_mp].copy()
        ia, ib = match_descriptors(cand_desc, node.desc,
                                   max_dist=55, ratio=0.85)
        self.loop_debug["geo_matches"] = len(ia)
        if len(ia) < self.loop_min_inliers:
            return None
        matched_pt_ids = cand_mp_ids[ia]
        with self._lock:
            obj = cand_map.xyz[matched_pt_ids]
        img = node.kps_px[ib].astype(np.float64)
        ok, rvec, tvec, inliers = vision.solve_pnp_ransac(
            obj, img, self.K, reproj_err=5.0, iters=200)
        self.loop_debug["pnp_inliers"] = (0 if inliers is None
                                          else len(inliers))
        if not ok or inliers is None or len(inliers) < self.loop_min_inliers:
            return None
        R = vision.rodrigues(rvec)
        return best_kfid, R, tvec, inliers, ib, obj, matched_pt_ids

    def _apply_loop(self, node: KeyframeNode, best_kfid: int, R: np.ndarray,
                    tvec: np.ndarray, inliers: np.ndarray, ib: np.ndarray,
                    obj: np.ndarray,
                    matched_pt_ids: np.ndarray) -> Optional[MappingOperation]:
        """Apply a verified loop: Sim3/SE3 pose-graph correction (or map
        merge) + match fusion + global BA; emits the LoopClosingBA op. This
        is the whole-map mutation half of LoopClosing::CorrectLoop — with
        async local mapping it runs on the TRACKING thread at a frame
        boundary so tracking never races a moving gauge."""
        if node.kfid not in self.map.keyframes:
            return None  # map was swapped since verification
        cand_map = (self.map if best_kfid in self.map.keyframes
                    else self._find_map_of(best_kfid))
        if cand_map is None:
            return None
        self._map_version += 1  # stale concurrent BA solves must drop

        if cand_map is not self.map:
            return self._merge_maps(cand_map, node, best_kfid, R, tvec,
                                    inliers, ib, obj, matched_pt_ids)

        s_node = self._loop_scale(node, obj, inliers, ib, R, tvec)

        # Essential graph: sequential odometry edges + covisibility edges +
        # the loop edge (reference: ORB-SLAM3/src/Optimizer.cc:1762
        # OptimizeEssentialGraph — covisibility edges give non-chain
        # topologies a path to distribute the loop error).
        kf_ids = sorted(self.map.keyframes)
        idx = {k: i for i, k in enumerate(kf_ids)}
        poses_old = np.stack([self.map.keyframes[k].tcw for k in kf_ids])
        ei, ej, eT, es, ew = [], [], [], [], []

        def add_edge(b, a, T, s, w):
            ei.append(idx[b])
            ej.append(idx[a])
            eT.append(T)
            es.append(s)
            ew.append(w)

        for a, b in zip(kf_ids[:-1], kf_ids[1:]):
            add_edge(b, a, self.map.keyframes[b].tcw
                     @ se3_inverse(self.map.keyframes[a].tcw), 1.0, 1.0)
        seen_pairs = set(zip(kf_ids[:-1], kf_ids[1:]))
        for b in kf_ids:
            for a in self.map.covisible_kfs(b, min_shared=20)[:5]:
                if a >= b or (a, b) in seen_pairs:
                    continue
                seen_pairs.add((a, b))
                add_edge(b, a, self.map.keyframes[b].tcw
                         @ se3_inverse(self.map.keyframes[a].tcw), 1.0, 1.0)
        s_corr = Sim3(s_node, R, s_node * tvec.ravel())
        loop_edge = s_corr.compose(Sim3.from_se3(
            self.map.keyframes[best_kfid].tcw).inverse())
        loop_T = np.eye(4)
        loop_T[:3, :3] = loop_edge.R
        loop_T[:3, 3] = loop_edge.t
        add_edge(node.kfid, best_kfid, loop_T, loop_edge.s,
                 float(len(kf_ids)))  # strong loop edge

        if self.sensor == "mono":
            P, s_new = sim3_pose_graph_optimize(
                poses_old, np.ones(len(kf_ids)), 1,
                np.asarray(ei, np.int32), np.asarray(ej, np.int32),
                np.stack(eT), np.asarray(es), np.asarray(ew), max_iters=25)
        else:
            P = pose_graph_optimize(poses_old, 1, np.asarray(ei, np.int32),
                                    np.asarray(ej, np.int32), np.stack(eT),
                                    np.asarray(ew), max_iters=25)
            s_new = np.ones(len(kf_ids))

        # Correct map points by their first-observing keyframe's similarity
        # correction delta = S_new^-1 o S_old (scale 1/s_k shrinks scale-
        # inflated structure back to the anchor gauge; reference:
        # LoopClosing::CorrectLoop map-point Sim3 mapping).
        first = self.map.first_kf[:self.map._n]
        alive = self.map.alive[:self.map._n]
        kf_scales = {}
        for kfid in kf_ids:
            k = idx[kfid]
            s_k = float(s_new[k])
            kf_scales[kfid] = s_k
            sel = alive & (first == kfid)
            if not sel.any():
                continue
            s_new_sim = Sim3(s_k, P[k][:3, :3], s_k * P[k][:3, 3])
            delta = s_new_sim.inverse().compose(
                Sim3.from_se3(poses_old[k]))
            self.map.xyz[:self.map._n][sel] = delta.apply(
                self.map.xyz[:self.map._n][sel])
        for kfid in kf_ids:
            self.map.keyframes[kfid].tcw = P[idx[kfid]]
        self.loop_debug["s_node"] = s_node
        self.loop_debug["kf_scales"] = dict(kf_scales)
        # Global BA over the corrected graph (the role of
        # LoopClosing::RunGlobalBundleAdjustment): the pose graph distributes
        # the loop error smoothly along the chain, leaving residual
        # point/pose inconsistency that subsequent local windows would
        # otherwise re-absorb as drift. Anchor the two earliest keyframes
        # (gauge), refine everything else.
        # Fuse the verified matches (SearchAndFuse) so the BA below can SEE
        # the loop constraint, then two full-BA rounds: the pose graph
        # distributes the loop error smoothly, joint refinement over the
        # fused observations pins the loop neighborhood's gauge (the
        # reference's RunGlobalBundleAdjustment after CorrectLoop).
        self._fuse_matches(node, matched_pt_ids, inliers, ib)
        self._run_ba(kf_ids, n_fixed=min(2, len(kf_ids)), max_iters=15)
        self._run_ba(kf_ids, n_fixed=min(2, len(kf_ids)), max_iters=15)
        self.tcw = self.map.keyframes[node.kfid].tcw.copy()
        self.num_loops_closed += 1
        self._last_loop_kfid = node.kfid

        kfs = []
        for kfid in kf_ids:
            T = self.map.keyframes[kfid].tcw
            quat = rotmat_to_quat_numpy(T[:3, :3])
            kfs.append(KeyframeData(
                kfid=kfid, camera_id=self.camera.camera_id, quat_wxyz=quat,
                trans=T[:3, 3].copy(),
                is_loop_kf=kfid in (node.kfid, best_kfid),
                # The mapper's masked point transform multiplies points by
                # this scale — 1/s_k undoes the kf's drift inflation
                # (mapper._apply_loop_closing; reference:
                # src/gaussian_mapper.cpp:909-912).
                scale=1.0 / kf_scales[kfid]))
        return MappingOperation(kind=OprType.LOOP_CLOSING_BA, keyframes=kfs,
                                scale=1.0 / kf_scales[node.kfid])

    def _loop_scale(self, node: KeyframeNode, obj: np.ndarray,
                    inliers: np.ndarray, ib: np.ndarray, R: np.ndarray,
                    tvec: np.ndarray) -> float:
        """Relative loop scale (monocular drift): the PnP pose is scale-
        blind, but comparing the CURRENT map's depths of the matched
        features (drifted gauge, node.tcw) against the OLD map points'
        depths in the PnP-corrected camera (metric gauge) measures the
        local gauge ratio s = z_cur / z_old — the role of
        LoopClosing::ComputeSim3. The estimate is approximate (the two
        camera centers differ by the drift); the post-correction global BA
        over the FUSED loop matches (_fuse_matches) is what pins the final
        gauge, exactly as the reference's SearchAndFuse +
        RunGlobalBundleAdjustment do. (A camera-free Umeyama spread ratio
        was measured far worse here: monocular triangulation noise along
        the rays inflates the current cloud's spread by tens of percent.)
        Sensor depth is metric, so non-mono loops stay SE3."""
        if self.sensor != "mono":
            return 1.0
        inl = inliers.ravel()
        cur_mp = node.mp_ids[ib[inl]]
        have = cur_mp >= 0
        if have.sum() < 8:
            return 1.0
        x_cur = self.map.xyz[cur_mp[have]]
        z_cur = (x_cur @ node.tcw[:3, :3].T + node.tcw[:3, 3])[:, 2]
        z_old = (obj[inl][have] @ R.T + tvec.ravel())[:, 2]
        ok_z = (z_cur > 1e-6) & (z_old > 1e-6)
        if ok_z.sum() < 8:
            return 1.0
        return float(np.clip(np.median(z_cur[ok_z] / z_old[ok_z]),
                             0.25, 4.0))

    # ------------------------------------------------------------------
    # Multi-map recovery (reference: ORB-SLAM3 Atlas)
    # ------------------------------------------------------------------

    def _fuse_matches(self, node: KeyframeNode, matched_pt_ids: np.ndarray,
                      inliers: np.ndarray, ib: np.ndarray) -> None:
        """Fuse verified loop/merge matches into the active map (reference:
        ORB-SLAM3 SearchAndFuse): the node's features adopt the matched OLD
        map points, replacing any duplicated current points everywhere.
        These cross-gauge observations are what make the post-correction
        global BA scale-observable — without them the corrected segment's
        residual gauge is a zero-gradient direction."""
        m = self.map
        inl = inliers.ravel()
        for old_pt, feat in zip(matched_pt_ids[inl].tolist(),
                                ib[inl].tolist()):
            old_pt = int(old_pt)
            if not m.alive[old_pt]:
                continue
            cur = int(node.mp_ids[feat])
            if cur == old_pt:
                continue
            if cur >= 0:
                # Replace the duplicated point everywhere it is observed.
                for kfid2, kp2 in list(m.obs[cur].items()):
                    kf2 = m.keyframes.get(kfid2)
                    if kf2 is not None and kf2.mp_ids[kp2] == cur:
                        kf2.mp_ids[kp2] = old_pt
                        m.add_observation(old_pt, kfid2, kp2)
                m.alive[cur] = False
                m.obs[cur] = {}
            else:
                node.mp_ids[feat] = old_pt
                m.add_observation(old_pt, node.kfid, feat)

    def _find_map_of(self, kfid: int) -> Optional[LocalMap]:
        for m in self._old_maps:
            if kfid in m.keyframes:
                return m
        return None

    def _start_submap(self) -> None:
        """Persistent tracking loss: stash the active map and start a fresh
        one seeded at the last known pose; a later loop-style detection
        against a stashed map merges them (reference: ORB-SLAM3
        Atlas::CreateNewMap when relocalization keeps failing)."""
        with self._lock:
            self._map_version += 1
            self._old_maps.append(self.map)
            self.map = LocalMap()
            self._submap_seed = self.tcw.copy()
            self._mono_init = None
            self.velocity = np.eye(4)
            self.lost_frames = 0
            self.frames_since_kf = 0
            self.ref_tracked = 0

    def _merge_maps(self, target: LocalMap, node: KeyframeNode,
                    best_kfid: int, R: np.ndarray, tvec: np.ndarray,
                    inliers: np.ndarray, ib: np.ndarray,
                    obj: np.ndarray,
                    matched_pt_ids: np.ndarray) -> MappingOperation:
        """Merge the active sub-map into the stashed map containing the
        verified loop candidate (reference: ORB-SLAM3 LoopClosing::MergeLocal
        over the Atlas). The sub-map is internally consistent, so ONE
        similarity (PnP pose + mono depth-ratio scale) aligns every sub-map
        keyframe and point; the emitted LoopClosingBA op carries the
        corrected poses + scale so the mapper's gaussians follow."""
        sub = self.map
        s_node = self._loop_scale(node, obj, inliers, ib, R, tvec)
        s_corr = Sim3(s_node, R, s_node * tvec.ravel())
        # World-frame sub-map correction: X' = delta(X), scale 1/s_node.
        delta = s_corr.inverse().compose(Sim3.from_se3(node.tcw))

        n = sub._n
        live = sub.alive[:n]
        sub.xyz[:n][live] = delta.apply(sub.xyz[:n][live])
        for kf in sub.keyframes.values():
            kf.tcw = Sim3(1.0 / s_node, kf.tcw[:3, :3],
                          kf.tcw[:3, 3] / s_node).compose(
                delta.inverse()).to_se3()

        # Move the sub-map's live points + keyframes into the target.
        ids_old = np.where(live)[0]
        remap: dict[int, int] = {}
        if len(ids_old):
            new_ids = target.add_points(sub.xyz[:n][live],
                                        sub.desc[:n][live],
                                        sub.color[:n][live], 0)
            target.first_kf[new_ids] = sub.first_kf[:n][live]
            remap = dict(zip(ids_old.tolist(), new_ids.tolist()))
        sub_ids = sorted(sub.keyframes)
        for kfid in sub_ids:
            kf = sub.keyframes[kfid]
            kf.mp_ids = np.array([remap.get(int(m), -1) for m in kf.mp_ids],
                                 np.int64)
            target.add_keyframe(kf)
        self._old_maps.remove(target)
        self.map = target
        self.tcw = target.keyframes[node.kfid].tcw.copy()
        self.velocity = np.eye(4)
        self.num_maps_merged += 1
        self._last_loop_kfid = node.kfid

        self._fuse_matches(node, matched_pt_ids, inliers, ib)

        # Weld the junction: BA over the loop candidate's neighborhood +
        # the sub-map, anchored on the old side.
        old_side = [best_kfid] + [k for k in
                                  target.covisible_kfs(best_kfid, 15)
                                  if k not in sub_ids][:3]
        self._run_ba(old_side + sub_ids, n_fixed=min(2, len(old_side)),
                     max_iters=15)
        self.tcw = target.keyframes[node.kfid].tcw.copy()

        kfs = []
        for kfid in sub_ids:
            T = target.keyframes[kfid].tcw
            kfs.append(KeyframeData(
                kfid=kfid, camera_id=self.camera.camera_id,
                quat_wxyz=rotmat_to_quat_numpy(T[:3, :3]),
                trans=T[:3, 3].copy(),
                is_loop_kf=kfid in (node.kfid, best_kfid),
                scale=delta.s))
        return MappingOperation(kind=OprType.LOOP_CLOSING_BA,
                                keyframes=kfs, scale=delta.s)

    def _maybe_normalize_scale(self) -> Optional[MappingOperation]:
        """Monocular gauge watchdog: two-view init fixes the map scale to
        unit median depth (Tracking::MonocularInitialization), but
        accumulated drift can carry the gauge far from it, degrading the
        fixed metric thresholds (max_depth cutoffs, BA depth gates). When
        the live median depth leaves [0.2, 5], renormalize the WHOLE world
        (a pure gauge change — exact for every point, pose and gaussian)
        and emit a ScaleRefinement op so the mapper's model follows
        (consumer: mapper._apply_scale_refinement; the reference pushes the
        same op after IMU scale estimation,
        ORB-SLAM3/src/LocalMapping.cc:1300-1305)."""
        if self._old_maps:
            # Gaussians from stashed maps live in other frames: a global
            # rescale would be wrong for them.
            return None
        n = self.map._n
        live = self.map.alive[:n]
        if live.sum() < 50:
            return None
        z = (self.map.xyz[:n][live] @ self.tcw[:3, :3].T
             + self.tcw[:3, 3])[:, 2]
        z = z[z > 1e-6]
        if len(z) < 50:
            return None
        med = float(np.median(z))
        if 0.2 <= med <= 5.0:
            return None
        s = 1.0 / med
        with self._lock:
            self._map_version += 1  # whole-map gauge change
            self.map.xyz[:n] *= s
            for kf in self.map.keyframes.values():
                kf.tcw[:3, 3] *= s
            self.tcw[:3, 3] *= s
            self.velocity[:3, 3] *= s
        return MappingOperation(kind=OprType.SCALE_REFINEMENT, scale=s,
                                transform=np.eye(4, dtype=np.float32))

    # ------------------------------------------------------------------
    # Relocalization
    # ------------------------------------------------------------------

    def _relocalize(self, px, desc) -> bool:
        """Signature-prefiltered relocalization: rank the active map's
        keyframes by majority-bit signature Hamming distance (one vectorized
        pass), then ratio-match only the top candidates — O(candidates), not
        O(N_kf) full descriptor scans (reference: Tracking::Relocalization
        likewise asks the DBoW2 inverted index for candidates first)."""
        if len(desc) == 0:
            return False
        q = desc
        resp = self._last_resp
        if resp is not None and len(resp) == len(q):
            q = q[np.argsort(-resp)]
        with self._lock:
            if self.kfdb.trained:
                hits = self.kfdb.query(q[:300], topk=12)
                cands = [k for k, _ in hits if k in self.map.keyframes][:5]
            else:
                qsig = np.packbits(
                    np.unpackbits(q[:300], axis=1).mean(axis=0) >= 0.5)
                cand_ids = [k for k in self.map.keyframes
                            if k in self._loop_sigs]
                if not cand_ids:
                    return False
                sigs = np.stack([self._loop_sigs[k] for k in cand_ids])
                sig_d = _sig_distances(qsig, sigs)
                cands = [cand_ids[int(j)] for j in np.argsort(sig_d)[:5]]
        best_kfid, best_matches = -1, None
        for kfid in cands:
            kf = self.map.keyframes[kfid]
            has = kf.mp_ids >= 0
            if has.sum() < 20:
                continue
            ia, ib = match_descriptors(kf.desc[has], desc, max_dist=55,
                                       ratio=0.8)
            if best_matches is None or len(ia) > len(best_matches[0]):
                best_matches = (ia, ib, has)
                best_kfid = kfid
        if best_kfid < 0 or best_matches is None:
            return False
        ia, ib, has = best_matches
        if len(ia) < 20:
            return False
        with self._lock:
            kf = self.map.keyframes[best_kfid]
            obj = self.map.xyz[kf.mp_ids[has][ia]]
        img = px[ib].astype(np.float64)
        ok, rvec, tvec, inliers = vision.solve_pnp_ransac(
            obj, img, self.K, reproj_err=5.0, iters=200)
        if not ok or inliers is None or len(inliers) < 15:
            return False
        R = vision.rodrigues(rvec)
        self.tcw = np.eye(4)
        self.tcw[:3, :3] = R
        self.tcw[:3, 3] = tvec.ravel()
        self.velocity = np.eye(4)
        self.lost_frames = 0
        return True

    # ------------------------------------------------------------------
    # Main entry
    # ------------------------------------------------------------------

    def process_frame(self, frame: Frame) -> list[MappingOperation]:
        """Track one frame; returns the mapping operations to push."""
        t0 = time.perf_counter()
        for stage in ("orb", "match", "pnp"):
            self.stage_times[stage].append(0.0)
        try:
            # Worker results (queued ops, BA pose fix, verified loop) land
            # at the frame boundary, BEFORE this frame's pose prediction —
            # so tracking never races a moving gauge mid-frame.
            ops = (self._apply_pending() if self.async_local_mapping
                   else [])
            ops.extend(self._process_frame(frame))
            return ops
        finally:
            # Per-frame tracking wall time (the reference's TrackingTime.txt,
            # examples/replica_rgbd.cpp:164-172).
            self.track_times.append(time.perf_counter() - t0)

    def _process_frame(self, frame: Frame) -> list[MappingOperation]:
        self._frame_idx += 1
        px, desc, resp = self._extract(frame)
        self._last_resp = resp
        self._frame_grid = None
        # Latest frame + keypoints for the viewer's SLAM-frame panel
        # (reference: viewer/imgui_viewer.cpp:341-382 frame view).
        self.last_frame_vis = (frame.image, px)
        depth_map = self._depth_of(frame) if self.sensor != "mono" else None

        # Initialization.
        if not self.map.keyframes:
            if self.sensor == "mono":
                ops = self._init_mono(frame, px, desc)
                self._append_traj(frame)
                return ops if ops else []
            if depth_map is None or len(px) < 20:
                self._append_traj(frame)
                return []
            op = self._init_with_depth(frame, px, desc, depth_map)
            self._append_traj(frame)
            return [op] if op else []

        # Predicted pose (constant velocity); local-map tracking.
        tcw_pred = self.velocity @ self.tcw
        mp_of_feat, n_match = self._timed("match", self._track_local_map,
                                          px, desc, tcw_pred)
        tcw = None
        if n_match >= 6:
            tcw, n_inl, _ = self._timed("pnp", self._pose_from_matches, px,
                                        mp_of_feat, tcw_pred)
        if tcw is None:
            # Retry with a wider search from the unpredicted pose.
            mp_of_feat, n_match = self._timed(
                "match", self._track_local_map, px, desc, self.tcw)
            if n_match >= 6:
                tcw, n_inl, _ = self._timed("pnp", self._pose_from_matches,
                                            px, mp_of_feat, self.tcw)
        if tcw is None:
            # Wide-baseline fallback (TrackReferenceKeyFrame).
            mp_of_feat, n_match = self._timed(
                "match", self._track_reference_kf, px, desc)
            if n_match >= 6:
                tcw, n_inl, _ = self._timed("pnp", self._pose_from_matches,
                                            px, mp_of_feat, self.tcw)
        if tcw is None:
            self.lost_frames += 1
            if self.lost_frames >= 2 and self._relocalize(px, desc):
                self.num_relocalizations += 1
                mp_of_feat, n_match = self._timed(
                    "match", self._track_local_map, px, desc, self.tcw)
                tcw, n_inl, _ = self._timed("pnp", self._pose_from_matches,
                                            px, mp_of_feat, self.tcw)
            if tcw is None:
                self._append_traj(frame)
                # Persistent loss beyond relocalization: start a fresh
                # sub-map instead of dropping every remaining frame
                # (reference: ORB-SLAM3 Atlas CreateNewMap on lost).
                if (self.lost_frames >= self.submap_after_lost
                        and len(self.map.keyframes) >= 2):
                    self._start_submap()
                return []
        self.lost_frames = 0
        self.velocity = tcw @ se3_inverse(self.tcw)
        self.tcw = tcw
        self._append_traj(frame)
        self.tracked_frames += 1
        tracked = int((mp_of_feat >= 0).sum())

        # Keyframe decision.
        self.frames_since_kf += 1
        need_kf = self.frames_since_kf >= self.kf_min_interval and (
            tracked < self.kf_tracked_ratio * max(self.ref_tracked, 1)
            or tracked < 2 * self.min_tracked
            or self.frames_since_kf >= self.kf_max_interval)
        if not need_kf:
            return []
        if self.sensor != "mono" and depth_map is None:
            return []
        op = self._create_keyframe(frame, px, desc, mp_of_feat, depth_map)
        ops = [op] if op is not None else []
        # With async local mapping the worker thread runs loop RETRIEVAL +
        # verification per keyframe; the tracking thread applies the result
        # at the next frame boundary (_apply_pending).
        if self.enable_loop_closing and not self.async_local_mapping:
            loop_op = self._detect_loop(
                self.map.keyframes[self.last_kfid])
            if loop_op is not None:
                ops.append(loop_op)
        if self.sensor == "mono":
            sr = self._maybe_normalize_scale()
            if sr is not None:
                ops.append(sr)
        return ops

    def _append_traj(self, frame: Frame) -> None:
        self.trajectory.append(self.tcw.copy())
        ts = getattr(frame, "timestamp", None)
        # Explicit None check: a legitimate timestamp of exactly 0.0 is falsy.
        self.traj_times.append(ts if ts is not None
                               else float(len(self.trajectory) - 1))

    def run(self, frames, push) -> None:
        """Drive the whole sequence, pushing ops to the mapper queue. With
        async local mapping the worker emits its LocalMappingBA ops straight
        into `push` (it must be thread-safe — queue.Queue in the apps)."""
        self._push_cb = push
        try:
            for frame in frames:
                for op in self.process_frame(frame):
                    push(op)
            if self.async_local_mapping:
                # Drain the worker so the final trajectory includes the last
                # BA, then apply/emit whatever it left pending.
                self.flush()
                for op in self._apply_pending():
                    push(op)
        finally:
            self._push_cb = None
            self.close()
        self.done = True
