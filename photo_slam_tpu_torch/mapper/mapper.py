"""GaussianMapper: the online photorealistic-mapping orchestrator.

Counterpart of photo_slam_tpu/mapper/mapper.py (reference:
src/gaussian_mapper.cpp, 2,055 LoC): consumes MappingOperations from a
tracker (live or replayed), keeps the keyframe scene and the Gaussian map on
one device, and runs the 3-phase online training loop
(reference run(): src/gaussian_mapper.cpp:371-542):

  phase 1  wait for >= min_num_initial_map_kfs keyframes, then initialize the
           map from the cached sparse points (createFromPcd + trainingSetup);
  phase 2  drain the op queue (+ optional keyframe culling), then run one
           training iteration per pass until the tracker shuts down;
  phase 3  tail optimization while inside the densification window, then
           render and record all keyframes and save the final PLY.

The map lives on `device`, and every render and train step runs through
the kernel path (ops/render.py, mode "pallas"). The per-sensor
inactive-geometry densification works on a keyframe's host arrays (its
keypoints, depth and image), so its small tensor ops run on the CPU and
only the harvested points go to the device (trainer.increase_pcd). Stereo
depth comes from the port's semi-global matching on the mapper's device
(ops/stereo.py, the sgm kernel on a card), OpenCV's StereoSGBM's function.

The map is written in place (Adam) and swapped (capacity growth, the
mapping ops), so unlike the JAX package's immutable state it needs the
reference's render mutex (mutex_render_, src/gaussian_mapper.cpp:1549):
`render_lock` is held around every write of the map (the trainer's state
lock) and around each mapping op, and render_from_pose holds it while it
reads the map and enqueues its render on the mapper's stream. The
correction ops' map transforms replay from the trainer's StepGraphs
(graphed on a card, as the JAX package jits them).
"""
from __future__ import annotations

import contextlib
import json
import time
from enum import Enum
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from photo_slam_tpu_torch.config import Config
from photo_slam_tpu_torch.mapper.mapping_ops import (KeyframeData,
                                                     MappingOpQueue,
                                                     MappingOperation, OprType)
from photo_slam_tpu_torch.mapper.trainer import GaussianTrainer
from photo_slam_tpu_torch.models import gaussian_model as gm
from photo_slam_tpu_torch.models.camera import Camera, resize_image
from photo_slam_tpu_torch.models.keyframe import Keyframe
from photo_slam_tpu_torch.models.scene import Scene
from photo_slam_tpu_torch.ops import depth_ops, stereo
from photo_slam_tpu_torch.ops.camera_math import build_camera_matrices
from photo_slam_tpu_torch.ops.render import (RenderSettings, principal_for,
                                             render_jit)
from photo_slam_tpu_torch.utils.math import (quat_to_rotmat,
                                             rotmat_to_quat_numpy,
                                             se3_inverse, se3_matrix)
from photo_slam_tpu_torch.utils.profiling import Profiler


class SensorType(Enum):
    MONOCULAR = 0
    STEREO = 1
    RGBD = 2


def _cpu_f32(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=torch.float32)


class GaussianMapper:
    """The online mapper on one device: `device` holds the map, the
    ground-truth cache and the keyframes' camera matrices; `seed` seeds the
    keyframe sampler and the densify generator."""

    def __init__(self, cfg: Config, sensor: SensorType,
                 result_dir: Optional[str] = None, seed: int = 0, *,
                 device):
        self.cfg = cfg
        self.sensor = sensor
        self.device = torch.device(device)
        self.scene = Scene()
        self.trainer = GaussianTrainer(cfg, self.scene, seed=seed,
                                       device=self.device)
        self.trainer.online_lr = True
        # The render mutex (the trainer's state lock) and the stream the
        # mapper enqueues on, where the viewer's renders go too; the
        # viewer copies its images to the host on a stream of its own.
        self.render_lock = self.trainer.state_lock
        self.profiler = self.trainer.profiler
        self._stream = self._copy_stream = None
        if self.device.type == "cuda":
            self._stream = torch.cuda.current_stream(self.device)
            self._copy_stream = torch.cuda.Stream(self.device)
        self.queue = MappingOpQueue()
        self.result_dir = Path(result_dir) if result_dir else None
        self.initial_mapped = False
        self.stopped = False
        self._cached_points: list[np.ndarray] = []
        self._cached_colors: list[np.ndarray] = []
        # All sparse tracker points ever inserted, kept for input.ply
        # (reference: sparse_points_xyz_/color_, src/gaussian_model.cpp:211-218).
        self._sparse_log_pts: list[np.ndarray] = []
        self._sparse_log_cols: list[np.ndarray] = []
        self._depth_cache_pts: list[np.ndarray] = []
        self._depth_cache_cols: list[np.ndarray] = []
        self.loop_closure_iteration = False
        # GUI-driven tail extension: while True, run() phase 3 keeps
        # optimizing past the densification window until a
        # set_variable_parameters caller clears it (reference keep_training_,
        # src/gaussian_mapper.cpp:527-534, 1939-1980).
        self.keep_training = False

    # ------------------------------------------------------------------
    # Camera registration (reference ctor: src/gaussian_mapper.cpp:115-229)
    # ------------------------------------------------------------------

    def add_camera(self, cam: Camera) -> None:
        self.scene.add_camera(cam)

    # ------------------------------------------------------------------
    # Queue consumption (reference: src/gaussian_mapper.cpp:809-1012)
    # ------------------------------------------------------------------

    def combine_mapping_operations(self) -> None:
        while self.queue.has():
            op = self.queue.get_and_pop()
            with self.render_lock:
                if op.kind == OprType.LOCAL_MAPPING_BA:
                    self._apply_local_ba(op)
                elif op.kind == OprType.LOOP_CLOSING_BA:
                    self._apply_loop_closing(op)
                elif op.kind == OprType.SCALE_REFINEMENT:
                    self._apply_scale_refinement(op)
                else:
                    raise ValueError(f"unknown op {op.kind}")

    def _apply_local_ba(self, op: MappingOperation) -> None:
        for kf_data in op.keyframes:
            kf = self.scene.keyframes.get(kf_data.kfid)
            if kf is not None:
                kf.set_pose(kf_data.quat_wxyz, kf_data.trans,
                            device=self.device)
                kf.remaining_times_of_use += (
                    self.cfg.mapper.local_BA_increased_times_of_use)
            else:
                self.handle_new_keyframe(kf_data)
        self._add_op_points(op)

    def _apply_loop_closing(self, op: MappingOperation) -> None:
        m = self.cfg.mapper
        # Per-keyframe Sim3 scales when the op carries them (mono essential
        # graphs), else the reference's single per-op scale. One
        # not_transformed mask runs across all keyframes of the op.
        per_kf = any(k.scale != 1.0 for k in op.keyframes)
        graphs = self.trainer.graphs
        not_transformed = (graphs.transform_mask(self.trainer.state.capacity,
                                                 self.device)
                           if self.initial_mapped else None)
        # Before/after loop-correction map snapshots (reference
        # record_loop_ply_, src/gaussian_mapper.cpp:878-946).
        record = (self.cfg.record.record_loop_ply and self.initial_mapped
                  and self.result_dir is not None)
        if record:
            self.save_ply(self.result_dir / (
                f"{self.trainer.iteration}_0_before_loop_correction"))
        for kf_data in op.keyframes:
            kf = self.scene.keyframes.get(kf_data.kfid)
            if kf is None:
                self.handle_new_keyframe(kf_data)
                continue
            scale = kf_data.scale if per_kf else op.scale
            # Pose delta test (reference: 901-908): diff = new_Twc * old_Tcw.
            old_tcw = se3_matrix(kf.quat, kf.trans)
            new_twc = se3_inverse(se3_matrix(kf_data.quat_wxyz, kf_data.trans))
            diff = new_twc @ old_tcw
            large_rot = not np.allclose(diff[:3, :3], np.eye(3),
                                        atol=m.large_rotation_threshold)
            large_trans = not (np.abs(diff[:3, 3])
                               <= m.large_translation_threshold).all()
            large_scale = abs(scale - 1.0) > 0.01
            if (large_rot or large_trans or large_scale) \
                    and self.initial_mapped:
                # t = (s * R_new * t_old) + t_new (reference: 909-912).
                diff_adj = diff.copy()
                diff_adj[:3, 3] = scale * (diff[:3, 3] - new_twc[:3, 3]) + (
                    new_twc[:3, 3])
                (self.trainer.state, self.trainer.opt_state, not_transformed,
                 _num) = graphs.scaled_transform_visible_points_of_keyframe(
                    self.trainer.state, self.trainer.opt_state,
                    not_transformed,
                    torch.as_tensor(diff_adj, dtype=torch.float32,
                                    device=self.device),
                    kf.matrices.viewmatrix, kf.matrices.full_proj,
                    kf.creation_iter, m.stable_num_iter_existence, scale)
                kf.remaining_times_of_use += (
                    m.loop_closure_increased_times_of_use)
            kf.set_pose(kf_data.quat_wxyz, kf_data.trans, device=self.device)
        if record:
            self.save_ply(self.result_dir / (
                f"{self.trainer.iteration}_1_after_loop_correction"))
        self._add_op_points(op)
        self.loop_closure_iteration = True

    def _apply_scale_refinement(self, op: MappingOperation) -> None:
        s, T = op.scale, op.transform
        if self.initial_mapped:
            self.trainer.state, self.trainer.opt_state = (
                self.trainer.graphs.apply_scaled_transformation(
                    self.trainer.state, self.trainer.opt_state,
                    torch.as_tensor(T, dtype=torch.float32,
                                    device=self.device), s))
        else:
            self._cached_points = [p * s @ T[:3, :3].T + T[:3, 3]
                                   for p in self._cached_points]
        # Transform every keyframe pose: Twc' = T @ (Twc with t *= s)
        # (reference: src/gaussian_scene.cpp:96-110 + mapper 988-999).
        for kf in self.scene.keyframes.values():
            twc = se3_inverse(se3_matrix(kf.quat, kf.trans))
            twc[:3, 3] *= s
            tcy = se3_inverse(T.astype(np.float64) @ twc)
            kf.set_pose(rotmat_to_quat_numpy(tcy[:3, :3]), tcy[:3, 3],
                        device=self.device)

    def _add_op_points(self, op: MappingOperation) -> None:
        if op.points.shape[0] == 0:
            return
        self._sparse_log_pts.append(op.points.astype(np.float32))
        self._sparse_log_cols.append(op.colors.astype(np.float32))
        if self.initial_mapped:
            if op.points.shape[0] >= 30:
                self.trainer.increase_pcd(op.points, op.colors)
        else:
            self._cached_points.append(op.points)
            self._cached_colors.append(op.colors)

    # ------------------------------------------------------------------
    # Keyframe intake (reference: src/gaussian_mapper.cpp:1014-1101)
    # ------------------------------------------------------------------

    def handle_new_keyframe(self, kf_data: KeyframeData) -> Keyframe:
        cam = self.scene.cameras[kf_data.camera_id]
        m = self.cfg.mapper
        kf = Keyframe(fid=kf_data.kfid, camera=cam, znear=m.z_near,
                      zfar=m.z_far)
        kf.set_pose(kf_data.quat_wxyz, kf_data.trans, device=self.device)
        if kf_data.image is not None:
            img = kf_data.image
            if cam.has_distortion:
                hwc = np.transpose(img, (1, 2, 0))
                img = np.transpose(cam.undistort_image(hwc), (2, 0, 1))
            num_sub = (m.num_gaus_pyramid_sub_levels
                       if m.do_gaus_pyramid_training else 0)
            kf.set_image(img, num_sub, m.gaus_pyramid_sub_level_times_of_use)
        kf.img_aux = kf_data.aux_image
        kf.kps_pixel = kf_data.kps_pixel
        kf.kps_point_local = kf_data.kps_point_local
        kf.img_filename = kf_data.filename
        kf.remaining_times_of_use = m.new_keyframe_times_of_use
        kf.creation_iter = self.trainer.iteration
        self.scene.add_keyframe(kf)

        if m.inactive_geo_densify and kf.kps_pixel is not None:
            self.increase_pcd_by_inactive_geo_densify(kf)
        return kf

    # ------------------------------------------------------------------
    # Per-sensor dense point harvest
    # (reference: src/gaussian_mapper.cpp:1225-1475)
    # ------------------------------------------------------------------

    def increase_pcd_by_inactive_geo_densify(self, kf: Keyframe) -> None:
        cam = kf.camera
        m = self.cfg.mapper
        pts_cam = None
        valid = None

        if self.sensor == SensorType.MONOCULAR:
            has3d = np.abs(kf.kps_point_local).sum(axis=1) > 0
            pts, ok = depth_ops.mono_neighbor_densify(
                _cpu_f32(kf.kps_pixel), torch.from_numpy(has3d),
                _cpu_f32(kf.kps_point_local),
                m.monocular_inactive_geo_densify_max_pixel_dist,
                cam.fx, cam.fy, cam.cx, cam.cy)
            pts_cam = pts.numpy()
            # Only the newly estimated (no prior 3D) points are added
            # (reference: 1235-1275 keeps kps without depth).
            valid = ok.numpy() & ~has3d

        elif self.sensor == SensorType.RGBD:
            depth = kf.img_aux
            if depth is None:
                return
            u = np.clip(kf.kps_pixel[:, 0].astype(np.int64), 0, cam.width - 1)
            v = np.clip(kf.kps_pixel[:, 1].astype(np.int64), 0, cam.height - 1)
            d = depth[v, u]
            valid = (d > m.rgbd_min_depth) & (d < m.rgbd_max_depth)
            pts_cam = depth_ops.backproject_pinhole(
                _cpu_f32(u), _cpu_f32(v), _cpu_f32(d),
                cam.fx, cam.fy, cam.cx, cam.cy).numpy()

        elif self.sensor == SensorType.STEREO:
            aux = kf.img_aux
            if aux is None or kf.image is None:
                return
            u = np.clip(kf.kps_pixel[:, 0].astype(np.int64), 0, cam.width - 1)
            v = np.clip(kf.kps_pixel[:, 1].astype(np.int64), 0, cam.height - 1)
            if np.asarray(aux).ndim == 2:
                # The frontend already solved stereo: aux IS a depth map.
                d = np.asarray(aux)[v, u]
                valid = (d > m.rgbd_min_depth) & (d < m.rgbd_max_depth)
                depth = np.where(valid, d, 0.0)
            else:
                dsp = self._stereo_disparity(kf.image, aux)[v, u]
                valid = dsp > max(m.stereo_min_disparity, 1e-6)
                depth = np.where(valid, cam.stereo_bf / np.maximum(dsp, 1e-6),
                                 0.0)
            pts_cam = depth_ops.backproject_pinhole(
                _cpu_f32(u), _cpu_f32(v), _cpu_f32(depth),
                cam.fx, cam.fy, cam.cx, cam.cy).numpy()

        if pts_cam is None or valid is None or valid.sum() == 0:
            kf.done_inactive_geo_densify = True
            return

        # Camera -> world, sample colors at the keypoints.
        twc = se3_inverse(se3_matrix(kf.quat, kf.trans))
        pts_w = pts_cam[valid] @ twc[:3, :3].T + twc[:3, 3]
        u = np.clip(kf.kps_pixel[valid, 0].astype(np.int64), 0, cam.width - 1)
        v = np.clip(kf.kps_pixel[valid, 1].astype(np.int64), 0,
                    cam.height - 1)
        cols = (kf.image[:, v, u].T if kf.image is not None
                else np.full((len(u), 3), 0.5, np.float32))

        # Batch until max_depth_cached keyframes, then insert
        # (reference: 1461-1466).
        self._depth_cache_pts.append(pts_w.astype(np.float32))
        self._depth_cache_cols.append(cols.astype(np.float32))
        if len(self._depth_cache_pts) >= m.max_depth_cached:
            pts = np.concatenate(self._depth_cache_pts)
            cols = np.concatenate(self._depth_cache_cols)
            self._depth_cache_pts.clear()
            self._depth_cache_cols.clear()
            if self.initial_mapped:
                self.trainer.increase_pcd(pts, cols)
            else:
                self._cached_points.append(pts)
                self._cached_colors.append(cols)
        kf.done_inactive_geo_densify = True

    def _stereo_disparity(self, left_chw: np.ndarray,
                          right_chw: np.ndarray) -> np.ndarray:
        """Semi-global matching on the mapper's device (replaces
        cv::cuda::StereoSGM, reference: src/gaussian_mapper.cpp:90-100,
        1277-1375; the JAX package runs OpenCV's CPU StereoSGBM):
        [H, W] float32 disparity in pixels, -1 where invalid."""
        return stereo.disparity(left_chw, right_chw, self.device)

    # ------------------------------------------------------------------
    # The run loop (reference: src/gaussian_mapper.cpp:371-542)
    # ------------------------------------------------------------------

    def has_met_initial_conditions(self) -> bool:
        return (not self.initial_mapped
                and len(self.scene.keyframes)
                >= self.cfg.mapper.min_num_initial_map_kfs
                and any(p.shape[0] for p in self._cached_points))

    def initialize_mapping(self) -> None:
        """Phase 1: build the initial map from the cached sparse points."""
        pts = np.concatenate(self._cached_points) if self._cached_points else (
            np.zeros((0, 3), np.float32))
        cols = np.concatenate(self._cached_colors) if self._cached_colors else (
            np.zeros((0, 3), np.float32))
        self._cached_points.clear()
        self._cached_colors.clear()
        self.trainer.initialize_map(pts.astype(np.float32),
                                    cols.astype(np.float32))
        self.initial_mapped = True

    def cull_keyframes(self, live_kf_ids: set[int]) -> None:
        """Drop keyframes no longer in the tracker's map
        (reference: src/gaussian_mapper.cpp:1206-1223)."""
        for fid in list(self.scene.keyframes.keys()):
            if fid not in live_kf_ids:
                del self.scene.keyframes[fid]
                self.trainer.drop_keyframe_cache(fid)

    def run(self, is_tracker_done: Callable[[], bool],
            live_kf_ids: Optional[Callable[[], set[int]]] = None,
            max_iterations: Optional[int] = None,
            batch: int = 1) -> None:
        """The 3-phase online loop. `is_tracker_done` polls tracker shutdown;
        `live_kf_ids` (optional) gives the current keyframe set for culling.
        `batch > 1` trains `batch` keyframes, sampled one by one, per
        optimization step (trainer.train_iteration_batched)."""
        o = self.cfg.opt
        max_iter = max_iterations or o.max_num_iterations
        # An opacity reset needs recovery iterations before the run's final
        # recording (the reference sidesteps this by configuring 30100
        # iterations, not a multiple of its 3000-iteration reset interval);
        # disallow resets near the end.
        reset_margin = max(200, (o.opacity_reset_interval or 0) // 10)

        def train_once():
            fetch = self.trainer.iteration % 10 == 0
            can_reset = self.trainer.iteration + reset_margin < max_iter
            if batch > 1:
                kfs = [kf for kf in (
                    self.trainer.sampler.sample_sliding_window(
                        self.scene.keyframes) for _ in range(batch))
                    if kf is not None]
                if kfs:
                    self.trainer.train_iteration_batched(
                        kfs, fetch_metrics=fetch,
                        allow_opacity_reset=can_reset)
                    return
            self.trainer.train_iteration(fetch_metrics=fetch,
                                         allow_opacity_reset=can_reset)

        # Phase 1: wait for initial conditions.
        while not self.stopped and not self.initial_mapped:
            self.combine_mapping_operations()
            if self.has_met_initial_conditions():
                self.initialize_mapping()
                self.trainer.train_iteration()
                break
            if is_tracker_done():
                if self._cached_points:
                    self.initialize_mapping()
                    break
                return
            time.sleep(0.001)

        # Phase 2: incremental mapping. Metrics are read back every 10
        # iterations, so the host runs ahead of the device in between.
        while not self.stopped and not is_tracker_done() and (
                self.trainer.iteration < max_iter):
            self.combine_mapping_operations()
            if self.cfg.mapper.cull_keyframes and live_kf_ids is not None:
                self.cull_keyframes(live_kf_ids())
            train_once()

        # Phase 3: tail optimization through the densification window, or
        # for as long as keep_training holds (reference: 527-534).
        while not self.stopped and self.trainer.iteration < max_iter and (
                self.trainer.iteration < o.densify_until_iter
                or self.keep_training):
            self.combine_mapping_operations()
            train_once()

        if self.result_dir is not None:
            self.finalize(self.result_dir)

    # ------------------------------------------------------------------
    # Render service + artifacts
    # ------------------------------------------------------------------

    # Render-size ladder (the JAX package's, where each new size compiles
    # a program): a request renders at the next ladder size with the same
    # focal length (wider FoV) and is center-cropped, which reproduces the
    # requested view exactly.
    RENDER_LADDER_W = 256
    RENDER_LADDER_H = 128

    def render_from_pose(self, quat_wxyz, trans, width: int, height: int,
                         camera_id: int = 0,
                         profiler: Optional[Profiler] = None) -> np.ndarray:
        """Viewer render service (reference:
        src/gaussian_mapper.cpp:1521-1569): renders the current map on its
        device through the kernel path, replayed from a captured graph per
        ladder size (render_jit); returns a [3, height, width] host array.

        It holds render_lock while it reads the map and enqueues the
        render's replay on the mapper's stream, so the render sees no
        half-written map;
        the wait for the device and the copy to the host come after the
        lock is released (stream order keeps the render ahead of the
        mapper's later writes). `profiler` times the stages as spans:
        viewer.lock_wait, viewer.render (enqueue to the device's finish)
        and viewer.d2h."""
        prof = profiler or Profiler(enabled=False)
        cam = self.scene.cameras[camera_id]
        q = np.asarray(quat_wxyz, np.float64)
        R = quat_to_rotmat(torch.tensor(q / np.linalg.norm(q),
                                        dtype=torch.float32)).numpy()
        lw, lh = self.RENDER_LADDER_W, self.RENDER_LADDER_H
        w2 = max(lw, -(-width // lw) * lw)
        h2 = max(lh, -(-height // lh) * lh)
        # Same focal length, extended FoV for the padded size.
        tanx2 = float(np.tan(cam.fovx / 2)) * w2 / width
        tany2 = float(np.tan(cam.fovy / 2)) * h2 / height
        k_dup, per_tile = self.cfg.renderer.caps_for_mode("pallas")
        # Off-center principal points ride through the ladder exactly: the
        # padded render keeps the camera's (cx, cy) shifted by the integer
        # crop offset.
        x0 = (w2 - width) // 2
        y0 = (h2 - height) // 2
        pp = principal_for(cam, width, height)
        on_stream = (torch.cuda.stream(self._stream) if self._stream
                     is not None else contextlib.nullcontext())
        with on_stream, torch.no_grad():
            mats = build_camera_matrices(R, np.asarray(trans, np.float64),
                                         self.cfg.mapper.z_near,
                                         self.cfg.mapper.z_far,
                                         2.0 * float(np.arctan(tanx2)),
                                         2.0 * float(np.arctan(tany2)),
                                         device=self.device)
            with prof.locked("viewer.lock_wait", self.render_lock):
                t0 = time.perf_counter()
                settings = RenderSettings(
                    width=w2, height=h2, tan_fovx=tanx2, tan_fovy=tany2,
                    sh_degree=self.trainer.default_sh,
                    max_tiles_per_gaussian=k_dup, max_per_tile=per_tile,
                    principal=(None if pp is None
                               else (pp[0] + x0, pp[1] + y0)),
                    mode="pallas")
                state = self.trainer.state
                scales, quats, opac = gm.activated(state.params)
                res = render_jit(state.params.xyz, scales, quats, opac,
                                 mats, settings, self.trainer.bg_color,
                                 shs=gm.sh_features(state.params),
                                 live_mask=state.live)
                img = res.image[:, y0:y0 + height, x0:x0 + width]
                done = None
                if self._stream is not None:
                    done = torch.cuda.Event()
                    done.record(self._stream)
        if done is not None:
            done.synchronize()
        prof.record("viewer.render", time.perf_counter() - t0)
        with prof.span("viewer.d2h"), (
                torch.cuda.stream(self._copy_stream) if self._copy_stream
                is not None else contextlib.nullcontext()):
            img = img.cpu().numpy()
        # Mask out invalid undistortion border pixels, like the reference's
        # viewer path (src/gaussian_mapper.cpp:1563-1568).
        if cam.has_distortion:
            mask = cam.undistort_mask()
            if mask.shape != (height, width):
                mask = (resize_image(mask, height, width)
                        > 0.5).astype(np.float32)
            img = img * mask[None]
        return img

    def render_and_record_all_keyframes(self, out_dir,
                                        suffix: str = "") -> dict:
        """Per-keyframe quality metrics + artifacts
        (reference: src/gaussian_mapper.cpp:1607-1656)."""
        from photo_slam_tpu_torch.mapper.recorder import (
            render_and_record_keyframes)
        return render_and_record_keyframes(self, out_dir, suffix)

    def write_keyframe_used_times(self, out_dir) -> None:
        """(reference: src/gaussian_mapper.cpp:1755-1773)."""
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        lines = [f"{fid} {n}" for fid, n in
                 sorted(self.trainer.sampler.use_counts.items())]
        (out / "used_times.txt").write_text("\n".join(lines) + "\n")

    def save_ply(self, out_dir) -> None:
        """Full checkpoint directory: point_cloud/iteration_N/point_cloud.ply
        + input.ply + cameras.json + cfg_args
        (reference: src/gaussian_mapper.cpp:1658-1753)."""
        from photo_slam_tpu_torch.utils.ply import save_points_ply

        out = Path(out_dir)
        it = self.trainer.iteration
        self.trainer.save_ply(out / "point_cloud" / f"iteration_{it}"
                              / "point_cloud.ply")
        # cameras.json (reference keyframesToJson: 1674-1731)
        cams = []
        for kf in self.scene.keyframes.values():
            twc = se3_inverse(se3_matrix(kf.quat, kf.trans))
            cams.append({
                "id": kf.fid,
                "img_name": kf.img_filename or str(kf.fid),
                "width": kf.camera.width,
                "height": kf.camera.height,
                "position": twc[:3, 3].tolist(),
                "rotation": twc[:3, :3].tolist(),
                "fx": kf.camera.fx,
                "fy": kf.camera.fy,
            })
        out.mkdir(parents=True, exist_ok=True)
        if self._sparse_log_pts:
            pts = np.concatenate(self._sparse_log_pts)
            cols = np.concatenate(self._sparse_log_cols)
            save_points_ply(out / "input.ply", pts,
                            np.clip(cols * 255, 0, 255).astype(np.uint8))
        (out / "cameras.json").write_text(json.dumps(cams))
        (out / "cfg_args").write_text(
            "Namespace(eval=False, images='images', model_path="
            f"'{out}', resolution=-1, sh_degree="
            f"{self.cfg.model.sh_degree}, source_path='', white_background="
            f"{self.cfg.model.white_background})")

    def finalize(self, out_dir) -> None:
        out = Path(out_dir)
        self.render_and_record_all_keyframes(out, "_shutdown")
        self.save_ply(out)
        self.write_keyframe_used_times(out / "used_times")

    def signal_stop(self) -> None:
        self.stopped = True

    # ------------------------------------------------------------------
    # Live-tunable parameters (the GUI surface, reference
    # VariableParameters, include/gaussian_mapper.h:79-97 and the getters
    # and setters at src/gaussian_mapper.cpp:1786-1980). The trainer reads
    # the cfg values every iteration, so a change takes effect at the next
    # one; a value stale by one iteration is harmless.
    # ------------------------------------------------------------------

    def get_variable_parameters(self) -> dict:
        o, m = self.cfg.opt, self.cfg.mapper
        return {
            "position_lr_init": self.trainer.position_lr_init_live,
            "feature_lr": o.feature_lr,
            "opacity_lr": o.opacity_lr,
            "scaling_lr": o.scaling_lr,
            "rotation_lr": o.rotation_lr,
            "percent_dense": o.percent_dense,
            "lambda_dssim": o.lambda_dssim,
            "densification_interval": o.densification_interval,
            "opacity_reset_interval": o.opacity_reset_interval,
            "densify_grad_threshold": o.densify_grad_threshold,
            "stable_num_iter_existence": m.stable_num_iter_existence,
            "keep_training": self.keep_training,
            "do_gaus_pyramid_training": m.do_gaus_pyramid_training,
            "do_inactive_geo_densify": m.inactive_geo_densify,
        }

    def set_variable_parameters(self, params: dict) -> None:
        o, m = self.cfg.opt, self.cfg.mapper
        for key, value in params.items():
            if key == "position_lr_init":
                self.trainer.position_lr_init_live = float(value)
            elif key == "keep_training":
                self.keep_training = bool(value)
            elif hasattr(o, key):
                setattr(o, key, type(getattr(o, key))(value))
            elif key == "do_gaus_pyramid_training":
                m.do_gaus_pyramid_training = bool(value)
            elif key == "do_inactive_geo_densify":
                m.inactive_geo_densify = bool(value)
            elif hasattr(m, key):
                setattr(m, key, type(getattr(m, key))(value))
