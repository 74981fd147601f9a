"""The "view" kind: one viewer client asking the view service
(GaussianMapper.render_from_pose) for frames back to back, each frame
compared, for a sample of poses, with the reference's render."""
from __future__ import annotations

import math
import statistics
import time

import numpy as np
import torch

from port_bench import roofline, scenes
from port_bench.cells import (Base, exact, intrinsics, p95, principal,
                              program_camera, program_config, program_state,
                              ref_settings, span, sync, to_host)
from port_bench.reference import camera as rcam
from port_bench.reference import render as rren

NUMBERS = ("frame_rms_gap", "frame_max_gap")
# The reference's frames computed in TF32.
CONTROLS = ("tf32",)


class Cell(Base):
    """GaussianMapper.render_from_pose back to back for one client over
    traffic["poses"] poses jittered from the configuration's views, each
    call returning the host array; the first frames of traffic["checked"]
    poses drawn from the seed are compared with the reference's render of
    the same pose."""

    def setup(self) -> None:
        from photo_slam_tpu_torch.mapper.mapper import GaussianMapper, \
            SensorType

        cfg, tf, dev = self.cfg, self.traffic, self.device
        # The map waits on the host, so that the peak is the program's.
        self.map = to_host(scenes.make_map(self.root, cfg["map"], self.gen,
                                           dev))
        base = scenes.views(self.root, cfg["views"], self.rng)
        self.poses = scenes.jittered_poses(base, tf["poses"], tf["yaw"],
                                           tf["shift"], self.rng)
        # The frames compared: the first frame of each of traffic["checked"]
        # poses drawn from the seed among the first traffic["checked_from"]
        # of the window, which every run reaches within its first second.
        # Only these are kept: a host array kept from every pose would
        # change how the host allocates the frames that follow.
        self.sample = sorted(int(x) for x in self.rng.choice(
            tf["checked_from"], tf["checked"], replace=False))
        self.kept = {}
        self.pc = program_config(cfg)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        mapper = GaussianMapper(self.pc, SensorType.RGBD, seed=self.seed,
                                device=dev)
        mapper.add_camera(program_camera(cfg["camera"]))
        mapper.trainer.state = program_state(self.map, dev)
        mapper.trainer.default_sh = cfg["map"]["sh_degree"]
        self.mapper = mapper
        self.size = (cfg["camera"]["width"], cfg["camera"]["height"])
        # Warm-up: the ladder size's graph is captured here.
        for q, t in self.poses[:2]:
            mapper.render_from_pose(q, t, *self.size)
        sync(dev)

    def window(self, seconds: float, trace: bool) -> None:
        from photo_slam_tpu_torch.utils.profiling import Profiler

        prof = Profiler() if trace else None
        mapper, poses, lat = self.mapper, self.poses, []
        w, h = self.size
        frame = [0]

        def step():
            i = frame[0] % len(poses)
            q, t = poses[i]
            with span("frame"):
                t0 = time.perf_counter()
                img = mapper.render_from_pose(q, t, w, h, profiler=prof)
                lat.append(time.perf_counter() - t0)
            if img.shape != (3, h, w):
                self.failed += 1
            if i in self.sample and i not in self.kept:
                self.kept[i] = img
            frame[0] += 1

        elapsed = self._window(seconds, trace, step)
        self.attempted = frame[0]
        self.e2e["view_fps"] = frame[0] / elapsed
        self.layer.update(count=frame[0], window_s=elapsed,
                          frame_ms_p95=1e3 * p95(lat))
        if prof is not None:
            self.layer["spans"] = prof.summary()

    def release(self) -> None:
        from photo_slam_tpu_torch.ops.render import drop_render_graphs

        drop_render_graphs(self.map["xyz"].shape[0])
        del self.mapper

    def reference_frame(self, params: dict, q, t, prec: str = "f32"):
        """The reference's (frame at the ladder size, crop) of the map
        `params` (on the device) from a pose: the view service's rule, a
        render at the next multiple of 256 x 128 with the same focal
        length, centre-cropped."""
        cfg = self.cfg
        cam = cfg["camera"]
        width, height = self.size
        w2 = max(256, -(-width // 256) * 256)
        h2 = max(128, -(-height // 128) * 128)
        fovx, fovy = intrinsics(cam)
        tanx2 = float(np.tan(fovx / 2)) * w2 / width
        tany2 = float(np.tan(fovy / 2)) * h2 / height
        x0, y0 = (w2 - width) // 2, (h2 - height) // 2
        pp = principal(cam, width, height)
        s = ref_settings(cfg, w2, h2, tanx2, tany2,
                         None if pp is None else (pp[0] + x0, pp[1] + y0))
        mats = rcam.matrices(rcam.rotation_of(q), np.asarray(t, np.float64),
                             0.01, 100.0, 2.0 * float(np.arctan(tanx2)),
                             2.0 * float(np.arctan(tany2)), self.device)
        with torch.no_grad(), exact():
            fr = rren.render(params, mats, s, torch.zeros(
                3, device=self.device), prec)
        return fr, fr.image[:, y0:y0 + height, x0:x0 + width]

    def check(self, trace: bool) -> None:
        """The sampled frames against the reference's: the widest RMS gap
        and the widest gap of one value."""
        rms, worst, parts = 0.0, 0.0, []
        if len(self.kept) < len(self.sample):
            # A sampled frame the window never produced is no answer.
            rms = worst = math.inf
        params = {k: v.to(self.device) for k, v in self.map.items()}
        for i in sorted(self.kept):
            fr, ref = self.reference_frame(params, *self.poses[i])
            d = torch.from_numpy(self.kept[i]).to(self.device).double() \
                - ref.double()
            rms = max(rms, float(torch.sqrt((d * d).mean())))
            worst = max(worst, float(d.abs().max()))
            if trace:
                parts.append(roofline.frame_work(fr))
        self.numbers = {"frame_rms_gap": rms, "frame_max_gap": worst}
        if parts:
            self.layer.update(
                k1_s=statistics.fmean(w["k1"] for w in parts),
                least_s=statistics.fmean(roofline.frame_seconds(w)
                                         for w in parts))

    def control(self, side: str) -> dict:
        """The compared numbers with the reference's frames, computed in
        TF32, in the program's place."""
        if side != "tf32":
            raise ValueError(f"view control {side!r}: one of {CONTROLS}")
        params = {k: v.to(self.device) for k, v in self.map.items()}
        self.kept = {i: self.reference_frame(params, *self.poses[i], "tf32")
                     [1].cpu().numpy() for i in self.sample}
        self.check(False)
        return self.numbers
