"""The "train" kind: the map's training iterations back to back, as the
mapper and the offline trainer loop them (GaussianTrainer.train_iteration),
checked against the reference's first iterations from the same start."""
from __future__ import annotations

import statistics
import time

import torch

from port_bench import roofline, scenes
from port_bench.cells import (GROUPS, Base, exact, leaf_gaps, program_camera,
                              program_config, program_state, relative_gap,
                              scene_extent, span, sync, to_host,
                              view_settings)
from port_bench.reference import camera as rcam
from port_bench.reference import render as rren
from port_bench.reference import train as rtrain

NUMBERS = ("loss_gap", "grad_gap", "change_gap")
# The reference computed in TF32, and with half of the image's rows left
# out of the loss (the mean taken over the rest).
CONTROLS = ("tf32", "half")


class Cell(Base):
    """GaussianTrainer.train_iteration back to back from
    cfg["train"]["start_iteration"], its sampler choosing among the
    configuration's keyframes, metrics read back every
    cfg["train"]["fetch_every"] iterations."""

    def setup(self) -> None:
        from photo_slam_tpu_torch.mapper.trainer import GaussianTrainer
        from photo_slam_tpu_torch.models import optimizer as optim
        from photo_slam_tpu_torch.models.keyframe import Keyframe
        from photo_slam_tpu_torch.models.scene import Scene

        cfg, dev = self.cfg, self.device
        tr = cfg["train"]
        truth = scenes.make_map(self.root, cfg["map"], self.gen, dev)
        start = scenes.perturb(truth, cfg["perturb"], self.gen)
        self.views = scenes.views(self.root, cfg["views"], self.rng)
        self.s, *self.fov = view_settings(cfg)
        self.bg = torch.zeros(3, device=dev)
        # The keyframes: exact renders of the unperturbed map by the
        # reference, whose seconds are not the program's set-up.
        sync(dev)
        t0 = time.perf_counter()
        gts = []
        with torch.no_grad(), exact():
            for q, t in self.views:
                gts.append(rren.render(truth, self._mats(q, t), self.s,
                                       self.bg).image.cpu().numpy())
        self.extent = scene_extent(self.views, truth["xyz"])
        self.reference_s = time.perf_counter() - t0
        # The inputs wait on the host, so that the peak is the program's.
        self.start = to_host(start)
        del truth, start

        self.pc = program_config(cfg)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        scene = Scene()
        cam = program_camera(cfg["camera"])
        scene.add_camera(cam)
        for i, ((q, t), gt) in enumerate(zip(self.views, gts)):
            kf = Keyframe(fid=i, camera=cam)
            kf.set_pose(q, t, device=dev)
            kf.set_image(gt, tr["pyramid_levels"], 0)
            scene.add_keyframe(kf)
        self.gts = gts
        trainer = GaussianTrainer(self.pc, scene, seed=self.seed,
                                  device=dev)
        trainer.state = program_state(self.start, dev)
        trainer.opt_state = optim.init_adam(trainer.state.params)
        trainer.iteration = tr["start_iteration"]
        trainer.default_sh = cfg["map"]["sh_degree"]
        trainer.spatial_lr_scale = self.extent
        scene.cameras_extent = self.extent
        self.trainer = trainer
        # The first iterations, through the window's own call, on different
        # keyframes drawn from the seed: what the reference follows.
        self.check_views = [int(x) for x in self.rng.choice(
            len(self.views), self.traffic["check_iterations"],
            replace=False)]
        self.losses = []
        for j, v in enumerate(self.check_views):
            met = trainer.train_iteration(kf=scene.keyframes[v])
            self.losses.append(float(met["loss"]))
            if j == 0:
                self.grad1 = to_host({k: m / (1.0 - optim.BETA1) for k, m
                                      in zip(GROUPS, trainer.opt_state.m)})
        self.after3 = to_host(dict(zip(GROUPS, trainer.state.params)))
        # One iteration on each keyframe, so that every keyframe's image is
        # on the card before the window, as a mapper at this iteration
        # holds them (the trainer's ground-truth cache).
        for kf in scene.keyframes.values():
            trainer.train_iteration(kf=kf, fetch_metrics=False)
        sync(dev)

    def _mats(self, q, t):
        return rcam.matrices(rcam.rotation_of(q), t, 0.01, 100.0,
                             *self.fov, self.device)

    def window(self, seconds: float, trace: bool) -> None:
        trainer, every = self.trainer, self.cfg["train"]["fetch_every"]
        done = [0]

        def step():
            with span("iteration"):
                trainer.train_iteration(
                    fetch_metrics=trainer.iteration % every == 0)
            done[0] += 1

        elapsed = self._window(seconds, trace, step)
        self.attempted = done[0]
        self.e2e["train_it_s"] = done[0] / elapsed
        self.layer.update(count=done[0], window_s=elapsed)

    def release(self) -> None:
        del self.trainer

    def reference_steps(self, prec: str):
        """The reference's iterations from the same start on the same
        keyframes: (each step's loss, the first gradient from Adam's first
        moment after one step, the parameters after the last)."""
        dev, tr = self.device, self.cfg["train"]
        params = {k: v.to(dev, copy=True) for k, v in self.start.items()}
        adam = rtrain.Adam(params)
        mask = torch.ones((self.s.height, self.s.width), device=dev)
        losses = []
        with exact():
            for j, v in enumerate(self.check_views):
                lrs = rtrain.learning_rates(tr["opt"], tr["start_iteration"]
                                            + j + 1, self.extent)
                gt = torch.from_numpy(self.gts[v]).to(dev)
                losses.append(rtrain.train_step(
                    params, adam, self._mats(*self.views[v]), gt, mask,
                    self.s, self.bg, tr["opt"]["lambda_dssim"], lrs, prec))
                if j == 0:
                    grad1 = {k: (adam.m[k] / (1.0 - rtrain.BETA1)).cpu()
                             for k in GROUPS}
        return losses, grad1, {k: params[k].cpu() for k in GROUPS}

    def check(self, trace: bool) -> None:
        """The program's three iterations against the reference's: each
        step's loss, the first gradient and the change of the parameters
        after three, by the worst leaf."""
        ref_losses, grad1, after3 = self.reference_steps("f32")
        change_ref = {k: after3[k] - self.start[k] for k in GROUPS}
        change = {k: self.after3[k] - self.start[k] for k in GROUPS}
        # Leaves whose gradient is nought to rounding move by round-off
        # alone under Adam: left out of the change.
        gnorm = {k: float(torch.linalg.norm(grad1[k].double()))
                 for k in GROUPS}
        med = statistics.median(gnorm.values())
        moving = [k for k in GROUPS if gnorm[k] >= 1e-3 * med]
        self.numbers = {
            "loss_gap": max(relative_gap(p, r, abs(r)) for p, r in
                            zip(self.losses, ref_losses)),
            "grad_gap": leaf_gaps(self.grad1, grad1),
            "change_gap": leaf_gaps(change, change_ref, moving),
        }
        if trace:
            self._work()

    def control(self, side: str) -> dict:
        """The compared numbers with the reference in the program's place:
        computed in TF32 ("tf32"), or with half of the image's rows left
        out of its loss ("half")."""
        if side == "half":
            loss_of = rtrain.loss_of

            def half(image, gt, mask, lam, prec):
                h = image.shape[1] // 2
                return loss_of(image[:, :h], gt[:, :h], mask[:h], lam, prec)

            rtrain.loss_of = half
            try:
                self.losses, self.grad1, self.after3 = \
                    self.reference_steps("f32")
            finally:
                rtrain.loss_of = loss_of
        elif side == "tf32":
            self.losses, self.grad1, self.after3 = self.reference_steps("tf32")
        else:
            raise ValueError(f"train control {side!r}: one of {CONTROLS}")
        self.check(False)
        return self.numbers

    def _work(self) -> None:
        """The least time of an iteration, averaged over the configuration's
        views, from the reference's render of the start map."""
        start = {k: v.to(self.device) for k, v in self.start.items()}
        parts = []
        with torch.no_grad(), exact():
            for q, t in self.views:
                parts.append(roofline.frame_work(rren.render(
                    start, self._mats(q, t), self.s, self.bg)))
        n = self.start["xyz"].shape[0]
        pixels = self.s.width * self.s.height
        self.layer.update(
            k1_s=statistics.fmean(w["k1"] for w in parts),
            k2_s=statistics.fmean(w["k2"] for w in parts),
            least_s=statistics.fmean(roofline.iteration_seconds(w, n, pixels)
                                     for w in parts))
