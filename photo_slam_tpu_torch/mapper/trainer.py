"""The training engine: the train step and the offline training loop.

Counterpart of photo_slam_tpu/mapper/trainer.py (reference:
src/gaussian_mapper.cpp:614-774, 544-608 and
src/gaussian_trainer.cpp:22-140). One step is render -> masked
(1-λ)·L1 + λ·(1-SSIM) -> backward through the blend (K2), the entry gather
and preprocess -> densification statistics -> masked Adam. The rare
structural events (densify and prune, opacity reset) are separate
functions; capacity growth re-buckets on the host.

  * The view-space gradient that densification accumulates is the
    gradient with respect to an explicit zero `means2d_offset`.
  * The Adam update writes the map and the moments in place (the JAX step
    donates the same buffers).
  * A step's metrics stay tensors on the device: nothing in train_step
    reads a value back to the host.
  * The trainer's state lock (the online mapper's render lock) is held
    around every write of the map: a step's statistics and Adam update,
    densify and prune, the opacity reset, insertion and capacity growth.
    A viewer thread that renders under it never sees a torn map.

JAX's jit is StepGraphs here: every function the JAX package jits with
the map donated is captured as a CUDA graph per settings and shape and
replayed on the map where it lies (utils/graphs.py): train_step,
train_chunk, the B-view step, densify and prune, the opacity reset, the
two map transforms of models/transforms.py, and, over an NCCL group on a
card, the multi-process functions of parallel/sharding.py (the
view-parallel and Gaussian-sharded steps, the sharded densify and the
band render), collectives inside the graph. The functions below dispatch
op by op; they are what the graphs capture, and what runs on the CPU.
train_chunk replays one step's graph num_steps times, the view index a
device tensor the step advances. The port always renders with the kernel
path (mode "pallas").
"""
from __future__ import annotations

import contextlib
import json
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from photo_slam_tpu_torch.config import Config
from photo_slam_tpu_torch.mapper.sampler import KeyframeSampler
from photo_slam_tpu_torch.models import densify as dz
from photo_slam_tpu_torch.models import gaussian_model as gm
from photo_slam_tpu_torch.models import optimizer as optim
from photo_slam_tpu_torch.models import transforms as xf
from photo_slam_tpu_torch.models.keyframe import Keyframe
from photo_slam_tpu_torch.models.scene import Scene
from photo_slam_tpu_torch.ops import losses
from photo_slam_tpu_torch.ops.camera_math import CameraMatrices
from photo_slam_tpu_torch.ops.render import (RenderSettings,
                                             drop_render_graphs,
                                             principal_for, render)
from photo_slam_tpu_torch.parallel import sharding
from photo_slam_tpu_torch.parallel.sharding import train_step_batched
from photo_slam_tpu_torch.utils.graphs import GraphCache, spec
from photo_slam_tpu_torch.utils.profiling import Profiler


STATE_FIELDS = ("live", "max_radii2d", "xyz_grad_accum", "denom",
                "exist_since_iter")


def save_state_npz(path, state: gm.GaussianState, opt_state: optim.AdamState,
                   meta, meta_f, compressed: bool = True, **extra) -> None:
    """A map and its Adam state under the JAX package's checkpoint keys
    (p_*, s_*, m_*, v_*), with `meta` [iteration, SH degree, Adam step] and
    `meta_f` [ema loss, spatial LR scale, initial position LR], so that
    either package's GaussianTrainer.load_checkpoint loads it; `extra`
    arrays are stored beside under their own names. Written to a
    temporary name first and renamed into place."""
    def host(x):
        return x.detach().cpu().numpy()

    payload = {}
    for prefix, group in (("p", state.params), ("m", opt_state.m),
                          ("v", opt_state.v)):
        payload.update({f"{prefix}_{k}": host(v)
                        for k, v in group._asdict().items()})
    payload.update({f"s_{k}": host(getattr(state, k)) for k in STATE_FIELDS})
    payload["meta"] = np.array(meta)
    payload["meta_f"] = np.array(meta_f)
    payload.update(extra)
    path = Path(path)
    if path.suffix != ".npz":   # where numpy would write it
        path = path.with_name(path.name + ".npz")
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name("tmp_" + path.name)
    (np.savez_compressed if compressed else np.savez)(tmp, **payload)
    tmp.replace(path)


def load_state_npz(path, device):
    """(state, opt_state, the npz file) of a checkpoint save_state_npz (or
    the JAX package) wrote, on `device`."""
    data = np.load(path)
    fields = gm.GaussianParams._fields
    state = gm.state_from_numpy(
        {k: data[f"p_{k}"] for k in fields}, data["s_live"], device=device,
        max_radii2d=data["s_max_radii2d"],
        xyz_grad_accum=data["s_xyz_grad_accum"], denom=data["s_denom"],
        exist_since_iter=data["s_exist_since_iter"])
    opt_state = optim.adam_from_numpy(
        {k: data[f"m_{k}"] for k in fields},
        {k: data[f"v_{k}"] for k in fields}, data["meta"][2], device=device)
    return state, opt_state, data


def train_step(
    state: gm.GaussianState,
    opt_state: optim.AdamState,
    cam: CameraMatrices,
    gt_image: torch.Tensor,
    mask: torch.Tensor,
    lrs: optim.LearningRates,
    bg_color: torch.Tensor,
    lambda_dssim: float,
    settings: RenderSettings,
    lock=None,
):
    """One optimization iteration (render / loss / grad / stats / Adam),
    dispatched op by op: the function StepGraphs captures (JAX's
    _train_step_impl). The map's parameters, its densification statistics
    and the Adam moments and step count are updated in place, with `lock`
    (a context manager, e.g. the mapper's render lock) held around those
    writes. `lrs` holds floats or 0-d tensors (optim.lr_tensors). Returns
    (state, opt_state, metrics of 0-d tensors)."""
    live = state.live
    params = gm.GaussianParams(*(p.detach().requires_grad_(True)
                                 for p in state.params))
    offset = torch.zeros((state.capacity, 2), dtype=torch.float32,
                         device=live.device, requires_grad=True)
    scales, quats, opac = gm.activated(params)
    res = render(params.xyz, scales, quats, opac, cam, settings, bg_color,
                 shs=gm.sh_features(params), live_mask=live,
                 means2d_offset=offset)
    masked = res.image * mask[None, :, :]
    loss = losses.training_loss(masked, gt_image, lambda_dssim)
    grads = torch.autograd.grad(loss, [*params, offset], allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for g, x in zip(grads, [*params, offset])]

    with torch.no_grad(), (lock or contextlib.nullcontext()):
        # Densification statistics (reference: src/gaussian_mapper.cpp:703-719).
        dz.update_max_radii_(state, res.radii, res.visible)
        dz.add_densification_stats_(state, grads[-1], res.visible,
                                    settings.width, settings.height)
        optim.adam_step(state.params, gm.GaussianParams(*grads[:-1]),
                        opt_state, lrs, live)
        metrics = {
            "loss": loss.detach(),
            "psnr": losses.psnr(masked.detach(), gt_image),
            "num_visible": res.visible.sum(dtype=torch.int32),
            "binning_clipped": res.num_clipped,
            "binning_overflow": res.num_overflow,
        }
    return state, opt_state, metrics


STEP_METRICS = ("loss", "psnr", "num_visible", "binning_clipped",
                "binning_overflow")


def chunk_buffers(length: int, device) -> dict:
    """A train_chunk's metric buffers: [length] per metric of train_step."""
    return {k: torch.zeros(length, dtype=torch.float32 if k in (
        "loss", "psnr") else torch.int32, device=device)
            for k in STEP_METRICS}


def chunk_step(state, opt_state, cams: CameraMatrices,
               gt_images: torch.Tensor, mask: torch.Tensor,
               lrs: optim.LearningRates, bg_color: torch.Tensor,
               lambda_dssim: float, settings: RenderSettings,
               view: torch.Tensor, j: torch.Tensor, buffers: dict) -> tuple:
    """One step of train_chunk, with nothing read from the host: the view
    index `view` and the step index `j` ([1] int64 on the device) pick the
    view of the ring (cams [V, ...], gt_images [V, 3, H, W]) and the slot
    of each metric's buffer (chunk_buffers) that the step's metric is
    written to, then view = (view + 1) % V and j += 1, in place. Returns
    ()."""
    cam = CameraMatrices(*(torch.index_select(x, 0, view)[0] for x in cams))
    gt = torch.index_select(gt_images, 0, view)[0]
    _, _, metrics = train_step(state, opt_state, cam, gt, mask, lrs,
                               bg_color, lambda_dssim, settings)
    with torch.no_grad():
        for k, buf in buffers.items():
            buf.index_copy_(0, j, metrics[k].reshape(1).to(buf.dtype))
        view.copy_(torch.remainder(view + 1, gt_images.shape[0]))
        j.add_(1)
    return ()


def train_chunk(state, opt_state, cams: CameraMatrices,
                gt_images: torch.Tensor, mask: torch.Tensor,
                lrs: optim.LearningRates, bg_color: torch.Tensor,
                lambda_dssim: float, start_iter: int,
                settings: RenderSettings, num_steps: int):
    """`num_steps` sequential train steps on the views
    (start_iter + j) % V of a resident view ring: cams with a leading view
    axis [V, ...], gt_images [V, 3, H, W]; the counterpart of JAX's scanned
    train_chunk, dispatched op by op (StepGraphs.train_chunk replays it
    from a graph). The view index is a device tensor advanced by each step
    (chunk_step). Returns (state, opt_state, metrics) with each metric
    stacked over the chunk ([num_steps])."""
    dev = state.live.device
    view = torch.full((1,), start_iter % gt_images.shape[0],
                      dtype=torch.int64, device=dev)
    j = torch.zeros(1, dtype=torch.int64, device=dev)
    buffers = chunk_buffers(num_steps, dev)
    for _ in range(num_steps):
        chunk_step(state, opt_state, cams, gt_images, mask, lrs, bg_color,
                   lambda_dssim, settings, view, j, buffers)
    return state, opt_state, buffers


def _tensors(state: gm.GaussianState, opt_state: optim.AdamState) -> list:
    return [*state.params, *state[1:], *opt_state.m, *opt_state.v,
            opt_state.step]


def _from_tensors(ts) -> tuple:
    n = len(gm.GaussianParams._fields)
    state = gm.GaussianState(gm.GaussianParams(*ts[:n]),
                             *ts[n:n + len(STATE_FIELDS)])
    k = n + len(STATE_FIELDS)
    opt = optim.AdamState(m=gm.GaussianParams(*ts[k:k + n]),
                          v=gm.GaussianParams(*ts[k + n:k + 2 * n]),
                          step=ts[k + 2 * n])
    return state, opt


def _assign(state, opt_state, new_state, new_opt) -> None:
    """Write new_state and new_opt into the tensors of state and opt_state
    (a function's new tensors into the donated ones), skipping the tensors
    they share."""
    with torch.no_grad():
        for a, b in zip(_tensors(state, opt_state),
                        _tensors(new_state, new_opt)):
            if a is not b:
                a.copy_(b)


def densify_step(state, opt_state, noise: torch.Tensor, extent, *,
                 grad_threshold: float, min_opacity: float,
                 max_screen_size: int, percent_dense: float):
    """One densify + prune event as new tensors (JAX's densify_step);
    noise [2, C, 3] standard normals for the split children, `extent` a
    float or a 0-d float32 tensor (models/densify.densify_and_prune)."""
    return dz.densify_and_prune(state, opt_state, noise, grad_threshold,
                                min_opacity, extent, max_screen_size,
                                percent_dense)


def opacity_reset_step(state, opt_state):
    return dz.reset_opacity(state, opt_state)


def densify_step_(state, opt_state, noise, extent, **static
                  ) -> dz.DensifyInfo:
    """densify_step written IN PLACE into the tensors of state and
    opt_state (JAX donates them): the function StepGraphs.densify_step
    captures. Returns the DensifyInfo (0-d tensors)."""
    new_state, new_opt, info = densify_step(state, opt_state, noise, extent,
                                            **static)
    _assign(state, opt_state, new_state, new_opt)
    return info


def opacity_reset_step_(state, opt_state) -> None:
    """opacity_reset_step written IN PLACE (StepGraphs captures it)."""
    _assign(state, opt_state, *opacity_reset_step(state, opt_state))


def _scalar(x, dtype, device) -> torch.Tensor:
    """x as a 0-d tensor on `device`: a Python number becomes a fill, so
    nothing waits for the device and no graph bakes it in."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.full((), x, dtype=dtype, device=device)


GP_METRICS = ("loss", "num_visible", "binning_clipped", "binning_overflow")


class StepGraphs:
    """The functions the JAX package jits with a map donated, of one map,
    as captured CUDA graphs (utils/graphs.py), replayed: train_step,
    train_chunk, the B-view step, densify_step, opacity_reset_step, the
    map transforms apply_scaled_transformation and
    scaled_transform_visible_points_of_keyframe, and, per rank of an NCCL
    group, the view-parallel step, the Gaussian-sharded step and densify
    and the band render of parallel/sharding.py.

    The graphs read and write the map and its Adam state where they lie:
    the resident tensors. The first call adopts the tensors it is given
    (a fresh copy where two of them share memory); a later call given
    other tensors of the same shapes (after insertion, a checkpoint or PLY
    load, which make new tensors) copies them into the resident ones,
    once; tensors of other shapes (a capacity growth) are adopted and the
    graphs of the old ones dropped (`drop`). Each call returns the
    resident state: the tensors passed in are donated and must not be
    used again. Densify and the reset write their results into the
    resident tensors, so no copy follows them.

    The graphs are keyed as JAX's static arguments: the render settings
    (a new image size, pyramid level or SH degree captures anew), lambda,
    densify's four thresholds, and over a group its size, the rank and
    the backend; the input shapes too. Every other scalar is a 0-d device
    input, as JAX traces it: the learning rates (refreshed before each
    replay), densify's extent, the transforms' scale, iteration and
    threshold. The outputs (metrics, densify counts) are the graph's
    static outputs: whoever keeps them across replays clones them.

    On the CPU the same functions run directly (the plain route); a gloo
    group on a card raises (sharding.graph_route)."""

    def __init__(self):
        self.cache = GraphCache()
        self._resident: Optional[list] = None
        self._lrs: Optional[optim.LearningRates] = None
        self._index: Optional[tuple] = None   # train_chunk's (view, j)
        self._buffers: dict = {}   # train_chunk's metric buffers by length
        self._mask: Optional[torch.Tensor] = None   # the transforms' mask

    @property
    def captures(self) -> int:
        return self.cache.captures

    def drop(self) -> None:
        """Drop the graphs and the resident tensors (a capacity growth)."""
        self.cache.clear()
        self._resident = self._index = self._mask = None
        self._buffers = {}

    def _donate(self, state, opt_state, lrs=None) -> tuple:
        """(state, opt_state) on the resident tensors, which now hold the
        given ones, with the learning-rate tensors set to `lrs` (when
        given)."""
        ts = _tensors(state, opt_state)
        res = self._resident
        if res is None or [spec(x) for x in res] != [spec(x) for x in ts]:
            self.drop()
            # In-place writes through two names of one memory would be
            # lost: tensors that share memory are adopted as copies.
            ptrs = [x.data_ptr() for x in ts if x.numel()]
            res = [x.clone() for x in ts] if len(set(ptrs)) < len(ptrs) \
                else list(ts)
            self._resident = res
            self._lrs = optim.lr_tensors(ts[0].device)
        elif any(a is not b for a, b in zip(res, ts)):
            with torch.no_grad():
                for a, b in zip(res, ts):
                    if a is not b:
                        a.copy_(b)
        if lrs is not None:
            optim.set_lrs(self._lrs, lrs)
        return _from_tensors(res)

    def _replay(self, key, body, cams, fresh, extra=(), replays=1) -> tuple:
        """body(cams, *fresh, state, opt_state, lrs, *extra) -> a tuple of
        tensors, replayed from the graph of `key` on the resident map and
        learning rates: `cams` (CameraMatrices) and `fresh` are copied into
        the graph's buffers, `extra` tensors are read where they lie."""
        n, k = len(self._resident), 3 + len(fresh)

        def fn(*xs):
            st, op = _from_tensors(xs[k:k + n])
            lrs = optim.LearningRates(*xs[k + n:k + n + 6])
            return body(CameraMatrices(*xs[:3]), *xs[3:k], st, op, lrs,
                        *xs[k + n + 6:])

        return self.cache.run(key, fn, (*cams, *fresh),
                              (*self._resident, *self._lrs, *extra),
                              replays=replays)

    def _on_map(self, key, body, state, opt_state, fresh=(), extra=()
                ) -> tuple:
        """body(*fresh, state, opt_state, *extra) -> a tuple of tensors,
        from the graph of `key` on the resident map (on the CPU, called on
        the given map): `fresh` tensors are copied into the graph's
        buffers, `extra` tensors read and written where they lie. Returns
        (state, opt_state, outputs)."""
        if state.live.device.type == "cuda":
            state, opt_state = self._donate(state, opt_state)
        ts = _tensors(state, opt_state)
        k, n = len(fresh), len(ts)

        def fn(*xs):
            st, op = _from_tensors(xs[k:k + n])
            return body(*xs[:k], st, op, *xs[k + n:])

        return state, opt_state, self.cache.run(key, fn, fresh,
                                                (*ts, *extra))

    def _graphed(self, device, group) -> bool:
        """Whether a call on `device` over `group` (None: one device)
        replays a graph; raises for a gloo group on a card."""
        if group is None:
            return device.type == "cuda"
        return sharding.graph_route(group, device)

    def train_step(self, state, opt_state, cam: CameraMatrices,
                   gt_image, mask, lrs: optim.LearningRates, bg_color,
                   lambda_dssim: float, settings: RenderSettings, lock=None):
        """train_step from its graph. `lock` is held around the resident
        copy and the replay's enqueue: the whole step's writes, where the
        eager step holds it around the writes only."""
        if state.live.device.type != "cuda":
            return train_step(state, opt_state, cam, gt_image, mask, lrs,
                              bg_color, lambda_dssim, settings, lock=lock)

        def body(cam, gt, mask, bg, st, op, lrs):
            met = train_step(st, op, cam, gt, mask, lrs, bg, lambda_dssim,
                             settings)[2]
            return tuple(met[k] for k in STEP_METRICS)

        with lock or contextlib.nullcontext():
            state, opt_state = self._donate(state, opt_state, lrs)
            out = self._replay(("train_step", settings, lambda_dssim), body,
                               cam, (gt_image, mask, bg_color))
        return state, opt_state, dict(zip(STEP_METRICS, out))

    def train_chunk(self, state, opt_state, cams: CameraMatrices, gt_images,
                    mask, lrs: optim.LearningRates, bg_color,
                    lambda_dssim: float, start_iter: int,
                    settings: RenderSettings, num_steps: int):
        """train_chunk from the graph of chunk_step, replayed num_steps
        times: the host launches the replays and reads nothing back."""
        if state.live.device.type != "cuda":
            return train_chunk(state, opt_state, cams, gt_images, mask, lrs,
                               bg_color, lambda_dssim, start_iter, settings,
                               num_steps)
        state, opt_state = self._donate(state, opt_state, lrs)
        dev = state.live.device
        if self._index is None:
            self._index = tuple(torch.zeros(1, dtype=torch.int64,
                                            device=dev) for _ in range(2))
        bufs = self._buffers.get(num_steps)
        if bufs is None:
            bufs = self._buffers[num_steps] = chunk_buffers(num_steps, dev)
        view, j = self._index
        view.fill_(start_iter % gt_images.shape[0])
        j.zero_()

        def body(cams, gts, mask, bg, st, op, lrs, view, j, *metric_bufs):
            return chunk_step(st, op, cams, gts, mask, lrs, bg,
                              lambda_dssim, settings, view, j,
                              dict(zip(STEP_METRICS, metric_bufs)))

        self._replay(("train_chunk", settings, lambda_dssim), body, cams,
                     (gt_images, mask, bg_color),
                     (view, j, *(bufs[k] for k in STEP_METRICS)),
                     replays=num_steps)
        return state, opt_state, {k: bufs[k].clone() for k in STEP_METRICS}

    def train_step_batched(self, state, opt_state, cams: CameraMatrices,
                           gt_images, masks, lrs: optim.LearningRates,
                           bg_color, lambda_dssim: float,
                           settings: RenderSettings, lock=None, group=None):
        """parallel/sharding.train_step_batched from its graph: without a
        group the single-device B-view step, with an NCCL group this
        rank's view-parallel step (its views, its replica of the map), the
        sums and maxima over the ranks inside the graph. `lock` as in
        train_step."""
        if not self._graphed(state.live.device, group):
            return train_step_batched(state, opt_state, cams, gt_images,
                                      masks, lrs, bg_color, lambda_dssim,
                                      settings, lock=lock, group=group)

        def body(cams, gts, masks, bg, st, op, lrs):
            met = train_step_batched(st, op, cams, gts, masks, lrs, bg,
                                     lambda_dssim, settings, group=group)[2]
            return (met["loss"], met["num_visible"])

        with lock or contextlib.nullcontext():
            state, opt_state = self._donate(state, opt_state, lrs)
            out = self._replay(("train_step_batched", settings,
                                lambda_dssim, *sharding.group_key(group)),
                               body, cams, (gt_images, masks, bg_color))
        return state, opt_state, dict(zip(("loss", "num_visible"), out))

    # -- the structural events and the map transforms ----------------------

    def split_noise(self, capacity: int, device) -> torch.Tensor:
        """The [2, capacity, 3] float32 tensor densify_step's split draws
        go into: on a card the graph's own input buffer, so that the
        caller's draw (noise.normal_(generator=...)) lands where the
        replay reads it; on the CPU a new tensor."""
        shape, dev = (2, capacity, 3), torch.device(device)
        if dev.type != "cuda":
            return torch.empty(shape, device=dev)
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return self.cache.input_buffer(0, shape, torch.float32, dev)

    def densify_step(self, state, opt_state, noise, extent, *,
                     grad_threshold: float, min_opacity: float,
                     max_screen_size: int, percent_dense: float):
        """densify_step_ from its graph, one per set of thresholds (JAX's
        static arguments) and capacity; `extent` a float or a 0-d tensor,
        the graph's input. Returns (state, opt_state, DensifyInfo of the
        graph's outputs)."""
        static = dict(grad_threshold=grad_threshold, min_opacity=min_opacity,
                      max_screen_size=max_screen_size,
                      percent_dense=percent_dense)

        def body(noise, extent, st, op):
            return tuple(densify_step_(st, op, noise, extent, **static))

        state, opt_state, out = self._on_map(
            ("densify_step", *static.items()), body, state, opt_state,
            (noise, _scalar(extent, torch.float32, noise.device)))
        return state, opt_state, dz.DensifyInfo(*out)

    def opacity_reset_step(self, state, opt_state):
        """opacity_reset_step_ from its graph. Returns (state, opt_state)."""
        def body(st, op):
            opacity_reset_step_(st, op)
            return ()

        state, opt_state, _ = self._on_map(("opacity_reset_step",), body,
                                           state, opt_state)
        return state, opt_state

    def apply_scaled_transformation(self, state, opt_state, T, s):
        """models/transforms.apply_scaled_transformation from its graph:
        T [4, 4] and s (a float or a 0-d tensor) are the graph's inputs, so
        one capture a capacity serves every scale refinement. Returns
        (state, opt_state)."""
        def body(T, s, st, op):
            xf.apply_scaled_transformation(st, op, T, s)
            return ()

        dev = state.live.device
        state, opt_state, _ = self._on_map(
            ("apply_scaled_transformation",), body, state, opt_state,
            (T, _scalar(s, torch.float32, dev)))
        return state, opt_state

    def transform_mask(self, capacity: int, device) -> torch.Tensor:
        """A loop closure's not_transformed mask, set to True: on a card
        one buffer kept across operations (JAX donates it), so that the
        transform's graph reads and writes it where it lies."""
        dev = torch.device(device)
        if dev.type != "cuda":
            return torch.ones(capacity, dtype=torch.bool, device=dev)
        if self._mask is None or self._mask.shape[0] != capacity \
                or self._mask.device != dev:
            self._mask = torch.empty(capacity, dtype=torch.bool, device=dev)
        return self._mask.fill_(True)

    def scaled_transform_visible_points_of_keyframe(
            self, state, opt_state, not_transformed, diff_pose,
            kf_viewmatrix, kf_full_proj, kf_creation_iter, stable_num_iter,
            scale):
        """models/transforms.scaled_transform_visible_points_of_keyframe
        from its graph: the matrices, the iteration, the threshold and the
        scale (numbers or 0-d tensors) are its inputs, so one capture a
        capacity serves every keyframe of every loop closure;
        not_transformed (transform_mask) is written in place. Returns
        (state, opt_state, not_transformed, num_transformed)."""
        def body(diff, vm, fp, it, stable, s, st, op, nt):
            new_nt, num = xf.scaled_transform_visible_points_of_keyframe(
                st, op, nt, diff, vm, fp, it, stable, s)[2:]
            nt.copy_(new_nt)
            return (num,)

        dev = state.live.device
        state, opt_state, (num,) = self._on_map(
            ("scaled_transform_visible_points_of_keyframe",), body, state,
            opt_state, (diff_pose, kf_viewmatrix, kf_full_proj,
                        _scalar(kf_creation_iter, torch.int32, dev),
                        _scalar(stable_num_iter, torch.int32, dev),
                        _scalar(scale, torch.float32, dev)),
            (not_transformed,))
        return state, opt_state, not_transformed, num

    # -- the multi-process functions, one rank's graphs -------------------

    def train_step_gaussian_sharded(self, state, opt_state, cam, gt_image,
                                    mask, lrs: optim.LearningRates,
                                    bg_color, lambda_dssim: float,
                                    settings: RenderSettings, group):
        """parallel/sharding.train_step_gaussian_sharded from this rank's
        graph (the rank's block of the map resident, the feature and band
        gathers and the backward's reduce-scatter inside the graph).
        Returns (state, opt_state, metrics of the graph's outputs)."""
        if not self._graphed(state.live.device, group):
            return sharding.train_step_gaussian_sharded(
                state, opt_state, cam, gt_image, mask, lrs, bg_color,
                lambda_dssim, settings, group)

        def body(cam, gt, mask, bg, st, op, lrs):
            st2, op2, met = sharding.train_step_gaussian_sharded(
                st, op, cam, gt, mask, lrs, bg, lambda_dssim, settings,
                group)
            _assign(st, op, st2, op2)
            return tuple(met[k] for k in GP_METRICS)

        state, opt_state = self._donate(state, opt_state, lrs)
        out = self._replay(("train_step_gaussian_sharded", settings,
                            lambda_dssim, *sharding.group_key(group)), body,
                           cam, (gt_image, mask, bg_color))
        return state, opt_state, dict(zip(GP_METRICS, out))

    def densify_step_gaussian_sharded(self, state, opt_state, noise, extent,
                                      *, grad_threshold: float,
                                      min_opacity: float,
                                      max_screen_size: int,
                                      percent_dense: float, group):
        """parallel/sharding.densify_step_gaussian_sharded from this rank's
        graph, keyed as densify_step and by the group; written into the
        rank's resident block. Returns (state, opt_state, DensifyInfo
        summed over the ranks)."""
        static = dict(grad_threshold=grad_threshold, min_opacity=min_opacity,
                      max_screen_size=max_screen_size,
                      percent_dense=percent_dense)
        if not self._graphed(state.live.device, group):
            return sharding.densify_step_gaussian_sharded(
                state, opt_state, noise, extent, group=group, **static)

        def body(noise, extent, st, op):
            st2, op2, info = sharding.densify_step_gaussian_sharded(
                st, op, noise, extent, group=group, **static)
            _assign(st, op, st2, op2)
            return tuple(info)

        state, opt_state, out = self._on_map(
            ("densify_step_gaussian_sharded", *static.items(),
             *sharding.group_key(group)), body, state, opt_state,
            (noise, _scalar(extent, torch.float32, noise.device)))
        return state, opt_state, dz.DensifyInfo(*out)

    def render_image_sharded(self, group, means3d, scales, quats, opacities,
                             cam: CameraMatrices, settings: RenderSettings,
                             bg_color, shs=None, colors_precomp=None,
                             live_mask=None) -> torch.Tensor:
        """parallel/sharding.render_image_sharded from this rank's graph
        (its band, the bands' gather inside the graph); it reads no
        resident map: its inputs are copied into the graph's buffers, as
        render_jit's are. Returns the graph's static [3, H, W] image."""
        if not self._graphed(means3d.device, group):
            with torch.no_grad():
                return sharding.render_image_sharded(
                    group, means3d, scales, quats, opacities, cam, settings,
                    bg_color, shs=shs, colors_precomp=colors_precomp,
                    live_mask=live_mask)
        opts = {k: v for k, v in (("shs", shs),
                                  ("colors_precomp", colors_precomp),
                                  ("live_mask", live_mask)) if v is not None}

        def fn(means3d, scales, quats, opacities, vm, fp, cc, bg, *xs):
            with torch.no_grad():
                return (sharding.render_image_sharded(
                    group, means3d, scales, quats, opacities,
                    CameraMatrices(vm, fp, cc), settings, bg,
                    **dict(zip(opts, xs))),)

        return self.cache.run(
            ("render_image_sharded", settings, tuple(opts),
             *sharding.group_key(group)), fn,
            (means3d, scales, quats, opacities, *cam, bg_color,
             *opts.values()))[0]


@dataclass
class TrainerMetrics:
    iteration: int = 0
    ema_loss: float = 0.0
    last_loss: float = 0.0
    last_psnr: float = 0.0
    num_live: int = 0
    num_dropped: int = 0
    # Kept by the offline loop (GaussianTrainer.train): the first
    # iteration's PSNR, the iteration at which the capacity reached
    # max_capacity (None until it does) and the rows it logged.
    first_psnr: Optional[float] = None
    ceiling_reached_at: Optional[int] = None
    trace: list = field(default_factory=list)


class GaussianTrainer:
    """Owns the map state on one device and runs training iterations, for
    the offline trainColmap path and the online mapper (mapper/mapper.py).

    `device` is where the map, the ground-truth cache and the camera
    matrices live; `generator` (a torch.Generator on that device, seeded
    from `seed` when not given) draws the split samples of densification.
    `state_lock` (reentrant) is held around every write of the map; the
    wait for it is the profiler's span "mapper.lock_wait".

    `profiler` times each iteration's stages as spans: "mapper.iteration"
    (the whole call; its identifier is the iteration) and inside it
    "mapper.sample" (the keyframe and pyramid level), "mapper.gt" (the
    ground truth on the device; a cache miss counts "mapper.gt_uploads"
    and its bytes "mapper.gt_upload_bytes"), "mapper.enqueue" (the step's
    replay enqueued, "mapper.lock_wait" inside), "mapper.events" (densify
    and the opacity reset where due: "mapper.densify",
    "mapper.opacity_reset") and "mapper.fetch" (the metrics read back;
    each read counts "mapper.host_syncs").
    """

    def __init__(self, cfg: Config, scene: Scene, seed: int = 0, *, device,
                 generator: Optional[torch.Generator] = None):
        self.cfg = cfg
        self.scene = scene
        self.device = torch.device(device)
        self.sampler = KeyframeSampler(seed)
        self.generator = generator if generator is not None else (
            torch.Generator(device=self.device).manual_seed(seed))
        self.iteration = 0
        self.default_sh = 0
        self.ema_loss = 0.0
        self.state: Optional[gm.GaussianState] = None
        self.opt_state: Optional[optim.AdamState] = None
        self.spatial_lr_scale = 1.0
        self.position_lr_init_live = cfg.opt.position_lr_init
        self.bg_color = torch.full((3,), 1.0 if cfg.model.white_background
                                   else 0.0, device=self.device)
        self.metrics = TrainerMetrics()
        self.state_lock = threading.RLock()
        self.profiler = Profiler()
        # The step's captured graphs and the map they donate.
        self.graphs = StepGraphs()
        # Online mode: per-keyframe use counts drive the position LR
        # schedule (reference: src/gaussian_mapper.cpp:661-669).
        self.online_lr = False
        # Ground truth on the device, LRU-bounded by bytes (keyframes are
        # sampled many times); masks are tiny and cached per (camera, size).
        self._gt_cache: "dict[tuple, torch.Tensor]" = {}
        self._gt_cache_bytes = 0
        self.gt_cache_budget = 2 << 30
        self._mask_cache: "dict[tuple, torch.Tensor]" = {}

    def _device_gt(self, kf: Keyframe, level: int) -> torch.Tensor:
        key = (kf.fid, level)
        hit = self._gt_cache.pop(key, None)
        if hit is not None:
            self._gt_cache[key] = hit  # LRU: move to the back
            return hit
        arr = torch.from_numpy(np.ascontiguousarray(
            kf.level_image(level), np.float32)).to(self.device)
        self.profiler.count("mapper.gt_uploads")
        self.profiler.count("mapper.gt_upload_bytes", arr.nbytes)
        self._gt_cache[key] = arr
        self._gt_cache_bytes += arr.nbytes
        while self._gt_cache_bytes > self.gt_cache_budget and len(
                self._gt_cache) > 1:
            oldest = next(iter(self._gt_cache))
            self._gt_cache_bytes -= self._gt_cache.pop(oldest).nbytes
        return arr

    def _device_mask(self, kf: Keyframe, height: int) -> torch.Tensor:
        key = (kf.camera.camera_id, height)
        hit = self._mask_cache.get(key)
        if hit is None:
            hit = torch.from_numpy(np.ascontiguousarray(
                kf.camera.undistort_mask(scale=height / kf.camera.height),
                np.float32)).to(self.device)
            self._mask_cache[key] = hit
        return hit

    def _writing(self):
        """The state lock, held while the map is written."""
        return self.profiler.locked("mapper.lock_wait", self.state_lock)

    def drop_keyframe_cache(self, fid: int) -> None:
        """Release the cached device images of a culled keyframe."""
        for key in [k for k in self._gt_cache if k[0] == fid]:
            self._gt_cache_bytes -= self._gt_cache.pop(key).nbytes

    # -- state management --------------------------------------------------

    def initialize_map(self, points: np.ndarray, colors: np.ndarray) -> None:
        """createFromPcd + trainingSetup
        (reference: src/gaussian_mapper.cpp:480-489)."""
        self.spatial_lr_scale = self.scene.compute_nerfpp_norm()
        # Degenerate-camera floor (photo_slam_tpu/mapper/trainer.py:250-264):
        # when the cameras clearly do not span the scene, floor the extent
        # with the observed point-cloud radius, or percent_dense * extent
        # falls below the median splat size and every gradient spike
        # mass-splits the map.
        if len(points):
            pt_radius = 1.1 * float(np.percentile(
                np.linalg.norm(points - points.mean(0), axis=1), 95))
            if self.scene.cameras_extent < 0.25 * pt_radius:
                self.scene.cameras_extent = pt_radius
                self.spatial_lr_scale = pt_radius
        cap = gm.round_capacity(points.shape[0] * 2,
                                minimum=self.cfg.renderer.initial_capacity)
        state = gm.create_from_pcd(points, colors,
                                   sh_degree=self.cfg.model.sh_degree,
                                   capacity=cap, device=self.device)
        with self._writing():
            self.state = state
            self.opt_state = optim.init_adam(state.params)

    def increase_pcd(self, points: np.ndarray, colors: np.ndarray) -> int:
        """Insert new Gaussians, growing capacity if needed. Returns the
        number inserted."""
        if points.shape[0] == 0:
            return 0
        pts = torch.as_tensor(points, dtype=torch.float32, device=self.device)
        cols = torch.as_tensor(colors, dtype=torch.float32,
                               device=self.device)
        valid = torch.ones(points.shape[0], dtype=torch.bool,
                           device=self.device)
        with self._writing():
            self._ensure_capacity(points.shape[0])
            self.state, dst = gm.insert_points(self.state, pts, cols, valid,
                                               self.iteration)
            placed = dst >= 0
            self.opt_state = optim.zero_moments_at(
                self.opt_state, torch.where(placed, dst, 0), placed)
        return int(placed.sum())

    def _ensure_capacity(self, incoming: int = 0) -> None:
        cap = self.state.capacity
        live = int(gm.num_live(self.state))
        headroom = int(cap * self.cfg.renderer.capacity_headroom)
        if cap >= self.cfg.renderer.max_capacity:
            # At the memory ceiling: inserts overflow-drop instead of growing.
            return
        if live + incoming + headroom > cap:
            new_cap = gm.round_capacity(int(
                (live + incoming)
                * (1.0 + self.cfg.renderer.capacity_headroom) * 2))
            new_cap = max(new_cap, cap * 2)
            new_cap = min(new_cap, self.cfg.renderer.max_capacity)
            if new_cap <= cap:
                return
            self.state = gm.grow_capacity(self.state, new_cap)
            # The step and render graphs of the old capacity and their
            # copies of the map go; the next step and render capture at the
            # new one (JAX recompiles here too).
            self.graphs.drop()
            drop_render_graphs(cap)

            def pad(moments):
                out = []
                for x, p in zip(moments, self.state.params):
                    y = torch.zeros_like(p)
                    y[:x.shape[0]] = x
                    out.append(y)
                return gm.GaussianParams(*out)

            self.opt_state = optim.AdamState(m=pad(self.opt_state.m),
                                             v=pad(self.opt_state.v),
                                             step=self.opt_state.step)

    # -- LR schedule ---------------------------------------------------------

    def _current_lrs(self, kf: Keyframe) -> optim.LearningRates:
        """The position LR follows the iteration count offline, and online
        the use count of the keyframe being trained, clamped
        (reference: src/gaussian_mapper.cpp:661-669)."""
        o = self.cfg.opt
        if self.online_lr:
            step = min(self.sampler.use_counts.get(kf.fid, 0),
                       o.position_lr_max_steps)
        else:
            step = min(self.iteration, o.position_lr_max_steps)
        pos_lr = optim.expon_lr(
            step,
            self.position_lr_init_live * self.spatial_lr_scale,
            o.position_lr_final * self.spatial_lr_scale,
            lr_delay_mult=o.position_lr_delay_mult,
            max_steps=o.position_lr_max_steps,
        )
        return optim.LearningRates.create(pos_lr, o.feature_lr, o.opacity_lr,
                                          o.scaling_lr, o.rotation_lr)

    # -- one iteration -------------------------------------------------------

    def _settings(self, camera, width: int, height: int) -> RenderSettings:
        """The kernel path's settings for a render of `camera` at (width,
        height) and the current SH degree."""
        r = self.cfg.renderer
        k_dup, per_tile = r.caps_for_mode("pallas")
        return RenderSettings(
            width=width, height=height,
            tan_fovx=float(np.tan(0.5 * camera.fovx)),
            tan_fovy=float(np.tan(0.5 * camera.fovy)),
            sh_degree=self.default_sh, tile=r.tile,
            max_tiles_per_gaussian=k_dup, max_per_tile=per_tile,
            tiles_per_chunk=r.tiles_per_chunk, mode="pallas",
            principal=principal_for(camera, width, height),
        )

    def _start_iteration(self) -> int:
        """Count the iteration and warm the SH degree up: +1 every 1000
        iterations (reference: src/gaussian_mapper.cpp:653-658)."""
        self.iteration += 1
        if (self.iteration % 1000 == 0
                and self.default_sh < self.cfg.model.sh_degree):
            self.default_sh += 1
        return self.iteration

    def _scheduled_events(self, it: int, allow_opacity_reset: bool) -> None:
        """Densify / prune and the opacity reset on schedule
        (reference: src/gaussian_mapper.cpp:721-735)."""
        o = self.cfg.opt
        if it >= o.densify_until_iter:
            return
        if it > o.densify_from_iter and it % o.densification_interval == 0:
            size_threshold = 20 if it > o.prune_big_point_after_iter else 0
            with self.profiler.span("mapper.densify"), self._writing():
                self._ensure_capacity()
                # The split draws, from the trainer's generator, straight
                # into the buffer the densify graph reads.
                noise = self.graphs.split_noise(self.state.capacity,
                                                self.device)
                noise.normal_(generator=self.generator)
                self.state, self.opt_state, info = self.graphs.densify_step(
                    self.state, self.opt_state, noise,
                    self.scene.cameras_extent,
                    grad_threshold=o.densify_grad_threshold,
                    min_opacity=o.densify_min_opacity,
                    max_screen_size=size_threshold,
                    percent_dense=o.percent_dense,
                )
            self.metrics.num_dropped += int(info.num_dropped)

        if allow_opacity_reset and o.opacity_reset_interval and (
            it % o.opacity_reset_interval == 0
            or (self.cfg.model.white_background
                and it == o.densify_from_iter)
        ):
            with self.profiler.span("mapper.opacity_reset"), \
                    self._writing():
                self.state, self.opt_state = self.graphs.opacity_reset_step(
                    self.state, self.opt_state)

    def _fetch(self, metrics: dict) -> None:
        """Read a step's metrics back into the host-side fields."""
        loss = float(metrics["loss"])
        self.ema_loss = 0.4 * loss + 0.6 * self.ema_loss
        self.metrics.last_loss = loss
        self.metrics.ema_loss = self.ema_loss
        if "psnr" in metrics:
            self.metrics.last_psnr = float(metrics["psnr"])
        self.metrics.num_live = int(gm.num_live(self.state))
        # The loss, the PSNR and the live count: a read each.
        self.profiler.count("mapper.host_syncs", 2 + ("psnr" in metrics))

    def train_iteration(self, kf: Optional[Keyframe] = None,
                        fetch_metrics: bool = True,
                        allow_opacity_reset: bool = True) -> dict[str, Any]:
        """One pass of trainForOneIteration
        (reference: src/gaussian_mapper.cpp:614-774).

        With fetch_metrics=False nothing is read back to the host, except on
        densify iterations (the live count and the dropped candidates);
        the host-side metric fields keep their last fetched values. The
        stages are the profiler's spans (the class docstring)."""
        prof = self.profiler
        with prof.span("mapper.iteration", ident=self.iteration + 1):
            with prof.span("mapper.sample"):
                if kf is None:
                    kf = self.sampler.sample_sliding_window(
                        self.scene.keyframes)
                # Pyramid level selection (reference: 631-647).
                if kf is not None:
                    level = kf.current_pyramid_level() if (
                        self.cfg.mapper.do_gaus_pyramid_training
                        and kf.pyramid) else len(kf.pyramid)
            if kf is None:
                return {}
            it = self._start_iteration()
            with prof.span("mapper.gt"):
                gt = self._device_gt(kf, level)
                height, width = gt.shape[1], gt.shape[2]
                mask = self._device_mask(kf, height)

            with prof.span("mapper.enqueue"):
                self.state, self.opt_state, metrics = self.graphs.train_step(
                    self.state, self.opt_state, kf.matrices, gt, mask,
                    self._current_lrs(kf), self.bg_color,
                    self.cfg.opt.lambda_dssim,
                    self._settings(kf.camera, width, height),
                    lock=self._writing())

            with prof.span("mapper.events"):
                self._scheduled_events(it, allow_opacity_reset)
            self.metrics.iteration = it
            if fetch_metrics:
                with prof.span("mapper.fetch"):
                    self._fetch(metrics)
            return dict(metrics)

    def train_iteration_batched(self, kfs: list[Keyframe],
                                fetch_metrics: bool = True,
                                allow_opacity_reset: bool = True
                                ) -> dict[str, Any]:
        """One multi-view optimization step over the keyframes `kfs`, all at
        full resolution with kfs[0]'s camera and learning rates
        (parallel/sharding.train_step_batched: the views one after the
        other, one shared Adam update), then the single-view iteration's
        schedule: SH warm-up, densify / prune and the opacity reset.
        Capability beyond the reference's strictly sequential per-view
        iterations (photo_slam_tpu/mapper/trainer.py:448-536). The stages
        are train_iteration's spans ("mapper.sample": the views' cameras
        stacked)."""
        if not kfs:
            return {}
        prof = self.profiler
        with prof.span("mapper.iteration", ident=self.iteration + 1):
            it = self._start_iteration()
            cam0 = kfs[0].camera
            with prof.span("mapper.sample"):
                cams = CameraMatrices(*(torch.stack(x) for x in
                                        zip(*(k.matrices for k in kfs))))
            with prof.span("mapper.gt"):
                gts = torch.stack([self._device_gt(k, len(k.pyramid))
                                   for k in kfs])
                masks = torch.stack([self._device_mask(k, k.camera.height)
                                     for k in kfs])
            with prof.span("mapper.enqueue"):
                self.state, self.opt_state, metrics = \
                    self.graphs.train_step_batched(
                        self.state, self.opt_state, cams, gts, masks,
                        self._current_lrs(kfs[0]), self.bg_color,
                        self.cfg.opt.lambda_dssim,
                        self._settings(cam0, cam0.width, cam0.height),
                        lock=self._writing())

            with prof.span("mapper.events"):
                self._scheduled_events(it, allow_opacity_reset)
            self.metrics.iteration = it
            if fetch_metrics:
                with prof.span("mapper.fetch"):
                    self._fetch(metrics)
            return dict(metrics)

    # -- offline loop --------------------------------------------------------

    def train(self, num_iterations: Optional[int] = None,
              log_every: int = 0) -> TrainerMetrics:
        """trainColmap-style offline loop
        (reference: src/gaussian_mapper.cpp:544-608).

        Every log_every iterations it prints and appends to metrics.trace a
        row (trace_row); it also keeps metrics.first_psnr and
        metrics.ceiling_reached_at."""
        n = num_iterations or self.cfg.opt.max_num_iterations
        m = self.metrics
        last = time.time()
        for _ in range(n):
            met = self.train_iteration()
            if m.first_psnr is None:
                m.first_psnr = m.last_psnr
            if (m.ceiling_reached_at is None and self.state.capacity
                    >= self.cfg.renderer.max_capacity):
                m.ceiling_reached_at = self.iteration
            if log_every and self.iteration % log_every == 0:
                now = time.time()
                m.trace.append(self.trace_row(
                    met, log_every / max(now - last, 1e-9)))
                last = now
                print("[trainer] " + json.dumps(m.trace[-1]), flush=True)
        return m

    def trace_row(self, met: dict, iters_per_sec: float) -> dict:
        """The offline loop's row after the last iteration (`met` its
        metrics): the step's loss and PSNR, the live Gaussians and the
        capacity (each densify event falls on a logged iteration with the
        default schedule, after the step), the binning's clipped and
        overflow counts, the candidates dropped at the capacity ceiling so
        far and the iterations per second since the last row."""
        m = self.metrics
        return {"iter": self.iteration, "loss": m.last_loss,
                "psnr": m.last_psnr, "live": m.num_live,
                "capacity": self.state.capacity,
                "clipped": int(met["binning_clipped"]),
                "overflow": int(met["binning_overflow"]),
                "dropped": m.num_dropped, "iters_per_sec": iters_per_sec}

    # -- persistence ---------------------------------------------------------

    def save_ply(self, path) -> None:
        """3DGS checkpoint of the live Gaussians (reference savePly,
        src/gaussian_model.cpp:956-1047)."""
        from photo_slam_tpu_torch.utils import ply

        live = self.state.live.cpu().numpy()
        p = {k: v.detach().cpu().numpy()[live]
             for k, v in self.state.params._asdict().items()}
        ply.save_gaussian_ply(path, p["xyz"], p["features_dc"],
                              p["features_rest"], p["opacity_logit"],
                              p["log_scales"], p["quats"])

    def save_checkpoint(self, path) -> None:
        """Full training state (map, optimizer moments and step, schedule
        state) for mid-training resume, under the JAX package's .npz keys so
        that either package loads the other's checkpoints."""
        save_state_npz(path, self.state, self.opt_state,
                       meta=[self.iteration, self.default_sh,
                             int(self.opt_state.step)],
                       meta_f=[self.ema_loss, self.spatial_lr_scale,
                               self.position_lr_init_live])

    def load_checkpoint(self, path) -> None:
        self.state, self.opt_state, data = load_state_npz(path, self.device)
        self.iteration = int(data["meta"][0])
        self.default_sh = int(data["meta"][1])
        self.ema_loss = float(data["meta_f"][0])
        self.spatial_lr_scale = float(data["meta_f"][1])
        self.position_lr_init_live = float(data["meta_f"][2])

    def load_ply(self, path) -> None:
        self.state, self.default_sh = gm.state_from_ply(
            path, self.cfg.renderer.initial_capacity, device=self.device)
        self.opt_state = optim.init_adam(self.state.params)
