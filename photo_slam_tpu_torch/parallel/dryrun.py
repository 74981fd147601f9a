"""The multi-rank dry run, and the rank programs it and the tests run.

Counterpart of __graft_entry__.py::dryrun_multichip (and its _make_scene):
one view-parallel step over n ranks, a densify on the replicated map, a
tile-band render, and a Gaussian-sharded step held against the
single-device step, then a shard-local densify, at tiny shapes. Run it
with `python -m photo_slam_tpu_torch.parallel.dryrun --ranks 4`: on the
card by default (NCCL with a card per rank where there are enough cards,
else gloo with every rank on cuda:0); `--device cpu` runs gloo on the CPU.

The rank programs take numpy inputs and return numpy outputs, so the same
inputs can go through the JAX package's functions: spawn_local runs them
in each rank (they live here, in the port, so a child imports no test
module). Each computes on the device it is given ("{rank}" formatted).
"""
from __future__ import annotations

import argparse
import math
import sys

import numpy as np
import torch
import torch.distributed as dist

from photo_slam_tpu_torch.mapper.trainer import densify_step, train_step
from photo_slam_tpu_torch.models import gaussian_model as gm
from photo_slam_tpu_torch.models import optimizer as optim
from photo_slam_tpu_torch.ops.camera_math import (CameraMatrices,
                                                  build_camera_matrices)
from photo_slam_tpu_torch.ops.render import RenderSettings
from photo_slam_tpu_torch.parallel import launch
from photo_slam_tpu_torch.parallel import sharding


def make_scene(n: int = 4096, width: int = 128, height: int = 96,
               seed: int = 0, *, device):
    """__graft_entry__.py::_make_scene on `device`: (state, cam, width,
    height, tan of half the 1 rad field of view)."""
    rng = np.random.RandomState(seed)
    pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                    rng.uniform(3, 9, n)], 1).astype(np.float32)
    cols = rng.rand(n, 3).astype(np.float32)
    state = gm.create_from_pcd(pts, cols, sh_degree=3,
                               capacity=gm.round_capacity(n, minimum=n),
                               device=device)
    fov = 1.0
    cam = build_camera_matrices(np.eye(3), np.zeros(3), 0.01, 100.0, fov,
                                fov, device=device)
    return state, cam, width, height, float(np.tan(fov / 2))


def _noise(seed: int, cap: int, device) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randn((2, cap, 3), generator=g).to(device)


def dryrun_rank(rank: int, world: int, device: str) -> dict:
    """One rank of the dry run (see the module docstring); returns its
    summary, and whether the process imported JAX or the JAX package."""
    dev = launch.rank_device(device, rank)
    group = dist.group.WORLD
    width, height = 64, 48
    state, _, _, _, tanf = make_scene(n=256, width=width, height=height,
                                      device=dev)
    rng = np.random.RandomState(0)
    cams_list = [build_camera_matrices(np.eye(3), np.array([0.1 * i, 0, 0]),
                                       0.01, 100.0, 1.0, 1.0, device=dev)
                 for i in range(world)]
    cams = CameraMatrices(*(torch.stack(x) for x in zip(*cams_list)))
    gt = torch.from_numpy(rng.rand(world, 3, height, width).astype(
        np.float32)).to(dev)
    masks = torch.ones((world, height, width), device=dev)
    state = sharding.replicate(group, state)
    opt = sharding.replicate(group, optim.init_adam(state.params))
    cams_l, gt_l, masks_l = sharding.shard_batch_args(group, cams, gt, masks)
    lrs = optim.LearningRates.create(1e-3, 2.5e-3, 0.05, 5e-3, 1e-3)
    bg = torch.zeros(3, device=dev)
    settings = RenderSettings(width=width, height=height, tan_fovx=tanf,
                              tan_fovy=tanf * height / width, sh_degree=3,
                              max_per_tile=128, max_tiles_per_gaussian=16,
                              tiles_per_chunk=4)
    state, opt, metrics = sharding.train_step_batched(
        state, opt, cams_l, gt_l, masks_l, lrs, bg, 0.2, settings,
        group=group)
    loss = float(metrics["loss"])
    if not math.isfinite(loss):
        raise RuntimeError(f"dry run: non-finite loss {loss}")

    # The structural update on the replicated map: the same draws on every
    # rank keep the replicas equal.
    state, opt, info = densify_step(
        state, opt, _noise(0, state.capacity, dev), 1.0, grad_threshold=0.0,
        min_opacity=0.005, max_screen_size=0, percent_dense=0.01)

    scales, quats, opac = gm.activated(state.params)
    img = sharding.render_image_sharded(
        group, state.params.xyz, scales, quats, opac, cams_list[0],
        settings, bg, shs=gm.sh_features(state.params), live_mask=state.live)
    if tuple(img.shape) != (3, height, width):
        raise RuntimeError(f"dry run: band render shape {tuple(img.shape)}")

    # The Gaussian-sharded step against the single-device step.
    gp_state, _, _, _, _ = make_scene(n=256, width=width, height=height,
                                      device=dev)
    gp_opt = optim.init_adam(gp_state.params)
    ref_state = gm.clone_state(gp_state)
    ref_opt = optim.init_adam(gp_state.params)
    gp_state, gp_opt = sharding.shard_gaussian_state(group, gp_state, gp_opt)
    rows = gp_state.capacity
    if rows * world != ref_state.capacity:
        raise RuntimeError(f"dry run: map not sharded, {rows} rows a rank")
    gp_state, gp_opt, gp_metrics = sharding.train_step_gaussian_sharded(
        gp_state, gp_opt, cams_list[0], gt[0], masks[0], lrs, bg, 0.2,
        settings, group)
    ref_state, _, ref_metrics = train_step(ref_state, ref_opt, cams_list[0],
                                           gt[0], masks[0], lrs, bg, 0.2,
                                           settings)
    gp_loss, ref_loss = float(gp_metrics["loss"]), float(ref_metrics["loss"])
    if abs(gp_loss - ref_loss) >= 1e-5 * max(1.0, abs(ref_loss)):
        raise RuntimeError(f"dry run: gaussian-sharded loss {gp_loss} != "
                           f"replicated {ref_loss}")
    full, _ = sharding.gather_gaussian_state(group, gp_state, gp_opt)
    xyz_err = float((full.params.xyz - ref_state.params.xyz).abs().max())
    if xyz_err > 1e-5:
        raise RuntimeError(f"dry run: gaussian-sharded xyz off the "
                           f"replicated step's by {xyz_err}")
    gp_state, gp_opt, gp_info = sharding.densify_step_gaussian_sharded(
        gp_state, gp_opt, _noise(1 + rank, rows, dev), 1.0,
        grad_threshold=0.0, min_opacity=0.005, max_screen_size=0,
        percent_dense=0.01, group=group)
    return {"loss": loss, "visible": int(metrics["num_visible"]),
            "cloned": int(info.num_cloned), "split": int(info.num_split),
            "sharded_render_mean": float(img.mean()), "gp_loss": gp_loss,
            "ref_loss": ref_loss, "gp_rows_per_rank": rows,
            "gp_densify_cloned": int(gp_info.num_cloned),
            "jax_imported": any(m.split(".")[0] in ("jax", "photo_slam_tpu")
                                for m in sys.modules)}


def dryrun_multichip(n_ranks: int, *, device: str, backend: str = "gloo",
                     timeout: float = 300.0) -> list:
    """The dry run over n_ranks spawned ranks on `device` (see
    launch.spawn_local); prints rank 0's summary and returns every
    rank's."""
    out = launch.spawn_local(dryrun_rank, n_ranks, backend=backend,
                             device=device, args=(device,), timeout=timeout)
    s = out[0]
    print(f"[dryrun_multichip] n_ranks={n_ranks} ok, loss={s['loss']:.4f}, "
          f"visible={s['visible']}, densify(cloned={s['cloned']}, "
          f"split={s['split']}), sharded_render_mean="
          f"{s['sharded_render_mean']:.4f}, gp_loss={s['gp_loss']:.4f} "
          f"(ref {s['ref_loss']:.4f}), gp_rows_per_rank="
          f"{s['gp_rows_per_rank']}, gp_densify_cloned="
          f"{s['gp_densify_cloned']}", flush=True)
    return out


# ---- Rank programs on numpy inputs ---------------------------------------


def _cams(arrays, device) -> CameraMatrices:
    return CameraMatrices(*(torch.from_numpy(np.asarray(x, np.float32))
                            .to(device) for x in arrays))


def _t(x, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x)).to(device)


def _state(case, device):
    state = gm.state_from_numpy(case["params"], case["live"], device=device,
                                **case.get("stats", {}))
    return state, optim.init_adam(state.params)


def _arrays(state: gm.GaussianState, opt: optim.AdamState) -> dict:
    return {"params": state.params._asdict(), "live": state.live,
            "max_radii2d": state.max_radii2d,
            "xyz_grad_accum": state.xyz_grad_accum, "denom": state.denom,
            "exist_since_iter": state.exist_since_iter,
            "m": opt.m._asdict(), "v": opt.v._asdict(), "step": opt.step}


def band_render_rank(rank: int, world: int, case: dict, device: str):
    """render_image_sharded of case's view: means, scales, quats,
    opacities and colors [N, ...], cam (viewmatrix, full_proj, cam_center),
    settings, bg. Returns the [3, H, W] image."""
    dev = launch.rank_device(device, rank)
    return sharding.render_image_sharded(
        dist.group.WORLD, *(_t(case[k], dev) for k in (
            "means", "scales", "quats", "opacities")),
        _cams(case["cam"], dev), case["settings"], _t(case["bg"], dev),
        colors_precomp=_t(case["colors"], dev))


def view_step_rank(rank: int, world: int, case: dict, device: str):
    """case["steps"] view-parallel steps: the map (params, live) replicated
    from rank 0, the batch (cams stacked [B, ...], gts, masks) sharded.
    Returns the map and Adam state after the steps and each step's
    metrics."""
    dev = launch.rank_device(device, rank)
    group = dist.group.WORLD
    state, opt = sharding.replicate(group, _state(case, dev))
    cams, gts, masks = sharding.shard_batch_args(
        group, _cams(case["cams"], dev), _t(case["gts"], dev),
        _t(case["masks"], dev))
    metrics = []
    for _ in range(case["steps"]):
        state, opt, m = sharding.train_step_batched(
            state, opt, cams, gts, masks, case["lrs"], _t(case["bg"], dev),
            case["lambda"], case["settings"], group=group)
        metrics.append(m)
    return {**_arrays(state, opt), "metrics": metrics}


def gaussian_sharded_rank(rank: int, world: int, case: dict, device: str):
    """A program on the sharded map: the full map (params, live, optional
    stats) dealt (case["deal"]) and sharded, then case["program"], a list
    of "step" (train_step_gaussian_sharded on cam, gt, mask) and
    ("densify", noise [2, C, 3] in the dealt row order, extent, kwargs)
    events. Returns the gathered map and Adam state, each event's metrics
    or DensifyInfo, and whether shard-then-gather gave the map back
    exactly."""
    dev = launch.rank_device(device, rank)
    group = dist.group.WORLD
    state, opt = _state(case, dev)
    if case.get("deal"):
        state, opt = sharding.deal_gaussian_shards(state, opt, world)
    local, local_opt = sharding.shard_gaussian_state(group, state, opt)
    back, back_opt = sharding.gather_gaussian_state(group, local, local_opt)
    exact = all(torch.equal(a, b) for a, b in zip(
        [*back.params, *back[1:], *back_opt.m, *back_opt.v, back_opt.step],
        [*state.params, *state[1:], *opt.m, *opt.v, opt.step]))
    rows = local.capacity
    cam = _cams(case["cam"], dev)
    events = []
    for ev in case["program"]:
        if ev == "step":
            local, local_opt, m = sharding.train_step_gaussian_sharded(
                local, local_opt, cam, _t(case["gt"], dev),
                _t(case["mask"], dev), case["lrs"], _t(case["bg"], dev),
                case["lambda"], case["settings"], group)
            events.append(m)
        else:
            _, noise, extent, kw = ev
            noise = _t(noise, dev)[:, rank * rows:(rank + 1) * rows]
            local, local_opt, info = sharding.densify_step_gaussian_sharded(
                local, local_opt, noise.contiguous(), extent, group=group,
                **kw)
            events.append(info._asdict())
    full, full_opt = sharding.gather_gaussian_state(group, local, local_opt)
    return {**_arrays(full, full_opt), "events": events,
            "shard_gather_exact": exact, "rows": rows}


def placement(ranks: int, device: str | None = None,
              backend: str | None = None) -> tuple[str, str]:
    """(device, backend) of a run of `ranks` ranks: the card unless the
    caller asks for the CPU, a card per rank where there are enough cards
    (else every rank on cuda:0), NCCL where every rank has a card of its
    own (else gloo). Raises when a card is wanted and there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("dryrun: no CUDA card; pass --device cpu to "
                               "run on the CPU")
        device = ("cuda:{rank}" if torch.cuda.device_count() >= ranks
                  else "cuda:0")
    return device, backend or ("nccl" if "{rank}" in device else "gloo")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help='"cuda:{rank}" (a card per rank, NCCL), "cuda:0" '
                         '(every rank on one card, gloo) or "cpu" (gloo); '
                         'by default a card per rank where there are enough '
                         'cards, else cuda:0')
    ap.add_argument("--backend", default=None,
                    help="gloo or nccl; by default NCCL where every rank "
                         "has a card of its own, else gloo")
    args = ap.parse_args(argv)
    device, backend = placement(args.ranks, args.device, args.backend)
    dryrun_multichip(args.ranks, device=device, backend=backend)
    return 0


if __name__ == "__main__":
    sys.exit(main())
