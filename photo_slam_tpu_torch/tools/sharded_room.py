"""The room at full width on the multi-process path (parallel/sharding.py).

The rank program that chip_smoke.py's `sharded` phase runs through
parallel/launch.spawn_local, at bench.py's room shapes (300,000
Gaussians, SH 3, 1200x680, tools/bench_room.py):

  (a) the tile-band render of the room, at caps that do not bind (held
      against the single render) and at the production caps (k_dup 6, 1024
      entries a tile; its PSNR against the single render);
  (b) the view-parallel step on four distinct views, B/n a rank, held
      against train_step_batched without a group;
  (c) the Gaussian-sharded step on the dealt map, C/n rows a rank, held
      against train_step at caps that do not bind;
  (d) a shard-local densify on the map grown twofold (grad_threshold 0):
      the live count rises, the statistics are zero after it, and the next
      step is finite.

On a card with an NCCL group every rank also runs (a)-(d) through its
StepGraphs (mapper/trainer.py: one captured graph a path and rank, the
collectives inside it) from the same start as the op-by-op call, and
reports under "graphed" per path whether the two are bit-equal (every
tensor of the map, its Adam state and the metrics), their largest
difference, the ms of each timed in turns (eager, graphed, graphed,
eager), the device ms of the NCCL kernels in a torch.profiler trace of
the graphed calls, and the captures. A gloo group runs op by op only
(its collectives cannot be captured).

Every rank builds the room from its seed. The single-process references
and times run on rank 0 while the other ranks wait; each reference step
runs twice, and its "ref_spread" is how far the two differ (0: the entry
transpose's entry_sum adds each Gaussian's rows in one order on every
run). The blend, gather and entry_sum kernels' launches are counted
around the sharded calls only; "entry_repeats" is the count of repeated or
out-of-range entry ids that entry_sum saw on the rank's card (0). Run
it with every rank on one card (gloo, "cuda:0"), a card per rank, or one
NCCL rank. As a program:

    python -m photo_slam_tpu_torch.tools.sharded_room --ranks 4 \
        --backend nccl --device "cuda:{rank}"

prints the card, then one JSON line per rank.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from photo_slam_tpu_torch.mapper.trainer import StepGraphs, train_step
from photo_slam_tpu_torch.models import gaussian_model as gm
from photo_slam_tpu_torch.models import optimizer as optim
from photo_slam_tpu_torch.ops import binning, blend, losses
from photo_slam_tpu_torch.ops import preprocess as prep_mod
from photo_slam_tpu_torch.ops import tiled
from photo_slam_tpu_torch.ops.camera_math import (CameraMatrices,
                                                  build_camera_matrices)
from photo_slam_tpu_torch.ops.render import RenderSettings, render
from photo_slam_tpu_torch.parallel import collectives as coll
from photo_slam_tpu_torch.parallel import launch
from photo_slam_tpu_torch.parallel import sharding
from photo_slam_tpu_torch.tools import bench_room
from photo_slam_tpu_torch.tools.bench_room import (FOVX, HEIGHT, K_DUP32,
                                                   MAX_PER_TILE32,
                                                   N_GAUSSIANS, WIDTH,
                                                   room_scene)
from photo_slam_tpu_torch.utils.profiling import Profiler

BATCH_YAWS = (-0.3, -0.1, 0.1, 0.3)   # chip_smoke.py's four views
LAMBDA_DSSIM = 0.2
LRS = (1.6e-4, 2.5e-3, 0.05, 5e-3, 1e-3)   # bench.py:366
WARMUP, ITERS = 2, 10      # timed calls of each path
PROFILED = 3               # calls traced by the profiler's spans
TWIN_RTOL = 1e-4           # where an update counts (bench_room.twin_errors)
DENSIFY = dict(grad_threshold=0.0, min_opacity=0.005, max_screen_size=0,
               percent_dense=0.01)


def kernel_wrappers() -> dict:
    return {"blend_fwd": blend.blend_fwd, "blend_bwd": blend.blend_bwd,
            "window_gather": binning.window_gather,
            "entry_sum": tiled.entry_sum}


class LaunchCount:
    """Kernel launches of the calls run through it (the wrappers count
    launches on the host as they happen)."""

    def __init__(self):
        self.wrappers = kernel_wrappers()
        self.counts = dict.fromkeys(self.wrappers, 0)

    def __call__(self, fn):
        before = {k: w.launches for k, w in self.wrappers.items()}
        out = fn()
        for k, w in self.wrappers.items():
            self.counts[k] += w.launches - before[k]
        return out


def room(device) -> gm.GaussianState:
    """The room scene (seed 0) as an SH-3 map filling its capacity."""
    pts, cols = room_scene(N_GAUSSIANS, 0)
    return gm.create_from_pcd(pts, cols, sh_degree=3, capacity=N_GAUSSIANS,
                              device=device)


def camera(yaw: float, device) -> CameraMatrices:
    """The room's camera turned by `yaw` rad about y (chip_smoke.py's
    batched views)."""
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
    return build_camera_matrices(R, np.array([0.2 * yaw, 0.0, 0.0]), 0.01,
                                 100.0, FOVX, FOVX * HEIGHT / WIDTH,
                                 device=device)


def settings(k_dup: int, max_per_tile: int) -> RenderSettings:
    tan_x = float(np.tan(FOVX / 2))
    return RenderSettings(width=WIDTH, height=HEIGHT, tan_fovx=tan_x,
                          tan_fovy=tan_x * HEIGHT / WIDTH, sh_degree=3,
                          mode="pallas", max_tiles_per_gaussian=k_dup,
                          max_per_tile=max_per_tile)


def caps_that_do_not_bind(prep, extents, width: int, height: int):
    """(k_dup, max_per_tile) under which no Gaussian of `prep` is clipped
    and no tile overflows: the largest tight rect in 32 px tiles, and the
    deepest tile's count at that k_dup rounded up to 256."""
    x0, y0, x1, y1 = binning.compute_rects(prep.means2d, prep.radii, width,
                                           height, 32, extents=extents)
    vis = prep.visible & (extents[:, 0] > 0)
    k = int(torch.where(vis, (x1 - x0) * (y1 - y0), 0).max())
    b = binning.bin_gaussians(prep.means2d, prep.depths, prep.radii,
                              prep.visible, width, height, tile=32,
                              max_tiles_per_gaussian=k, max_per_tile=1,
                              extents=extents)
    return k, -(-int(b.raw_counts.max()) // 256) * 256


def twin_errors(opt, state, ref_opt, ref_state, params0) -> dict:
    """bench_room.twin_errors of a step from params0 and a fresh Adam
    state (opt, state) against its twin (ref_opt, ref_state)."""
    return bench_room.twin_errors(
        bench_room.step_outcome(opt, state.params, params0,
                                state.xyz_grad_accum),
        bench_room.step_outcome(ref_opt, ref_state.params, params0,
                                ref_state.xyz_grad_accum), TWIN_RTOL)


def band_keys_error(means3d, scales, quats, opacities, cam, s, bg, shs,
                    live, world: int, ref_image) -> float:
    """Max |frame - ref_image| for the band render with every band's
    binning keys laid out for the band's own tiles, as JAX's band render
    lays them out (parallel/sharding.py lays them out for the frame's,
    `key_tiles`): all `world` bands rendered in this process."""
    prep = prep_mod.preprocess(
        means3d, scales, quats, cam.viewmatrix, cam.full_proj,
        cam.cam_center, s.width, s.height, s.tan_fovx, s.tan_fovy,
        sh_degree=s.sh_degree, shs=shs, scale_modifier=s.scale_modifier,
        live_mask=live, principal=s.principal)
    band = sharding.band_rows(s.height, world)
    bands = [tiled.render_pallas(
        prep._replace(means2d=sharding._shift_rows(prep.means2d, r * band)),
        opacities, s.width, band, bg,
        max_tiles_per_gaussian=s.max_tiles_per_gaussian,
        max_per_tile=s.max_per_tile, overflow_passes=s.overflow_passes,
        overflow_capacity=s.overflow_capacity,
        overflow_compact=s.overflow_compact)[0].image
        for r in range(world)]
    return float((sharding._frame(torch.stack(bands), s.height)
                  - ref_image).abs().max())


def ms_per_call(fn, device, iters: int = ITERS, warmup: int = WARMUP):
    """Host clock around `iters` calls after `warmup`, the card waited for
    on both sides."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize(device)
    return (time.perf_counter() - t0) / iters * 1e3


def collective_ms(fn, device) -> dict:
    """ms per call in each collective, from a Profiler's spans over
    PROFILED calls of fn(profiler) (each span waits for the card)."""
    prof = Profiler()
    for _ in range(PROFILED):
        fn(prof)
    torch.cuda.synchronize(device)
    return {k: v["mean_ms"] * v["count"] / PROFILED
            for k, v in prof.summary().items() if k.startswith("collective.")}


def in_turns_ms(eager, graphed, device) -> dict:
    """ms per call of eager() and graphed(), each timed twice in the order
    eager, graphed, graphed, eager (ms_per_call)."""
    out = {"eager_ms": [], "graphed_ms": []}
    for name in ("eager", "graphed", "graphed", "eager"):
        out[f"{name}_ms"].append(ms_per_call(
            eager if name == "eager" else graphed, device))
    return out


def nccl_trace_ms(fn, device, calls: int = PROFILED) -> dict:
    """Device ms per call in the NCCL kernels of a torch.profiler trace of
    `calls` calls of fn() (the kernels of a graph's replay included), and
    their names. The Profiler's spans cannot time a graphed collective:
    they wait for the card, which a capture forbids."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize(device)
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    nccl = [e for e in ops if "nccl" in e.name.lower()]
    return {"ms": sum(e.time_range.end - e.time_range.start
                      for e in nccl) / calls / 1e3,
            "kernels": sorted({e.name[:60] for e in nccl}),
            "device_ops": len(ops) / calls}


def twin_diff(graphed, eager) -> dict:
    """Whether two sequences of tensors are bit-equal pair by pair, and
    their largest absolute difference."""
    worst = 0.0
    for a, b in zip(graphed, eager):
        if not torch.equal(a, b):
            d = (a.double() - b.double()).abs().nan_to_num(nan=float("inf"))
            worst = max(worst, float(d.max()))
    return {"bit_equal": len(graphed) == len(eager) and all(
        torch.equal(a, b) for a, b in zip(graphed, eager)),
            "max_abs_diff": worst}


def step_tensors(state, opt, met) -> list:
    """Every tensor of a step's result: the map, its Adam state and the
    metrics (by name)."""
    return [*state.params, *state[1:], *opt.m, *opt.v, opt.step,
            *(met[k] for k in sorted(met))]


def clone_adam(opt: optim.AdamState) -> optim.AdamState:
    return optim.AdamState(*(type(g)(*(x.clone() for x in g))
                             for g in opt[:2]), opt.step.clone())


def on_rank0(rank: int, group, fn):
    """fn() on rank 0 alone while the other ranks wait (the single-process
    references and times); its result on rank 0, None elsewhere."""
    out = fn() if rank == 0 else None
    dist.barrier(group=group)
    return out


def room_rank(rank: int, world: int, cfg: dict) -> dict:
    """One rank of the room run (see the module docstring). cfg: "device"
    (a card, "{rank}" formatted), "exact_caps" (k_dup, max_per_tile that
    do not bind),
    "extent" (the densify extent), "time" (time each path and its
    collectives) and "densify" (run (d))."""
    dev = launch.rank_device(cfg["device"], rank)
    group = dist.group.WORLD
    torch.cuda.reset_peak_memory_stats(dev)
    count = LaunchCount()
    prod = settings(K_DUP32, MAX_PER_TILE32)
    exact = settings(*cfg["exact_caps"])
    bg = torch.zeros(3, device=dev)
    lrs = optim.LearningRates.create(*LRS)
    cam = camera(0.0, dev)
    out = {"band_rows": sharding.band_rows(HEIGHT, world), "graphed": {}}
    # The graph route: a card with a group whose collectives a graph can
    # capture (NCCL).
    graphed = (dev.type == "cuda" and str(dist.get_backend(group))
               in sharding.CAPTURABLE_BACKENDS)

    # (a) The tile-band render.
    base = room(dev)
    state = gm.clone_state(base)
    sc, qu, op = gm.activated(state.params)
    shs = gm.sh_features(state.params)
    view = (state.params.xyz, sc, qu, op, cam)

    def band(s, profiler=None):
        return sharding.render_image_sharded(
            group, *view, s, bg, shs=shs, live_mask=state.live,
            profiler=profiler)

    def single(s):
        return render(*view, s, bg, shs=shs, live_mask=state.live)

    with torch.no_grad():
        img_exact = count(lambda: band(exact))
        img_prod = count(lambda: band(prod))

        def render_refs():
            ref_e, ref_p = single(exact), single(prod)
            return {"max_abs_err": float((img_exact - ref_e.image).abs()
                                         .max()),
                    "band_keys_max_abs_err": band_keys_error(
                        *view, exact, bg, shs, state.live, world,
                        ref_e.image),
                    "exact_clipped": int(ref_e.num_clipped),
                    "exact_overflow": int(ref_e.num_overflow),
                    "prod_psnr": float(losses.psnr(img_prod, ref_p.image)),
                    "prod_max_abs_diff": float((img_prod - ref_p.image)
                                               .abs().max()),
                    "prod_single_clipped": int(ref_p.num_clipped),
                    "shape": list(img_prod.shape),
                    "finite": bool(torch.isfinite(img_prod).all())}

        out["render"] = on_rank0(rank, group, render_refs)
        if graphed:
            sg_render = StepGraphs()

            def gband(s):
                return sg_render.render_image_sharded(
                    group, *view, s, bg, shs=shs, live_mask=state.live)

            g = twin_diff([count(lambda: gband(prod)).clone()], [img_prod])
            if cfg["time"]:
                g.update(in_turns_ms(lambda: count(lambda: band(prod)),
                                     lambda: count(lambda: gband(prod)),
                                     dev))
                g["nccl"] = nccl_trace_ms(lambda: gband(prod), dev)
            out["graphed"]["render"] = {**g, "captures": sg_render.captures}
            del sg_render
        if cfg["time"]:
            out["render_ms"] = ms_per_call(lambda: count(lambda: band(prod)),
                                           dev)
            out["render_single_ms"] = on_rank0(
                rank, group, lambda: ms_per_call(lambda: single(prod), dev))
            out["render_collective_ms"] = collective_ms(
                lambda p: count(lambda: band(prod, p)), dev)
    del img_exact, img_prod

    # (b) The view-parallel step: four distinct views, B/n a rank.
    cams4 = CameraMatrices(*(torch.stack(x) for x in zip(
        *(camera(yaw, dev) for yaw in BATCH_YAWS))))
    gts4 = sharding.replicate(group, torch.rand(
        (len(BATCH_YAWS), 3, HEIGHT, WIDTH), device=dev,
        generator=torch.Generator(device=dev).manual_seed(4)))
    masks4 = torch.ones((len(BATCH_YAWS), HEIGHT, WIDTH), device=dev)
    state = sharding.replicate(group, state)
    local = sharding.shard_batch_args(group, cams4, gts4, masks4)

    def vstep(st, o, profiler=None):
        return count(lambda: sharding.train_step_batched(
            st, o, *local, lrs, bg, LAMBDA_DSSIM, prod, group=group,
            profiler=profiler))

    st, o, met = vstep(gm.clone_state(state), optim.init_adam(state.params))
    if graphed:
        sg_view = StepGraphs()

        def gvstep(st, o):
            return count(lambda: sg_view.train_step_batched(
                st, o, *local, lrs, bg, LAMBDA_DSSIM, prod, group=group))

        gst, go, gmet = gvstep(gm.clone_state(state),
                               optim.init_adam(state.params))
        out["graphed"]["view"] = twin_diff(step_tensors(gst, go, gmet),
                                           step_tensors(st, o, met))

    def view_ref():
        def one():
            return sharding.train_step_batched(
                gm.clone_state(state), optim.init_adam(state.params), cams4,
                gts4, masks4, lrs, bg, LAMBDA_DSSIM, prod)

        (rs, ro, rm), (rs2, ro2, _) = one(), one()
        return {"loss": float(met["loss"]), "ref_loss": float(rm["loss"]),
                "num_visible": int(met["num_visible"]),
                "ref_num_visible": int(rm["num_visible"]),
                "errors": twin_errors(o, st, ro, rs, state.params),
                "ref_spread": bench_room.spread(twin_errors(
                    ro2, rs2, ro, rs, state.params))}

    out["view"] = on_rank0(rank, group, view_ref)
    if cfg["time"]:
        out["view_ms"] = ms_per_call(lambda: vstep(st, o), dev)
        out["view_single_ms"] = on_rank0(rank, group, lambda: ms_per_call(
            lambda: sharding.train_step_batched(
                st, o, cams4, gts4, masks4, lrs, bg, LAMBDA_DSSIM, prod),
            dev))
        out["view_collective_ms"] = collective_ms(
            lambda p: vstep(st, o, p), dev)
        if graphed:
            out["graphed"]["view"].update(in_turns_ms(
                lambda: vstep(st, o), lambda: gvstep(gst, go), dev))
            out["graphed"]["view"]["nccl"] = nccl_trace_ms(
                lambda: gvstep(gst, go), dev)
    if graphed:
        out["graphed"]["view"]["captures"] = sg_view.captures
        del gst, go, sg_view
    del st, o, state

    # (c) The Gaussian-sharded step on the dealt map, C/n rows a rank.
    full, full_opt = sharding.deal_gaussian_shards(
        gm.clone_state(base), optim.init_adam(base.params), world)
    loc, loc_opt = sharding.shard_gaussian_state(group, full, full_opt)
    out["rows"] = loc.capacity
    gt, mask = gts4[0], masks4[0]

    def gstep(s, st, o, profiler=None):
        return count(lambda: sharding.train_step_gaussian_sharded(
            st, o, cam, gt, mask, lrs, bg, LAMBDA_DSSIM, s, group,
            profiler=profiler))

    if graphed:
        sg_gp = StepGraphs()

        def ggstep(s, st, o):
            return count(lambda: sg_gp.train_step_gaussian_sharded(
                st, o, cam, gt, mask, lrs, bg, LAMBDA_DSSIM, s, group))

        g_loc, g_opt, g_met = ggstep(exact, gm.clone_state(loc),
                                     clone_adam(loc_opt))
    loc, loc_opt, met = gstep(exact, loc, loc_opt)
    if graphed:
        out["graphed"]["gp"] = twin_diff(step_tensors(g_loc, g_opt, g_met),
                                         step_tensors(loc, loc_opt, met))
    got, got_opt = sharding.gather_gaussian_state(group, loc, loc_opt)

    def gp_ref():
        def one():
            return train_step(gm.clone_state(full),
                              optim.init_adam(full.params), cam, gt, mask,
                              lrs, bg, LAMBDA_DSSIM, exact)

        (rs, ro, rm), (rs2, ro2, _) = one(), one()
        return {"ref_spread": bench_room.spread(twin_errors(
                    ro2, rs2, ro, rs, full.params)),
                **{k: int(met[k]) for k in ("num_visible", "binning_clipped",
                                            "binning_overflow")},
                **{"ref_" + k: int(rm[k]) for k in (
                    "num_visible", "binning_clipped", "binning_overflow")},
                "loss": float(met["loss"]), "ref_loss": float(rm["loss"]),
                "errors": twin_errors(got_opt, got, ro, rs, full.params)}

    out["gp"] = on_rank0(rank, group, gp_ref)
    del got, got_opt
    _, _, met = gstep(prod, loc, loc_opt)
    out["gp_prod_clipped"] = int(met["binning_clipped"])
    if cfg["time"]:
        out["gp_ms"] = ms_per_call(lambda: gstep(prod, loc, loc_opt), dev)
        out["gp_single_ms"] = on_rank0(rank, group, lambda: ms_per_call(
            lambda: train_step(full, full_opt, cam, gt, mask, lrs, bg,
                               LAMBDA_DSSIM, prod), dev))
        out["gp_collective_ms"] = collective_ms(
            lambda p: gstep(prod, loc, loc_opt, p), dev)
        if graphed:
            out["graphed"]["gp"].update(in_turns_ms(
                lambda: gstep(prod, loc, loc_opt),
                lambda: ggstep(prod, g_loc, g_opt), dev))
            out["graphed"]["gp"]["nccl"] = nccl_trace_ms(
                lambda: ggstep(prod, g_loc, g_opt), dev)
    if graphed:
        out["graphed"]["gp"]["captures"] = sg_gp.captures
        del g_loc, g_opt, sg_gp
    del full, full_opt, loc, loc_opt

    # (d) Densify on the sharded map, grown twofold (the room fills its
    # capacity, where the budget rightly approves nothing).
    if cfg["densify"]:
        grown = gm.grow_capacity(base, 2 * N_GAUSSIANS)
        grown, g_opt = sharding.deal_gaussian_shards(
            grown, optim.init_adam(grown.params), world)
        loc, loc_opt = sharding.shard_gaussian_state(group, grown, g_opt)
        live0 = int(gm.num_live(grown))
        loc, loc_opt, _ = gstep(prod, loc, loc_opt)
        noise = torch.randn((2, loc.capacity, 3), device=dev,
                            generator=torch.Generator(device=dev)
                            .manual_seed(1 + rank))
        if graphed:
            sg_dn = StepGraphs()

            def gdensify(st, o):
                return count(lambda: sg_dn.densify_step_gaussian_sharded(
                    st, o, noise, cfg["extent"], group=group, **DENSIFY))

            g_loc, g_opt, g_info = gdensify(gm.clone_state(loc),
                                            clone_adam(loc_opt))

        def densify(st, o):
            return count(lambda: sharding.densify_step_gaussian_sharded(
                st, o, noise, cfg["extent"], group=group, **DENSIFY))

        if graphed and cfg["time"]:
            # The op-by-op densify timed on a copy (each call densifies
            # the map it is given again), in turns with the graphed one.
            e_loc, e_opt = gm.clone_state(loc), clone_adam(loc_opt)
        loc, loc_opt, info = densify(loc, loc_opt)
        if graphed:
            out["graphed"]["densify"] = twin_diff(
                step_tensors(g_loc, g_opt, g_info._asdict()),
                step_tensors(loc, loc_opt, info._asdict()))
            if cfg["time"]:
                out["graphed"]["densify"].update(in_turns_ms(
                    lambda: densify(e_loc, e_opt),
                    lambda: gdensify(g_loc, g_opt), dev))
                del e_loc, e_opt
            out["graphed"]["densify"]["captures"] = sg_dn.captures
            del g_loc, g_opt, sg_dn
        stats_max = max(float(loc.xyz_grad_accum.abs().max()),
                        float(loc.denom.abs().max()),
                        float(loc.max_radii2d.abs().max()))
        live1 = int(coll.all_reduce_sum(gm.num_live(loc), group))
        loc, loc_opt, met = gstep(prod, loc, loc_opt)
        out["densify"] = {"live_before": live0, "live_after": live1,
                          "info": {k: int(v) for k, v in
                                   info._asdict().items()},
                          "stats_max_after": stats_max,
                          "next_loss": float(met["loss"])}
    torch.cuda.synchronize(dev)
    out["launches"] = count.counts
    repeats = tiled.entry_sum.repeats.get(dev.index)
    out["entry_repeats"] = 0 if repeats is None else int(repeats)
    out["peak_mib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="The room on the sharded "
                                 "paths over N local ranks.")
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--backend", default="nccl")
    ap.add_argument("--device", default="cuda:{rank}",
                    help='"cuda:{rank}" (a card per rank) or "cuda:0" '
                         '(every rank on one card, gloo only)')
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("sharded_room needs a CUDA card")
    from photo_slam_tpu_torch import kernels
    from photo_slam_tpu_torch.tools.bench_room import room_view

    kernels.build()   # once, before the ranks would build it each
    dev = torch.device("cuda", 0)
    view = room_view(device=dev)
    pts, _ = room_scene(N_GAUSSIANS, 0)
    extent = 1.1 * float(np.percentile(
        np.linalg.norm(pts - pts.mean(0), axis=1), 95))
    cfg = dict(device=args.device, extent=extent, time=True, densify=True,
               exact_caps=caps_that_do_not_bind(view.prep, view.extents,
                                                WIDTH, HEIGHT))
    del view
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    out = launch.spawn_local(room_rank, args.ranks, backend=args.backend,
                             device=args.device, args=(cfg,),
                             timeout=args.timeout)
    for rank, r in enumerate(out):
        print(json.dumps({"rank": rank, "ranks": args.ranks,
                          "backend": args.backend, "device": args.device,
                          "exact_caps": cfg["exact_caps"],
                          "wall_s": time.perf_counter() - t0, **r}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
