"""Time a blend kernel, the forward K1 or the backward K2, against builds of
its source with a part knocked out or against another source of it, on the
production pass-1 tiles, in turns.

The room scene (bench_room.room_view, 300,000 Gaussians, seed 0) binned at
32 px (k_dup 6, K 1024: [836, 1024, 16]). `--kernel fwd` times K1
(csrc/blend_fwd.cu) on those tiles, each build first held bit for bit
against blend_fwd_plain (colour, final T and n_contrib). `--kernel bwd`
times K2 (csrc/blend_bwd.cu) on them, blended forward by K1, with seeded
random cotangents of the colour and of final_T, each build first held
against blend_bwd_plain as chip_smoke.py holds K2 (per-lane error within
1e-4 of the lane's max, rows past counts_eff and lanes 9-15 zero). Then the
builds are timed `--rounds` times in turns, each time the mean of `--reps`
launches from CUDA events. `--opacity` sets every entry's opacity first:
the room's splats (0.1) never bring a pixel's T below 1e-4 within its
tile's rows, so only a higher opacity (0.99) times K1's stops. `--map
trained` takes the tiles of a trained map instead (trained_view): the room
as opaque splats is the ground truth, and GaussianTrainer fits a map to it
for TRAIN_ITERS iterations; its view from the identity pose is binned
as the room's is. The share of pixels (and of K1's 16 x 8 px warp blocks)
that stop is printed for either map.

A knockout edits the checkout's source by text (each edit must match
exactly once); `--baseline FILE` adds a source with the same launcher, for
example an earlier version of the kernel taken from git into `build/`.
Every build uses the kernels' nvcc flags and finds csrc/'s headers:

  fwd without-box  no per-entry box: a warp skips an entry only once all its
                   pixels have stopped (cull_box is not called, and the box
                   test folds away).
  fwd block-stop   no warp stop: a warp whose pixels have all stopped walks
                   on until the whole block has, as the earlier design did.
  fwd whole-tile   one block of 256 threads per tile (all eight warps,
                   batches of 256 rows, 4 resident blocks per SM) in place
                   of two blocks of 128, one per half tile.
  bwd without-box  no per-entry box: a warp skips an entry only by
                   n_contrib.

    python -m photo_slam_tpu_torch.tools.time_blend --kernel fwd \\
        --knockout without-box --knockout block-stop \\
        --knockout whole-tile --baseline build/blend_fwd_earlier.cu
    python -m photo_slam_tpu_torch.tools.time_blend --kernel fwd \\
        --knockout block-stop --map trained

Prints each build's registers, shared memory and spills, then one JSON
line: the card's `nvidia-smi` name and power limit, the map and its stop
shares, and ms per round for each build.
"""
from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from photo_slam_tpu_torch import kernels
from photo_slam_tpu_torch.config import Config
from photo_slam_tpu_torch.mapper.trainer import GaussianTrainer
from photo_slam_tpu_torch.models import gaussian_model as gm
from photo_slam_tpu_torch.models.camera import Camera
from photo_slam_tpu_torch.models.keyframe import Keyframe
from photo_slam_tpu_torch.models.scene import Scene
from photo_slam_tpu_torch.ops import blend as blend_mod
from photo_slam_tpu_torch.ops.render import RenderSettings, render
from photo_slam_tpu_torch.tools import bench_room, variants

RTOL = 1e-4
# The trained map's keyframes: camera translations (m) of the identity
# rotation, the first the view whose tiles are timed.
TRAIN_VIEWS = ((0.0, 0.0, 0.0), (0.4, 0.0, 0.0), (-0.4, 0.0, 0.0),
               (0.0, 0.3, 0.0), (0.0, -0.3, 0.0), (0.0, 0.0, 0.8),
               (0.4, 0.2, 0.8), (-0.4, -0.2, 0.8))
GT_MAX_PER_TILE = 4096   # the ground truth renders exactly, as chip_smoke's
TRAIN_ITERS = 2000       # before the reference's first opacity reset (3000)
WITHOUT_BOX = (
    ("      s_box[tid] = cull_box(r0.x, r0.y, r0.z, r0.w, r1.x, r1.y);\n", ""),
    ("const float4 box = s_box[i];",
     "const float4 box = make_float4(-CUDART_INF_F, CUDART_INF_F, "
     "-CUDART_INF_F, CUDART_INF_F);"),
)
KNOCKOUTS = {
    "fwd": {
        "without-box": WITHOUT_BOX,
        "block-stop": (("  return __all_sync(0xffffffffu, mine_done);",
                        "  return false;"),),
        "whole-tile": (
            ("constexpr int kThreads = 128;", "constexpr int kThreads = 256;"),
            ("constexpr int kHalves = 2;", "constexpr int kHalves = 1;"),
            ("constexpr int kMinBlocks = 7;", "constexpr int kMinBlocks = 4;"),
        ),
    },
    "bwd": {"without-box": WITHOUT_BOX},
}


def knockout_source(source: str, kernel: str, name: str) -> str:
    return variants.knockout_source(source, KNOCKOUTS[kernel][name],
                                    f"{kernel} {name}")


def trained_view(iters: int, *, device, n: int = bench_room.N_GAUSSIANS,
                 width: int = bench_room.WIDTH,
                 height: int = bench_room.HEIGHT,
                 fovx: float = bench_room.FOVX):
    """(trainer, view): GaussianTrainer's map after `iters` iterations and
    its view from the identity pose (bench_room.map_view).

    The ground truth is the room scene (seed 0) as opaque splats: its
    points, colours and create_from_pcd's scales and rotations, opacity
    uniform in [0.75, 0.98) (seed 3), rendered exactly from TRAIN_VIEWS.
    The trainer starts from every third point with its colour perturbed
    (seed 3) and runs the reference schedule (densify every 100 iterations
    from 500, the first opacity reset at 3000) without the image pyramid."""
    pts, cols = bench_room.room_scene(n)
    world = gm.create_from_pcd(pts, cols, sh_degree=3, capacity=n,
                               device=device)
    scales, quats, _ = gm.activated(world.params)
    rng = np.random.RandomState(3)
    opac = torch.as_tensor(rng.uniform(0.75, 0.98, n).astype(np.float32),
                           device=device)
    fovy = fovx * height / width   # as map_view's camera
    tan_x, tan_y = float(np.tan(fovx / 2)), float(np.tan(fovy / 2))
    cam = Camera(camera_id=0, model_id=1, width=width, height=height,
                 fx=width / (2 * tan_x), fy=height / (2 * tan_y),
                 cx=width / 2, cy=height / 2)
    gt_settings = RenderSettings(width=width, height=height, tan_fovx=tan_x,
                                 tan_fovy=tan_y, mode="pallas",
                                 max_tiles_per_gaussian=bench_room.K_DUP32,
                                 max_per_tile=GT_MAX_PER_TILE)
    bg = torch.zeros(3, device=device)
    colors = torch.as_tensor(cols, device=device)
    scene = Scene()
    scene.add_camera(cam)
    for i, trans in enumerate(TRAIN_VIEWS):
        kf = Keyframe(fid=i, camera=cam)
        kf.set_pose(np.array([1.0, 0.0, 0.0, 0.0]), np.array(trans),
                    device=device)
        img = render(world.params.xyz, scales, quats, opac, kf.matrices,
                     gt_settings, bg, colors_precomp=colors,
                     live_mask=world.live).image
        kf.set_image(img.cpu().numpy())
        kf.remaining_times_of_use = 10**9
        scene.add_keyframe(kf)
    cfg = Config()
    cfg.mapper.do_gaus_pyramid_training = False
    trainer = GaussianTrainer(cfg, scene, seed=0, device=device)
    init = np.clip(cols + rng.randn(n, 3) * 0.2, 0.0, 1.0).astype(np.float32)
    trainer.initialize_map(pts[::3], init[::3])
    trainer.train(num_iterations=iters)
    return trainer, bench_room.map_view(trainer.state, device=device,
                                        width=width, height=height,
                                        fovx=fovx)


def stop_shares(t) -> tuple[float, float]:
    """(share of the tiles' pixels that stop, share of K1's 16 x 8 px warp
    blocks whose pixels all stop) in blend_fwd_plain's walk: a pixel stops
    at its first contributing entry below the count at which
    T (1 - alpha) < 1e-4."""
    nb, dev = t.num_tiles, t.data.device
    pix = torch.arange(1024, device=dev)
    tile = torch.arange(nb, device=dev)
    px = ((tile % t.tiles_x) * 32)[:, None].float() + (pix % 32).float()
    py = ((tile // t.tiles_x) * 32)[:, None].float() + (pix // 32).float()
    trans = torch.ones((nb, 1024), device=dev)
    done = torch.zeros((nb, 1024), dtype=torch.bool, device=dev)
    with torch.no_grad():
        for k in range(int(t.counts.max()) if nb else 0):
            alpha, ok = blend_mod.pair_terms(t.data[:, k], px, py)[5:]
            live = (k < t.counts)[:, None] & ~done & ok
            test_t = trans * (1.0 - alpha)
            stop = live & (test_t < blend_mod.T_EPS)
            trans = torch.where(live & ~stop, test_t, trans)
            done |= stop
    # Warp w = c // 16 + 2 (r // 8) owns pixel p = r * 32 + c.
    warps = done.reshape(nb, 4, 8, 2, 16).all(dim=4).all(dim=2)
    return float(done.float().mean()), float(warps.float().mean())


def fwd_case(t, dev):
    """(call(fn) -> outputs, check(outputs)) of K1 on the tiles."""
    nb = t.num_tiles
    ids = torch.arange(nb, dtype=torch.int32, device=dev)
    want = blend_mod.blend_fwd_plain(t.data, t.counts, t.tiles_x, nb)

    def call(fn):
        out = (t.data.new_empty(want[0].shape), t.data.new_empty(
            want[1].shape), t.counts.new_empty(want[2].shape))
        err = fn(t.data.data_ptr(), t.counts.data_ptr(), ids.data_ptr(), nb,
                 t.data.shape[1], t.tiles_x, *(x.data_ptr() for x in out),
                 torch.cuda.current_stream().cuda_stream)
        kernels.check_launch("blend_fwd", err)
        return out

    def check(got):
        err = max(float((g - w).abs().max()) for g, w in zip(got[:2],
                                                              want[:2]))
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        return same, f"max abs err {err:.3e}, n_contrib " + (
            "identical" if torch.equal(got[2], want[2]) else "differs")
    return call, check


def bwd_case(t, dev):
    """(call(fn) -> d_data, check(d_data)) of K2 on the tiles."""
    nb = t.num_tiles
    color, final_t, n_contrib = blend_mod.blend_fwd(t.data, t.counts,
                                                    t.tiles_x, nb)
    counts_eff = torch.minimum(t.counts, n_contrib.reshape(nb, -1).amax(-1)
                               ).to(torch.int32)
    gen = torch.Generator(device=dev).manual_seed(1)
    g_color = torch.randn(color.shape, generator=gen, device=dev)
    g_t = torch.randn(final_t.shape, generator=gen, device=dev)
    ids = torch.arange(nb, dtype=torch.int32, device=dev)
    inputs = (t.data, counts_eff, ids, final_t, n_contrib, g_color, g_t)
    want = blend_mod.blend_bwd_plain(t.data, counts_eff, final_t, n_contrib,
                                     g_color, g_t, t.tiles_x, nb)
    rows_past = (torch.arange(t.data.shape[1], device=dev)[None, :]
                 >= counts_eff[:, None])

    def call(fn):
        out = torch.empty_like(t.data)
        err = fn(*(x.data_ptr() for x in inputs), nb, t.data.shape[1],
                 t.tiles_x, out.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        kernels.check_launch("blend_bwd", err)
        return out

    def check(got):
        err = (got - want).abs().amax(dim=(0, 1))[:9]
        scale = want.abs().amax(dim=(0, 1))[:9]
        rel = float((err / scale.clamp_min(1e-30)).max())
        ok = (rel <= RTOL and bool((got[..., 9:] == 0).all())
              and bool((got[rows_past] == 0).all()))
        return ok, f"per-lane error / lane max {rel:.3e}"
    return call, check


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=sorted(KNOCKOUTS), required=True)
    ap.add_argument("--knockout", action="append", default=[],
                    choices=sorted({n for k in KNOCKOUTS.values() for n in k}))
    ap.add_argument("--baseline", type=Path,
                    help="another source of the kernel, with its launcher")
    ap.add_argument("--opacity", type=float,
                    help="set every entry's opacity to this value (the "
                    "room's splats have 0.1, at which no pixel stops)")
    ap.add_argument("--map", choices=("room", "trained"), default="room",
                    help="the room scene's tiles, or those of a map trained "
                    "on it as opaque splats (trained_view)")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    for name in args.knockout:
        if name not in KNOCKOUTS[args.kernel]:
            ap.error(f"--kernel {args.kernel} has no knockout {name}")
    if not torch.cuda.is_available():
        raise RuntimeError("time_blend needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    tag = f"[time_blend {args.kernel}]"

    source = (kernels.CSRC_DIR / f"blend_{args.kernel}.cu").read_text()
    sources = {"checkout": source}
    for name in args.knockout:
        sources[name] = knockout_source(source, args.kernel, name)
    if args.baseline is not None:
        sources["baseline"] = args.baseline.read_text()
    builds = variants.build(f"blend_{args.kernel}", sources)
    for name, (_, lines) in builds.items():
        for ln in lines:
            print(f"{tag} {name}: {ln}", flush=True)

    if args.map == "trained":
        trainer, view = trained_view(TRAIN_ITERS, device=dev)
        print(f"{tag} trained map: {trainer.iteration} iterations, PSNR "
              f"{trainer.metrics.last_psnr:.2f} dB, "
              f"{trainer.metrics.num_live} live", flush=True)
    else:
        view = bench_room.room_view(device=dev)
    t = bench_room.tiles32(view)
    if args.opacity is not None:
        data = t.data.clone()
        data[..., 5] = args.opacity
        t = t._replace(data=data)
    stopped = stop_shares(t)
    print(f"{tag} {args.map} tiles {list(t.data.shape)}, "
          f"{int(t.counts.sum())} rows: {stopped[0]:.4f} of the pixels and "
          f"{stopped[1]:.4f} of the 16 x 8 px warp blocks stop", flush=True)
    call, check = (fwd_case if args.kernel == "fwd" else bwd_case)(t, dev)
    for name, (fn, _) in builds.items():
        ok, what = check(call(fn))
        if not ok:
            raise AssertionError(f"{name} disagrees with the plain version: "
                                 f"{what}")
        print(f"{tag} {name}: {what}", flush=True)

    ms = {name: [] for name in builds}
    for _ in range(args.rounds):
        for name, (fn, _) in builds.items():
            ms[name].append(bench_room.time_ms(lambda: call(fn), args.reps,
                                               dev))
    print(json.dumps({"card": smi, "kernel": args.kernel, "map": args.map,
                      "tiles": list(t.data.shape), "opacity": args.opacity,
                      "stopped_pixels": stopped[0],
                      "stopped_warps": stopped[1], "reps": args.reps,
                      "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
