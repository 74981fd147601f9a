"""Render frames and train steps per second of the port, in repeated blocks.

The room scene (300,000 Gaussians, seed 0, SH 3) viewed at 1200x680 as
chip_smoke.py views it, rendered 1-pass (max_per_tile 1024) and 2-pass
compact (sized from the 1-pass render's overflow, as chip_smoke.py sizes
it) through the apps' entry point, ops/render.py::render_jit (replayed
from a captured graph), the render's binning stage alone (bin_gaussians,
which holds the window gather K3) on the view's preprocessed splats, and
the train step through mapper/trainer.py::StepGraphs (its graph, on a copy
of the map: the 1-pass render, the masked L1 + SSIM loss against a seeded
random ground truth, lambda 0.2, the backward through K2 and Adam at
bench.py's learning rates, as chip_smoke.py drives it). After two
warm-up calls of each, `--blocks` blocks of `--calls` calls of each,
timed on the host clock with a synchronize at each end: the spread
between blocks of one process shows how far the host moves a frame or a
step. Beside them, the blend wrappers
alone (blend_fwd for K1, blend_bwd for K2) on 8 empty tiles of
[8, 1024, 16], where the device has next to nothing to do, in blocks of
200 calls: their calls per second are the host's cost per call.

The script imports `photo_slam_tpu_torch` from the path, so it times the
checkout that PYTHONPATH names first, and can time another checkout's
package (one with the same render_jit and StepGraphs API) when run by its
file path:

    PYTHONPATH=<checkout> python3 photo_slam_tpu_torch/tools/render_fps.py

Prints one JSON line: the package's path, the card's `nvidia-smi` name and
power limit, and the calls per second of each block for each of them.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

import photo_slam_tpu_torch
from photo_slam_tpu_torch.mapper.trainer import StepGraphs
from photo_slam_tpu_torch.models import gaussian_model as gm
from photo_slam_tpu_torch.models import optimizer as optim
from photo_slam_tpu_torch.ops.binning import bin_gaussians
from photo_slam_tpu_torch.ops.blend import blend_bwd, blend_fwd
from photo_slam_tpu_torch.ops.camera_math import build_camera_matrices
from photo_slam_tpu_torch.ops.preprocess import preprocess, tight_extents
from photo_slam_tpu_torch.ops.render import RenderSettings, render_jit
from photo_slam_tpu_torch.tools.bench_room import room_scene

N_GAUSSIANS = 300_000
WIDTH, HEIGHT = 1200, 680
FOVX = 1.2
K_DUP = 6
MAX_PER_TILE = 1024
WRAPPER_CALLS = 200   # calls per block of a blend wrapper alone
LAMBDA_DSSIM = 0.2
TRAIN_LRS = (1.6e-4, 2.5e-3, 0.05, 5e-3, 1e-3)   # bench.py:366


def ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--blocks", type=int, default=5)
    ap.add_argument("--calls", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("render_fps needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]

    pts, cols = room_scene(N_GAUSSIANS, 0)
    state = gm.create_from_pcd(pts, cols, sh_degree=3, capacity=N_GAUSSIANS,
                               device=dev)
    scales, quats, opac = gm.activated(state.params)
    shs = gm.sh_features(state.params)
    cam = build_camera_matrices(np.eye(3), np.zeros(3), 0.01, 100.0, FOVX,
                                FOVX * HEIGHT / WIDTH, device=dev)
    tan_x = float(np.tan(FOVX / 2))
    bg = torch.zeros(3, device=dev)

    def settings(**kw):
        return RenderSettings(width=WIDTH, height=HEIGHT, tan_fovx=tan_x,
                              tan_fovy=tan_x * HEIGHT / WIDTH, sh_degree=3,
                              mode="pallas", max_tiles_per_gaussian=K_DUP,
                              max_per_tile=MAX_PER_TILE, **kw)

    train_step = StepGraphs().train_step

    def do_render(s):
        with torch.no_grad():
            return render_jit(state.params.xyz, scales, quats, opac, cam, s,
                              bg, shs=shs, live_mask=state.live)

    one = do_render(settings())
    over, depth = int(one.num_overflow_tiles), int(one.max_tile_depth)
    two = settings(
        overflow_passes=2,
        overflow_capacity=max(512, ceil_to((depth - MAX_PER_TILE) * 5 // 4,
                                           128)),
        overflow_compact=ceil_to(max(over + over // 4, 32), 8))
    prep = preprocess(state.params.xyz, scales, quats, cam.viewmatrix,
                      cam.full_proj, cam.cam_center, WIDTH, HEIGHT, tan_x,
                      tan_x * HEIGHT / WIDTH, sh_degree=3, shs=shs,
                      live_mask=state.live)
    ext = tight_extents(prep.conics, opac, prep.radii)
    nb = 8
    data = torch.zeros((nb, MAX_PER_TILE, 16), device=dev)
    empty = torch.zeros(nb, dtype=torch.int32, device=dev)
    color, final_t, n_contrib = blend_fwd(data, empty, 4, nb)
    g_color, g_t = torch.zeros_like(color), torch.zeros_like(final_t)
    train = {"state": gm.create_from_pcd(pts, cols, sh_degree=3,
                                         capacity=N_GAUSSIANS, device=dev)}
    train["opt"] = optim.init_adam(train["state"].params)
    gt = torch.as_tensor(np.random.RandomState(0).rand(3, HEIGHT, WIDTH)
                         .astype(np.float32), device=dev)
    mask = torch.ones((HEIGHT, WIDTH), device=dev)
    lrs = optim.LearningRates.create(*TRAIN_LRS)

    def do_step():
        train["state"], train["opt"], _ = train_step(
            train["state"], train["opt"], cam, gt, mask, lrs, bg,
            LAMBDA_DSSIM, settings())
    calls = {  # what: (fn, calls per block)
        "1-pass": (lambda: do_render(settings()), args.calls),
        "2-pass": (lambda: do_render(two), args.calls),
        "binning": (lambda: bin_gaussians(
            prep.means2d, prep.depths, prep.radii, prep.visible, WIDTH,
            HEIGHT, tile=32, max_tiles_per_gaussian=K_DUP,
            max_per_tile=MAX_PER_TILE, extents=ext), args.calls),
        "blend_fwd wrapper": (lambda: blend_fwd(data, empty, 4, nb),
                              WRAPPER_CALLS),
        "blend_bwd wrapper": (lambda: blend_bwd(
            data, empty, final_t, n_contrib, g_color, g_t, 4, nb),
            WRAPPER_CALLS),
        "train step": (do_step, args.calls),
    }
    for fn, _ in calls.values():
        for _ in range(2):
            fn()
    fps = {what: [] for what in calls}
    for _ in range(args.blocks):
        for what, (fn, n) in calls.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            fps[what].append(n / (time.perf_counter() - t0))
    print(json.dumps({"package": str(photo_slam_tpu_torch.__path__[0]),
                      "card": smi, "calls_per_block": {
                          what: n for what, (_, n) in calls.items()},
                      "per_second": fps}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
