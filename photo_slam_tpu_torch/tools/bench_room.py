"""The room scene the blend experiments run on, and what they share.

Counterpart of tools/bench_room.py::room_scene (the JAX package's bench
scene: walls, floor and ceiling of an 8x3x12 m room plus two spheres, with
random colours), viewed from the origin at 1200x680 with a 1.2 rad
horizontal field of view, as every experiment's main() views it.
"""
from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import numpy as np
import torch

from photo_slam_tpu_torch.models import gaussian_model as gm
from photo_slam_tpu_torch.models import optimizer as optim
from photo_slam_tpu_torch.ops.binning import (TileBinning, bin_gaussians,
                                              tile_grid)
from photo_slam_tpu_torch.ops.camera_math import build_camera_matrices
from photo_slam_tpu_torch.ops.preprocess import (Preprocessed, preprocess,
                                                 tight_extents)
from photo_slam_tpu_torch.ops.tiled import entry_gather, pack_features

N_GAUSSIANS = 300_000
WIDTH, HEIGHT = 1200, 680
FOVX = 1.2
K_DUP32 = 6            # the production 32 px binning: max_tiles_per_gaussian
MAX_PER_TILE32 = 1024  # and max_per_tile


def room_scene(n: int = N_GAUSSIANS, seed: int = 0,
               rng: np.random.RandomState | None = None):
    """(points [n, 3], colours [n, 3]) float32, drawn from `rng` (bench.py
    goes on drawing from its stream), np.random.RandomState(seed) when it
    is None. The two spheres take 30,000 points each, as bench.py's do,
    when n > 60,000, and a tenth of n each at smaller n."""
    rng = np.random.RandomState(seed) if rng is None else rng
    sphere_n = 30_000 if n > 60_000 else n // 10

    def sample_box(m):
        w, h, d = 8.0, 3.0, 12.0
        per = m // 5
        faces = []
        for sx in (-w / 2, w / 2):
            faces.append(np.stack([np.full(per, sx),
                                   rng.uniform(-h / 2, h / 2, per),
                                   rng.uniform(0.2, d, per)], 1))
        for sy in (-h / 2, h / 2):
            faces.append(np.stack([rng.uniform(-w / 2, w / 2, per),
                                   np.full(per, sy),
                                   rng.uniform(0.2, d, per)], 1))
        faces.append(np.stack([rng.uniform(-w / 2, w / 2, m - 4 * per),
                               rng.uniform(-h / 2, h / 2, m - 4 * per),
                               np.full(m - 4 * per, d)], 1))
        return np.concatenate(faces)

    def sphere(m, c, r):
        v = rng.randn(m, 3)
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        return c + r * v

    pts = np.concatenate([
        sample_box(n - 2 * sphere_n),
        sphere(sphere_n, np.array([-1.0, -0.7, 4.0]), 0.8),
        sphere(sphere_n, np.array([1.5, 0.2, 6.5]), 1.1),
    ]).astype(np.float32)
    cols = rng.rand(n, 3).astype(np.float32)
    return pts, cols


class RoomView(NamedTuple):
    """The room map preprocessed for one view, as the experiments use it."""

    prep: Preprocessed
    opac: torch.Tensor      # [N] activated opacities
    extents: torch.Tensor   # [N, 2] tight_extents of the footprints
    feat: torch.Tensor      # [N, 16] packed entry rows (ops/blend.py layout)
    width: int
    height: int


def room_view(n: int = N_GAUSSIANS, *, device, width: int = WIDTH,
              height: int = HEIGHT, fovx: float = FOVX) -> RoomView:
    """The room scene (seed 0) as an SH-3 map (create_from_pcd), viewed
    from the identity pose and preprocessed on `device`."""
    pts, cols = room_scene(n)
    state = gm.create_from_pcd(pts, cols, sh_degree=3, capacity=n,
                               device=device)
    return map_view(state, device=device, width=width, height=height,
                    fovx=fovx)


def map_view(state: gm.GaussianState, *, device, width: int = WIDTH,
             height: int = HEIGHT, fovx: float = FOVX) -> RoomView:
    """An SH-3 map viewed from the identity pose and preprocessed on
    `device`."""
    cam = build_camera_matrices(np.eye(3), np.zeros(3), 0.01, 100.0, fovx,
                                fovx * height / width, device=device)
    sc, qu, op = gm.activated(state.params)
    tan_x = float(np.tan(fovx / 2))
    prep = preprocess(state.params.xyz, sc, qu, cam.viewmatrix, cam.full_proj,
                      cam.cam_center, width, height, tan_x,
                      tan_x * height / width, sh_degree=3,
                      shs=gm.sh_features(state.params), live_mask=state.live)
    return RoomView(prep=prep, opac=op,
                    extents=tight_extents(prep.conics, op, prep.radii),
                    feat=pack_features(prep, op), width=width, height=height)


def bin_view(view: RoomView, tile: int, k_dup: int,
             max_per_tile: int) -> TileBinning:
    p = view.prep
    return bin_gaussians(p.means2d, p.depths, p.radii, p.visible, view.width,
                         view.height, tile=tile, max_tiles_per_gaussian=k_dup,
                         max_per_tile=max_per_tile, extents=view.extents)


class Tiles32(NamedTuple):
    """The production pass-1 blend input: 32 px tiles, k_dup 6, K 1024."""

    binning: TileBinning
    data: torch.Tensor      # [T, K, 16] packed entries
    counts: torch.Tensor    # [T] int32
    tiles_x: int
    tiles_y: int

    @property
    def num_tiles(self) -> int:
        return self.tiles_x * self.tiles_y


def tiles32(view: RoomView) -> Tiles32:
    b = bin_view(view, 32, K_DUP32, MAX_PER_TILE32)
    gx, gy = tile_grid(view.width, view.height, 32)
    return Tiles32(binning=b, data=entry_gather(view.feat, b.tile_lists,
                                                K_DUP32),
                   counts=b.tile_counts, tiles_x=gx, tiles_y=gy)


def tiles_to_image(x: torch.Tensor, tiles_x: int, tiles_y: int, width: int,
                   height: int) -> torch.Tensor:
    """[T, ..., 8, 128] per-tile pixels (p = r * 32 + c) -> [..., H, W]."""
    extra = tuple(x.shape[1:-2])
    img = x.reshape((tiles_y, tiles_x) + extra + (32, 32))
    nex = len(extra)
    perm = tuple(range(2, 2 + nex)) + (0, 2 + nex, 1, 3 + nex)
    img = img.permute(perm).reshape(extra + (tiles_y * 32, tiles_x * 32))
    return img[..., :height, :width]


def psnr_max_diff(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    """(PSNR of b against a for a peak of 1 in dB, max |a - b|)."""
    mse = float(((a - b) ** 2).mean())
    return (10 * float(np.log10(1.0 / max(mse, 1e-12))),
            float((a - b).abs().max()))


def step_outcome(opt, params, params0, xyz_grad_accum):
    """What one step from a fresh Adam state did, for twin_errors:
    (gradients, read from Adam's first moment m = (1 - beta1) g, updates
    params - params0, xyz_grad_accum)."""
    return ([m / (1.0 - optim.BETA1) for m in opt.m],
            [p - q for p, q in zip(params, params0)], xyz_grad_accum)


def twin_errors(step, ref, rtol: float) -> dict:
    """One step from a fresh Adam state against its twin, each a
    step_outcome: per parameter group (gradient error / max, update error
    / max, max |gradient|), and "xyz_grad_accum": (its error / max,). The
    first Adam step moves an element by lr g / (|g| + eps): where |g| is
    near the gradient tolerance, the sign of a sum that the twins round
    differently decides +-lr, and eps weighs in where |g| is tiny, so
    updates are compared where |g| is above 10 rtol of its group's max."""
    (grads, upds, acc), (ref_grads, ref_upds, ref_acc) = step, ref
    out = {}
    for name, g, rg, u, ru in zip(gm.GaussianParams._fields, grads,
                                  ref_grads, upds, ref_upds):
        if rg.numel() == 0:   # features_rest at SH degree 0
            continue
        scale = float(rg.abs().max())
        sure = rg.abs() > 10 * rtol * scale
        out[name] = (float((g - rg).abs().max()) / max(scale, 1e-30),
                     float(((u - ru).abs() * sure).max())
                     / max(float(ru.abs().max()), 1e-30), scale)
    out["xyz_grad_accum"] = (float((acc - ref_acc).abs().max())
                             / max(float(ref_acc.abs().max()), 1e-30),)
    return out


def spread(errors: dict) -> float:
    """The largest error / max of twin_errors' result."""
    return max(max(e[:2]) for e in errors.values())


def time_ms(fn, reps: int, device) -> float:
    """Mean ms per call of fn() after one warm-up call: CUDA events on a
    card, the host clock on the CPU."""
    fn()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def parse_device(argv, description: str) -> torch.device:
    """The --device option of the experiments' main(): cuda unless the
    caller asks for the CPU; raises when cuda is asked for and there is no
    card."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    device = torch.device(ap.parse_args(argv).device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu to run the plain versions)")
    return device
