"""What every kind of cell shares: the base of a cell's run, the
configuration's precision, the program's objects built from a
configuration, and the arithmetic of the compared numbers.

A kind is a file port_bench/kinds/<kind>.py, named by a traffic mix's
"kind", that defines `Cell` (a subclass of `Base`), `NUMBERS` (the
numbers its check compares) and `CONTROLS` (the controls and faults
`Cell.control` can put in the program's place). Everything a cell needs
comes from data files: the configuration (port_bench/configs/<config>.json),
the traffic (port_bench/traffic/<traffic>.json) and the limits of the
numbers compared (port_bench/limits/<workload>.json). The program
(photo_slam_tpu_torch) is imported inside the functions that drive it.
"""
from __future__ import annotations

import math
import statistics
import time
from contextlib import contextmanager, nullcontext
from pathlib import Path

import numpy as np
import torch

from port_bench.reference import camera as rcam
from port_bench.reference import render as rren
from port_bench.reference import train as rtrain
from port_bench.trace import DeviceTrace, traced

GROUPS = rtrain.GROUPS


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def span(name: str):
    """A host span in the device trace (port_bench.<name>)."""
    return torch.profiler.record_function("port_bench." + name)


def p95(values) -> float:
    """The 95th percentile of every value (statistics.quantiles, the
    exclusive method)."""
    if len(values) < 2:
        return float(values[0])
    return statistics.quantiles(values, n=20)[-1]


def relative_gap(a: float, b: float, scale: float) -> float:
    return abs(a - b) / scale if scale > 0 else (0.0 if a == b else math.inf)


def leaf_gaps(prog: dict, ref: dict, keep=None) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    against the reference's norm of that leaf or of the median leaf,
    whichever is larger; `keep` names the leaves compared."""
    norms = {k: float(torch.linalg.norm(ref[k].double())) for k in ref}
    median = statistics.median(norms.values())
    worst = 0.0
    for k in (keep if keep is not None else ref):
        p = float(torch.linalg.norm(prog[k].double()))
        worst = max(worst, relative_gap(p, norms[k], max(norms[k], median)))
    return worst


def intrinsics(cam: dict):
    """(fovx, fovy) of the configuration's camera."""
    return (rcam.focal2fov(cam["fx"], cam["width"]),
            rcam.focal2fov(cam["fy"], cam["height"]))


def principal(cam: dict, width: int, height: int):
    """(cx, cy) scaled to (width, height), or None when centred."""
    sx, sy = width / cam["width"], height / cam["height"]
    cx, cy = cam["cx"] * sx, cam["cy"] * sy
    if abs(cx - 0.5 * width) < 1e-6 and abs(cy - 0.5 * height) < 1e-6:
        return None
    return (float(cx), float(cy))


def ref_settings(cfg: dict, width: int, height: int, tanx: float,
                 tany: float, pp) -> rren.Settings:
    caps = cfg["caps"]
    return rren.Settings(width=width, height=height, tan_fovx=tanx,
                         tan_fovy=tany, sh_degree=cfg["map"]["sh_degree"],
                         k_dup=caps["k_dup"],
                         max_per_tile=caps["max_per_tile"], principal=pp)


def view_settings(cfg: dict):
    """(reference settings, fovx, fovy) of the training views: the
    camera's full size."""
    cam = cfg["camera"]
    fovx, fovy = intrinsics(cam)
    s = ref_settings(cfg, cam["width"], cam["height"],
                     float(np.tan(0.5 * fovx)), float(np.tan(0.5 * fovy)),
                     principal(cam, cam["width"], cam["height"]))
    return s, fovx, fovy


def program_config(cfg: dict):
    """The program's Config for the configuration: the named one
    ("default": Config()), with the caps, the SH degree and the training
    options set as the configuration states them."""
    from photo_slam_tpu_torch.config import Config, dataset_config

    name = cfg["program_config"]
    pc = Config() if name == "default" else dataset_config(name)
    pc.renderer.pallas_max_tiles_per_gaussian = cfg["caps"]["k_dup"]
    pc.renderer.pallas_max_per_tile = cfg["caps"]["max_per_tile"]
    pc.model.sh_degree = cfg["map"]["sh_degree"]
    for k, v in cfg.get("train", {}).get("opt", {}).items():
        if not hasattr(pc.opt, k):
            raise KeyError(f"the program has no option opt.{k}")
        setattr(pc.opt, k, v)
    return pc


def program_state(params: dict, dev):
    """The program's GaussianState on `dev` of raw parameters (copied),
    every slot live."""
    from photo_slam_tpu_torch.models import gaussian_model as gm

    n = params["xyz"].shape[0]
    f32 = dict(dtype=torch.float32, device=dev)
    return gm.GaussianState(
        params=gm.GaussianParams(**{k: params[k].to(dev, copy=True)
                                    for k in GROUPS}),
        live=torch.ones(n, dtype=torch.bool, device=dev),
        max_radii2d=torch.zeros(n, **f32),
        xyz_grad_accum=torch.zeros(n, **f32), denom=torch.zeros(n, **f32),
        exist_since_iter=torch.zeros(n, dtype=torch.int32, device=dev))


def program_camera(cam: dict):
    from photo_slam_tpu_torch.models.camera import PINHOLE, Camera

    return Camera(camera_id=0, model_id=PINHOLE, width=cam["width"],
                  height=cam["height"], fx=cam["fx"], fy=cam["fy"],
                  cx=cam["cx"], cy=cam["cy"])


def scene_extent(views: list, points: torch.Tensor) -> float:
    """The spatial learning-rate scale: 1.1 x the largest distance of a
    camera centre from their mean, floored by the points' radius (1.1 x
    the 95th percentile of their distance from their mean) where the
    cameras span less than a quarter of it."""
    centres = np.stack([-rcam.rotation_of(q).T.astype(np.float64)
                        @ np.asarray(t, np.float64) for q, t in views])
    ext = 1.1 * float(np.linalg.norm(centres - centres.mean(0),
                                     axis=1).max())
    pts = points.double()
    radius = 1.1 * float(torch.quantile(
        torch.linalg.norm(pts - pts.mean(0), dim=1)[:1_000_000].float(),
        0.95))
    return radius if ext < 0.25 * radius else ext


def to_host(params) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in params.items()}


def set_precision(cfg: dict) -> None:
    """The precision the configuration states for the program's matrix
    products and convolutions: float32, with TF32 as cfg["precision"]
    says."""
    prec = cfg["precision"]
    if prec["dtype"] != "float32":
        raise ValueError(f"precision {prec['dtype']!r}: the program trains "
                         "and renders in float32")
    torch.backends.cuda.matmul.allow_tf32 = bool(prec["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(prec["tf32"])


@contextmanager
def exact():
    """TF32 off for the block: the reference computes its float32 products
    in float32 whatever the configuration lets the program do (its "tf32"
    control rounds its operands itself)."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


class Base:
    """A cell's run: `setup()`, `window(seconds, trace)`, `release()`, then
    `check(trace)`; `control(side)` puts a control or a fault in the
    program's place. The results: `e2e` (end-to-end values), `numbers`
    (the compared numbers), `layer` (what per-layer metrics read), and
    `reference_s`, the seconds of set-up the reference spent making the
    inputs, which are not the program's set-up."""

    def __init__(self, root: Path, cfg: dict, traffic: dict, seed: int,
                 device):
        self.root = Path(root)
        self.cfg, self.traffic, self.seed = cfg, traffic, seed % 2 ** 63
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.rng = np.random.default_rng(self.seed)
        self.trace = DeviceTrace()
        self.e2e, self.numbers, self.layer = {}, {}, {}
        self.attempted = self.failed = 0
        self.reference_s = 0.0

    def _window(self, seconds: float, trace: bool, step) -> float:
        """Call step() until `seconds` have passed; returns the window's
        seconds, which end in a synchronize."""
        ctx = traced(torch, self.trace) if trace else nullcontext()
        with ctx:
            t0 = time.perf_counter()
            end = t0 + seconds
            while time.perf_counter() < end:
                step()
            sync(self.device)
            elapsed = time.perf_counter() - t0
        return elapsed


