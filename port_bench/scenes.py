"""The benchmark's inputs, made from the seed: the maps, the training views
and the viewer's poses.

A configuration's "map" and "views" blocks each name a generator by their
"kind": port_bench/maps/<kind>.py (a function `surface(spec, gen, device)`
that places the points and gives their colours) and
port_bench/views/<kind>.py (a function `views(spec, rng)`). What is common
to every map, a fitted map's per-Gaussian shape (scales, rotations,
opacities, SH), is drawn here, from a torch.Generator on the device in a
few large calls; each such choice is the configuration file's `assumed`.
"""
from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from port_bench import byname
from port_bench.reference.render import SH_C0


def make_map(root: Path, spec: dict, gen, device) -> dict:
    """The raw parameters (the program's six groups) of a map of
    spec["gaussians"] Gaussians at SH degree spec["sh_degree"], placed and
    coloured by port_bench/maps/<spec["kind"]>.py: each has a mean scale of
    spec["scale"] m, anisotropic by spec["scale_spread"] (log-normal per
    axis), a random rotation, an opacity uniform in spec["opacity"] and
    higher SH bands N(0, spec["sh_rest"])."""
    n = spec["gaussians"]
    xyz, rgb = byname.module(root, "maps", spec["kind"]).surface(
        spec, gen, device)
    k_rest = (spec["sh_degree"] + 1) ** 2 - 1
    lo, hi = spec["opacity"]
    opac = torch.rand((n, 1), generator=gen, device=device) * (hi - lo) + lo
    return {
        "xyz": xyz.float().contiguous(),
        "features_dc": ((rgb - 0.5) / SH_C0)[:, None, :].contiguous(),
        "features_rest": spec["sh_rest"] * torch.randn(
            (n, k_rest, 3), generator=gen, device=device),
        "opacity_logit": torch.log(opac / (1.0 - opac)),
        "log_scales": math.log(spec["scale"]) + spec["scale_spread"]
        * torch.randn((n, 3), generator=gen, device=device),
        "quats": torch.nn.functional.normalize(
            torch.randn((n, 4), generator=gen, device=device), dim=1),
    }


def views(root: Path, spec: dict, rng: np.random.Generator) -> list:
    """The configuration's training views (spec = its "views" block) as
    world -> camera (quat, t), from port_bench/views/<spec["kind"]>.py."""
    return byname.module(root, "views", spec["kind"]).views(spec, rng)


def perturb(params: dict, noise: dict, gen) -> dict:
    """A copy of params with N(0, noise[group]) added to each group named
    in `noise` (the map a training run starts from)."""
    out = {}
    for k, v in params.items():
        sigma = noise.get(k, 0.0)
        out[k] = v + sigma * torch.randn(v.shape, generator=gen,
                                         device=v.device) if sigma else \
            v.clone()
    return out


def jittered_poses(base: list, count: int, yaw: float, shift: float,
                   rng: np.random.Generator) -> list:
    """`count` poses, each a view of `base` (drawn uniformly) turned by a
    yaw uniform in +-yaw about y and moved by a shift uniform in +-shift m
    on each axis of the camera frame."""
    out = []
    for _ in range(count):
        q, t = base[int(rng.integers(len(base)))]
        dyaw = rng.uniform(-yaw, yaw)
        w, y = q[0], q[2]
        # (w, 0, y, 0) * (cos, 0, sin, 0): two turns about the same axis.
        dq = np.array([math.cos(dyaw / 2), 0.0, math.sin(dyaw / 2), 0.0])
        q2 = np.array([w * dq[0] - y * dq[2], 0.0, w * dq[2] + y * dq[0],
                       0.0])
        out.append((q2, np.asarray(t) + rng.uniform(-shift, shift, 3)))
    return out
