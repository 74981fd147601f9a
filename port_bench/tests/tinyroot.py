"""A checkout-shaped directory holding a benchmark whose configurations,
traffic mixes, limits, kinds, generators and per-layer metric exist only as
its own files: the harness finds them by name and runs them on the CPU at
a tiny size.

Beside copies of the benchmark's own kinds and generators it holds one of
each that the benchmark does not have: the kind "tinykind" (the view
service's frames, with an end-to-end metric of its own), the map "tinywall"
and the views "tinyline", which the configuration "tinywall" names."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY_CAMERA = {"width": 96, "height": 64, "fx": 80.0, "fy": 80.0,
               "cx": 47.5, "cy": 31.5}
METRIC = '''"""Iterations or frames in the window (a test's reader)."""


def read(layer):
    return float(layer["count"]) if layer.get("count") else None
'''
KIND = '''"""A test's kind: the view service's frames, also counted as the
end-to-end metric tiny_frames."""
from port_bench.kinds.view import CONTROLS, NUMBERS  # noqa: F401
from port_bench.kinds.view import Cell as View


class Cell(View):
    def window(self, seconds, trace):
        super().window(seconds, trace)
        self.e2e["tiny_frames"] = float(self.attempted)
'''
MAP = '''"""A test's map: a wall 4 m ahead, 3 x 2 m, grey."""
import torch


def surface(spec, gen, device):
    n = spec["gaussians"]
    u = torch.rand((n, 2), generator=gen, device=device)
    xyz = torch.stack([3.0 * u[:, 0] - 1.5, 2.0 * u[:, 1] - 1.0,
                       torch.full((n,), 4.0, device=device)], 1)
    return xyz, torch.full((n, 3), 0.6, device=device)
'''
VIEWS = '''"""A test's views: spec["count"] cameras on a line along x, looking
down +z."""
import numpy as np


def views(spec, rng):
    return [(np.array([1.0, 0.0, 0.0, 0.0]),
             np.array([0.1 * i - 0.15, 0.0, 0.0]))
            for i in range(spec["count"])]
'''


def make(root: Path, poses: int = 12) -> Path:
    """Write the tiny benchmark under `root`; returns root."""
    bench = root / "port_bench"
    for sub in ("kinds", "maps", "views"):
        shutil.copytree(REPO / "port_bench" / sub, bench / sub,
                        ignore=shutil.ignore_patterns("__pycache__"),
                        dirs_exist_ok=True)
    for sub in ("configs", "traffic", "limits", "metrics"):
        (bench / sub).mkdir(parents=True, exist_ok=True)
    cfg = json.loads((REPO / "port_bench/configs/replica_rgbd.json")
                     .read_text())
    cfg.update(name="tinyroom", camera=TINY_CAMERA,
               caps={"k_dup": 6, "max_per_tile": 64})
    cfg["map"].update(gaussians=3000, scale=0.15)
    (bench / "configs/tinyroom.json").write_text(json.dumps(cfg))
    cfg = dict(cfg, name="tinywall", views={"kind": "tinyline", "count": 4})
    cfg["map"] = dict(cfg["map"], kind="tinywall", gaussians=2000)
    (bench / "configs/tinywall.json").write_text(json.dumps(cfg))
    (bench / "kinds/tinykind.py").write_text(KIND)
    (bench / "maps/tinywall.py").write_text(MAP)
    (bench / "views/tinyline.py").write_text(VIEWS)
    (bench / "traffic/tinytrain.json").write_text(json.dumps(
        {"kind": "train", "check_iterations": 3}))
    view = {"kind": "view", "poses": poses, "yaw": 0.15, "shift": 0.1,
            "checked": 3, "checked_from": min(poses, 4)}
    (bench / "traffic/tinyview.json").write_text(json.dumps(view))
    (bench / "traffic/tinykind.json").write_text(json.dumps(
        dict(view, kind="tinykind")))
    for cell, like in (("tinyroom.tinytrain", "train"),
                       ("tinyroom.tinyview", "view"),
                       ("tinywall.tinykind", "view")):
        shutil.copy(REPO / "port_bench/limits" / f"replica_rgbd.{like}.json",
                    bench / "limits" / f"{cell}.json")
    (bench / "metrics/tiny_count.py").write_text(METRIC)
    manifest = {
        "command": ["python3", "-m", "port_bench.run"],
        "paths": ["port_bench"], "run_seconds": 1,
        "configs": [{"name": name, "source": "a test",
                     "file": f"port_bench/configs/{name}.json",
                     "reduced": [], "why": "a test"}
                    for name in ("tinyroom", "tinywall")],
        "workloads": [
            {"name": "tinyroom.tinytrain", "config": "tinyroom",
             "traffic": "tinytrain", "chips": 1, "why": "a test"},
            {"name": "tinyroom.tinyview", "config": "tinyroom",
             "traffic": "tinyview", "chips": 1, "why": "a test"},
            {"name": "tinywall.tinykind", "config": "tinywall",
             "traffic": "tinykind", "chips": 1, "why": "a test"}],
        "end_to_end": [
            {"name": "train_it_s", "unit": "it/s", "better": "higher",
             "bound": 0.05, "source": "host_clock",
             "workloads": ["tinyroom.tinytrain"]},
            {"name": "view_fps", "unit": "frames/s", "better": "higher",
             "bound": 0.05, "source": "host_clock",
             "workloads": ["tinyroom.tinyview"]},
            {"name": "tiny_frames", "unit": "frames", "better": "higher",
             "bound": 0.05, "source": "host_clock",
             "workloads": ["tinywall.tinykind"]},
            {"name": "setup_s", "unit": "s", "better": "lower",
             "bound": 0.25, "source": "host_clock"}],
        "per_layer": [
            {"name": "tiny_count", "unit": "1", "better": "higher",
             "source": "host_clock", "layer": "entry points",
             "moves": "train_it_s"}],
    }
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    return root
