"""ORB a frame on the card, for comparing two checkouts of the port.

Renders tools/synth_replica.py's 120-frame room, by default at 1200x680
(chip_smoke's sequence), takes the frontend's grey image of FRAMES, and
times `tracking/vision.py::orb_detect_and_compute` at FEATURES (the
frontend's) on `--device`: after one warm-up call per frame, `--reps`
calls per frame on the host clock with the device synchronized at each
end. Where the package has the descriptor stage as functions of its own
(`orb_level_blur`, `orb_descriptors`), that stage alone is timed the same
way on the keypoints ORB found.

The script imports `photo_slam_tpu_torch` from the path, so it times the
checkout that PYTHONPATH names first; to time another checkout (e.g. a
parent unpacked by `git archive` under build/) run it by its file path,
in turns:

    PYTHONPATH=<checkout> python3 photo_slam_tpu_torch/tools/time_orb.py

Prints one JSON line: the package's path, the card's `nvidia-smi` name and
power limit, and for each frame the keypoints and the ms a call.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

import photo_slam_tpu_torch
from photo_slam_tpu_torch.tools.synth_replica import SynthReplica
from photo_slam_tpu_torch.tracking.frontend import SlamFrontend
from photo_slam_tpu_torch.tracking import vision

FRAMES = (0, 60, 119)
FEATURES = 1000


def timed(fn, device, reps) -> float:
    """ms a call of fn(), the device synchronized around `reps` calls."""
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync()
    return 1e3 * (time.perf_counter() - t0) / reps


def descriptor_stage(gray, f, device):
    """A function running orb_level_blur and orb_descriptors on each level
    for f's keypoints (the features of `gray`)."""
    levels = vision.pyramid(torch.as_tensor(gray).to(device).to(torch.int32))
    scales = vision.level_scales()
    work = []
    for lvl in np.unique(f.level):
        on = f.level == lvl
        xy = np.rint(f.px[on] / scales[lvl]).astype(np.int64)
        work.append((levels[lvl], *(torch.from_numpy(v).to(device) for v in
                                    (xy[:, 1], xy[:, 0], f.angle[on]))))
    return lambda: [vision.orb_descriptors(vision.orb_level_blur(im), ys, xs,
                                           a) for im, ys, xs, a in work]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--width", type=int, default=1200)
    ap.add_argument("--height", type=int, default=680)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    seq = list(SynthReplica(120, args.width, args.height,
                            device=device).frames())
    smi = None
    if device.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    rows = []
    for i in FRAMES:
        gray = SlamFrontend._to_gray(seq[i].image)
        f = vision.orb_detect_and_compute(gray, FEATURES, device)
        row = dict(frame=i, keypoints=len(f.px), ms=timed(
            lambda: vision.orb_detect_and_compute(gray, FEATURES, device),
            device, args.reps))
        if hasattr(vision, "orb_descriptors"):
            stage = descriptor_stage(gray, f, device)
            stage()
            row["descriptor_stage_ms"] = timed(stage, device, args.reps)
        rows.append(row)
    print(json.dumps(dict(package=photo_slam_tpu_torch.__file__, card=smi,
                          size=[args.width, args.height],
                          features=FEATURES, reps=args.reps,
                          frames=rows)), flush=True)


if __name__ == "__main__":
    main()
