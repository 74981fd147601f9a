"""Where the held-out PSNR of a 30k quality fit goes, on one CUDA card.

Counterpart of tools/attr_quality.py, run as

    python -m photo_slam_tpu_torch.tools.attr_quality \
        [--ckpt-dir results/torch_quality30k_clean]

It loads the last ckpt_*.npz of a tools/quality_soak_30k.py run and
scores it on the soak's own world (tools/bench.py's room, textured by the
photo atlas at opacity 0.85; the scoring render is the 2-pass compact
continuation sized from a probe render of that world, at k_dup 6), in four
parts, under the JAX tool's report keys where the meaning is the same:

  1. held-out PSNR (the soak's `mapping_psnr_db`, reproduced) against the
     PSNR on five of the training views (0, 5, 11, 17, 23), each against
     its clean exact render: the generalization gap;
  2. the same parameters scored at k_dup 16 on both sides: what the
     production k_dup 6 clips;
  3. the scoring render with TF32 matmuls (torch.backends.cuda.matmul.
     allow_tf32, restored afterwards): the card's counterpart of the TPU's
     bf16 matmul default, which the port's tools keep off
     (`held_out_psnr_tf32_db`);
  4. the GT world's production 1-pass render against its exact render:
     what the render path, not the fit, loses.

The item-1 baseline must reproduce the soak's `mapping_psnr_db` (its
summary.json in the same directory, for the same iteration and shape)
within BASELINE_TOL_DB, or the run fails. The report, with the
checkpoint's iteration and live count, the commit, and the card's name and
power limit, is printed as one JSON line and written to
<ckpt-dir>/attribution.json. --n, --width and --height are tools/
bench.py's; --device cpu runs the kernels' plain versions.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from photo_slam_tpu_torch.models import gaussian_model as gm
from photo_slam_tpu_torch.ops import losses
from photo_slam_tpu_torch.ops.render import RenderSettings
from photo_slam_tpu_torch.tools import bench
from photo_slam_tpu_torch.tools.bench_room import (HEIGHT, MAX_PER_TILE32,
                                                   N_GAUSSIANS, WIDTH,
                                                   room_scene)
from photo_slam_tpu_torch.tools.quality_soak_30k import (REPO, git_commit,
                                                         load_ckpt)

TRAIN_SCORED = (0, 5, 11, 17, 23)   # training views scored (the JAX tool's)
K_DUP_WIDE = 16
BASELINE_TOL_DB = 0.01


def log(*a):
    print(*a, file=sys.stderr, flush=True)


@contextlib.contextmanager
def tf32_matmuls():
    """torch.backends.cuda.matmul.allow_tf32 on inside, as it was after."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


class Scoring(NamedTuple):
    """The soak's world and its scoring renders."""

    gt: gm.GaussianState     # the GT world (bench.gt_world)
    settings: RenderSettings  # the production 1-pass render
    exact: RenderSettings     # the scoring render (bench.probe_exact)
    train_cams: list          # the TRAIN_SCORED training views
    test_cams: list           # the 2 held-out views
    bg: torch.Tensor


def scoring(pts: np.ndarray, width: int, height: int, device) -> Scoring:
    """bench.quality_protocol's world, cameras and scoring render, without
    its training images."""
    settings = bench.settings_for(width, height, MAX_PER_TILE32)
    gt = bench.gt_world(pts, device)
    bg = torch.zeros(3, device=device)
    return Scoring(
        gt=gt, settings=settings,
        exact=bench.probe_exact(gt, settings, bg),
        train_cams=[bench.camera(*bench.TRAIN_VIEWS[i], width, height,
                                 device) for i in TRAIN_SCORED],
        test_cams=[bench.camera(*v, width, height, device)
                   for v in bench.TEST_VIEWS], bg=bg)


def renders(state, cams, settings, bg) -> list[torch.Tensor]:
    with torch.no_grad():
        return [bench.render_image(state, c, settings, bg).image
                for c in cams]


def psnrs(state, cams, settings, bg, targets) -> list[float]:
    """PSNR of the state's render of each camera against its target."""
    return [float(losses.psnr(img, t)) for img, t in
            zip(renders(state, cams, settings, bg), targets)]


def attribute(sc: Scoring, state) -> dict:
    """The four attributions of `state`, unrounded PSNRs in dB, each view's
    under "per_view"."""
    gt, bg, exact = sc.gt, sc.bg, sc.exact
    wide = exact._replace(max_tiles_per_gaussian=K_DUP_WIDE)
    gt_tests = renders(gt, sc.test_cams, exact, bg)
    held_out = psnrs(state, sc.test_cams, exact, bg, gt_tests)
    train = psnrs(state, sc.train_cams, exact, bg,
                  renders(gt, sc.train_cams, exact, bg))
    held_out_wide = psnrs(state, sc.test_cams, wide, bg,
                          renders(gt, sc.test_cams, wide, bg))
    with tf32_matmuls():
        held_out_tf32 = psnrs(state, sc.test_cams, exact, bg, gt_tests)
    gt_1pass = psnrs(gt, sc.test_cams, sc.settings, bg, gt_tests)
    ho, tv = float(np.mean(held_out)), float(np.mean(train))
    return {
        "held_out_psnr_db": ho,
        "train_view_psnr_db": tv,
        "generalization_gap_db": tv - ho,
        "held_out_psnr_kdup16_db": float(np.mean(held_out_wide)),
        "held_out_psnr_tf32_db": float(np.mean(held_out_tf32)),
        "gt_render_1pass_vs_exact_db": float(np.mean(gt_1pass)),
        "per_view": {"held_out": held_out, "train": train,
                     "held_out_kdup16": held_out_wide,
                     "held_out_tf32": held_out_tf32,
                     "gt_1pass_vs_exact": gt_1pass},
    }


def check_baseline(held_out_db: float, soak_db) -> None:
    """The item-1 baseline must reproduce the soak's mapping_psnr_db (None:
    no soak summary to hold it to)."""
    if soak_db is not None and abs(held_out_db - soak_db) > BASELINE_TOL_DB:
        raise RuntimeError(f"the baseline {held_out_db:.4f} dB does not "
                           f"reproduce the soak's mapping_psnr_db {soak_db} "
                           f"within {BASELINE_TOL_DB} dB")


def soak_baseline(ckpt_dir: Path, it: int, n: int, width: int,
                  height: int):
    """The soak's mapping_psnr_db for iteration `it` at this shape, from
    its summary.json in ckpt_dir; None where there is none."""
    path = ckpt_dir / "summary.json"
    if not path.exists():
        return None
    s = json.loads(path.read_text())
    p = s.get("protocol", {})
    if (s.get("iters_done") != it or p.get("gaussians_gt") != n
            or (p.get("width"), p.get("height")) != (width, height)):
        return None
    return s["mapping_psnr_db"]


def parse_args(argv):
    from photo_slam_tpu_torch.apps.online_slam import cli_device

    ap = argparse.ArgumentParser(description="Attribute a quality soak's "
                                 "held-out PSNR on one card.")
    ap.add_argument("--ckpt-dir", type=Path,
                    default=REPO / "results" / "torch_quality30k_clean")
    ap.add_argument("--n", type=int, default=N_GAUSSIANS,
                    help="Gaussians of the room scene")
    ap.add_argument("--width", type=int, default=WIDTH)
    ap.add_argument("--height", type=int, default=HEIGHT)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--commit", default=None,
                    help="what the run's sources are, for the report "
                         "(default: git rev-parse HEAD of the checkout)")
    args = ap.parse_args(argv)
    return args, cli_device(args.device)


def main(argv=None) -> dict:
    t_start = time.time()
    args, dev = parse_args(argv)
    card = bench.card_name_power() if dev.type == "cuda" else None
    ckpts = sorted(args.ckpt_dir.glob("ckpt_*.npz"))
    if not ckpts:
        raise FileNotFoundError(f"no ckpt_*.npz under {args.ckpt_dir}")
    state, _, it, _ = load_ckpt(ckpts[-1], dev)
    live = int(gm.num_live(state))
    log(f"[attr] {ckpts[-1].name}: iteration {it}, live {live} on {dev} "
        f"({card})")
    pts, _ = room_scene(args.n, rng=np.random.RandomState(0))
    sc = scoring(pts, args.width, args.height, dev)
    report = {"ckpt": ckpts[-1].name, "ckpt_iter": it, "live": live,
              **attribute(sc, state)}
    ho = report["held_out_psnr_db"]
    soak = soak_baseline(args.ckpt_dir, it, args.n, args.width, args.height)
    check_baseline(ho, soak)
    report.update({
        "soak_mapping_psnr_db": soak,
        "kdup6_clipping_db": report["held_out_psnr_kdup16_db"] - ho,
        "tf32_effect_db": report["held_out_psnr_tf32_db"] - ho,
        "exact_compact": sc.exact.overflow_compact,
        "exact_capacity": sc.exact.overflow_capacity,
        "n": args.n, "width": args.width, "height": args.height,
        "wall_s": round(time.time() - t_start, 1),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
        "card": card, "commit": args.commit or git_commit()})
    log(f"[attr] held-out {ho:.3f} dB (soak {soak}), train-view "
        f"{report['train_view_psnr_db']:.3f} (gap "
        f"{report['generalization_gap_db']:+.3f}); k_dup 16 "
        f"{report['held_out_psnr_kdup16_db']:.3f} "
        f"({report['kdup6_clipping_db']:+.3f}); TF32 "
        f"{report['held_out_psnr_tf32_db']:.3f} "
        f"({report['tf32_effect_db']:+.3f}); GT 1-pass vs exact "
        f"{report['gt_render_1pass_vs_exact_db']:.3f}")
    (args.ckpt_dir / "attribution.json").write_text(
        json.dumps(report, indent=2) + "\n")
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
