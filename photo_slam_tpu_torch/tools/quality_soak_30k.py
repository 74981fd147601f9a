"""The 30,000-iteration held-out quality protocol on one CUDA card.

Counterpart of tools/quality_soak_30k.py, run as

    python -m photo_slam_tpu_torch.tools.quality_soak_30k [--clean]

It runs the port's bench's quality protocol (photo_slam_tpu_torch/tools/
bench.py, whose functions it shares) at the reference's length (the
30,100-iteration Replica RGB-D protocol, cfg/gaussian_mapper/RGB-D/Replica/
replica_rgbd.yaml:55-73): the room (300,000 points) textured by the photo
atlas at opacity 0.85, 24 training views rendered through the exact
overflow continuation (sized from a probe render of that world) and
corrupted by the sensor model (--clean leaves them clean: the control run),
2 clean held-out views; a fresh model of 150,000 noisy grey points with
1.5x headroom (capacity 450,000), densified every 100 iterations in
(600, 15000] with no opacity reset, the position LR 3.2e-4 times the
scene's extent. The steps run as JAX's soak runs them: train_chunk in
chunks of 100 iterations (bench.fit; one captured step graph replayed 100
times, mapper/trainer.py::StepGraphs), single steps up to the next
multiple of 100 where a resumed run starts between two.

Every 2,000 iterations it appends a telemetry line (loss, held-out PSNR of
the first test view, live Gaussians, iterations per second) to
telemetry.jsonl; every 3,000 it writes a checkpoint in the trainer's npz
layout (mapper/trainer.py::save_state_npz, which either package's
GaussianTrainer.load_checkpoint loads) with the densify generator's state
beside it, keeping the last two, and a run started on a directory that
holds one resumes from it. At the end it scores both held-out views and
writes summary.json: the scores, the commit, the card and its power limit,
the protocol's parameters, and where the loop's time went (the pure step
rate measured first, then the densify, telemetry and checkpoint spans,
each timed with the card waited for, as the JAX tool's timers are).
Output: results/torch_quality30k/ (results/torch_quality30k_clean/ with
--clean), or --out.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from photo_slam_tpu_torch.mapper.trainer import (StepGraphs,
                                                 load_state_npz,
                                                 save_state_npz)
from photo_slam_tpu_torch.models import gaussian_model as gm
from photo_slam_tpu_torch.models import optimizer as optim
from photo_slam_tpu_torch.tools import bench
from photo_slam_tpu_torch.tools.bench_room import (HEIGHT, K_DUP32,
                                                   MAX_PER_TILE32,
                                                   N_GAUSSIANS, WIDTH,
                                                   room_scene)

REPO = Path(__file__).resolve().parents[2]
CKPT_EVERY = 3000
STEP_REPS = 30    # steps that time the pure step rate


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def git_commit() -> str | None:
    """The checkout's HEAD, or None where it is no git checkout."""
    try:
        return subprocess.run(["git", "rev-parse", "HEAD"], cwd=REPO,
                              capture_output=True, text=True, check=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def save_ckpt(path: Path, state, opt, it: int, gen: torch.Generator,
              extent: float) -> None:
    """The trainer's layout: meta [iteration, SH degree 3, Adam step],
    meta_f [ema loss 0, spatial LR scale, position LR], so that a
    GaussianTrainer resumes it at the protocol's position LR; the densify
    generator's state as "generator"."""
    save_state_npz(path, state, opt, meta=[it, 3, int(opt.step)],
                   meta_f=[0.0, max(extent, 1.0), bench.POSITION_LR],
                   compressed=False, generator=gen.get_state().numpy())


def load_ckpt(path: Path, device):
    """(state, opt, iteration, generator) of a save_ckpt checkpoint."""
    state, opt, data = load_state_npz(path, device)
    gen = torch.Generator(device=device)
    gen.set_state(torch.from_numpy(data["generator"]))
    return state, opt, int(data["meta"][0]), gen


def parse_args(argv):
    ap = argparse.ArgumentParser(description="The 30k-iteration held-out "
                                 "quality protocol on one card.")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--clean", action="store_true",
                    help="train on clean renders (the sensor model off)")
    ap.add_argument("--out", type=Path, default=None,
                    help="output directory (default results/"
                         "torch_quality30k[_clean])")
    ap.add_argument("--iters", type=int, default=bench.PROTOCOL_ITERS)
    ap.add_argument("--commit", default=None,
                    help="what the run's sources are, for the summary "
                         "(default: git rev-parse HEAD of the checkout)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if args.out is None:
        args.out = REPO / "results" / ("torch_quality30k_clean" if args.clean
                                       else "torch_quality30k")
    return args, device


def main(argv=None) -> dict:
    t_start = time.time()
    args, dev = parse_args(argv)
    out = args.out
    out.mkdir(parents=True, exist_ok=True)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    card = bench.card_name_power() if dev.type == "cuda" else None
    n, width, height = N_GAUSSIANS, WIDTH, HEIGHT
    capacity = n * 3 // 2
    rng = np.random.RandomState(0)
    pts, _ = room_scene(n, rng=rng)
    rng.rand(3, height, width)  # bench's train-step ground truth
    proto = bench.quality_protocol(pts, width, height, dev, clean=args.clean)
    log(f"[soak] protocol set up in {time.time() - t_start:.1f} s "
        f"(clean={args.clean}, exact compact {proto.exact.overflow_compact} "
        f"capacity {proto.exact.overflow_capacity}) on {dev} ({card})")

    ckpts = sorted(out.glob("ckpt_*.npz"))
    if ckpts:
        state, opt, start, gen = load_ckpt(ckpts[-1], dev)
        log(f"[soak] resumed {ckpts[-1].name} at iteration {start}")
    else:
        state = bench.fresh_model(pts, rng, capacity, dev)
        opt = optim.init_adam(state.params)
        start = 0
        gen = torch.Generator(device=dev).manual_seed(0)

    # The pure step rate at this capacity, on a throwaway copy.
    ms_state = gm.clone_state(state)
    ms_opt = optim.init_adam(ms_state.params)
    ms_graphs = StepGraphs()

    def one_step():
        nonlocal ms_state, ms_opt
        ms_state, ms_opt, _ = ms_graphs.train_step(
            ms_state, ms_opt, proto.views[0], proto.gt_views[0], proto.mask,
            proto.lrs, proto.bg, bench.LAMBDA_DSSIM, proto.settings)

    step_ms = bench.timed_ms(one_step, STEP_REPS, dev)
    del ms_state, ms_opt, ms_graphs
    log(f"[soak] pure step at capacity {capacity}: {step_ms:.2f} ms "
        f"({1e3 / step_ms:.2f} it/s)")

    spans = {"densify_s": 0.0, "telemetry_s": 0.0, "ckpt_s": 0.0}
    tel_path = out / "telemetry.jsonl"
    # A resumed run keeps the telemetry up to its checkpoint.
    telemetry = [rec for rec in map(json.loads, tel_path.read_text()
                                    .splitlines())
                 if rec["iter"] <= start] if start and tel_path.exists() \
        else []
    tel_path.write_text("".join(json.dumps(r) + "\n" for r in telemetry))
    t0 = time.time()
    last = [t0, start]

    def on_iter(i, st, op, met):
        if i % bench.TELEMETRY_EVERY == 0:
            # Wait for the queued steps before the timer: that wait is step
            # time, which step_ms already holds.
            bench.sync(dev)
            t_d = time.perf_counter()
            now = time.time()
            rec = {"iter": i, "loss": round(float(met["loss"]), 5),
                   "held_out_psnr_db": round(
                       bench.held_out(proto, st, 1)[0][0], 3),
                   "live": int(gm.num_live(st)),
                   "iters_per_sec": round((i - start) / (now - t0), 2),
                   "window_iters_per_sec": round(
                       (i - last[1]) / (now - last[0]), 2),
                   "wall_s": round(now - t_start, 1)}
            last[:] = [now, i]
            telemetry.append(rec)
            with open(tel_path, "a") as f:
                f.write(json.dumps(rec) + "\n")
            log(f"[soak] {rec}")
            spans["telemetry_s"] += time.perf_counter() - t_d
        if i % CKPT_EVERY == 0:
            bench.sync(dev)
            t_d = time.perf_counter()
            save_ckpt(out / f"ckpt_{i:06d}.npz", st, op, i, gen,
                      proto.extent)
            for old in sorted(out.glob("ckpt_*.npz"))[:-2]:
                old.unlink()
            spans["ckpt_s"] += time.perf_counter() - t_d
        return False

    state, opt, done = bench.fit(proto, state, opt, gen, start, args.iters,
                                 on_iter, spans)
    bench.sync(dev)
    loop_wall = time.time() - t0
    scores = bench.held_out(proto, state)
    psnr = float(np.mean([p for p, _ in scores]))
    ssim = float(np.mean([s for _, s in scores]))
    iters_run = max(done - start, 1)
    step_total_s = iters_run * step_ms / 1e3
    throughput = {
        "step_ms_sync": round(step_ms, 3),
        "step_iters_per_sec": round(1e3 / step_ms, 2),
        "loop_iters_per_sec": round(iters_run / loop_wall, 2),
        "loop_wall_s": round(loop_wall, 1),
        "step_compute_s": round(step_total_s, 1),
        **{k: round(v, 1) for k, v in spans.items()},
        "other_s": round(loop_wall - step_total_s - sum(spans.values()), 1),
    }
    log(f"[soak] throughput: {throughput}")
    summary = {
        "clean_train": args.clean,
        "throughput": throughput,
        "protocol_iters": args.iters,
        "iters_done": done,
        "resumed_from_iter": start,
        "mapping_psnr_db": round(psnr, 2),
        "mapping_ssim": round(ssim, 4),
        "per_test_view": [{"psnr_db": round(p, 3), "ssim": round(s, 4)}
                          for p, s in scores],
        "gaussians": int(gm.num_live(state)),
        "wall_s": round(time.time() - t_start, 1),
        "telemetry": telemetry,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
        "card": card,
        "commit": args.commit or git_commit(),
        "protocol": {
            "gaussians_gt": n, "width": width, "height": height,
            "capacity": capacity, "init_points": n // 2,
            "gt_opacity": bench.GT_OPACITY,
            "train_views": len(bench.TRAIN_VIEWS),
            "test_views": len(bench.TEST_VIEWS),
            "sensor_model": not args.clean,
            "densify": {"every": bench.DENSIFY_EVERY,
                        "from": bench.DENSIFY_FROM,
                        "until": bench.DENSIFY_UNTIL, **bench.DENSIFY},
            "opacity_reset": None,
            "position_lr": proto.lrs.xyz, "extent": proto.extent,
            "lambda_dssim": bench.LAMBDA_DSSIM,
            "k_dup": K_DUP32, "max_per_tile": MAX_PER_TILE32,
            "exact_compact": proto.exact.overflow_compact,
            "exact_capacity": proto.exact.overflow_capacity,
            "ckpt_every": CKPT_EVERY,
            "telemetry_every": bench.TELEMETRY_EVERY,
        },
    }
    with open(out / "summary.json", "w") as f:
        json.dump(summary, f, indent=2)
    if not (out / f"ckpt_{done:06d}.npz").exists():
        save_ckpt(out / f"ckpt_{done:06d}.npz", state, opt, done, gen,
                  proto.extent)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
