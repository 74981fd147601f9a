"""The port's benchmark: bench.py's measurements on one CUDA card, printed
as one JSON line.

Counterpart of bench.py, run as

    python -m photo_slam_tpu_torch.tools.bench [--device cuda]

at bench.py's shapes and settings (bench.py:235-258): the room scene of
tools/bench_room.py (seed 0) as 300,000 Gaussians at SH 3, seen from the
identity pose at 1200x680 with a 1.2 rad horizontal field of view, k_dup 6
and 1024 entries a tile, through the entry points the apps take: the
renders through ops/render.py::render_jit and the steps through
mapper/trainer.py::StepGraphs (captured CUDA graphs, replayed). It
measures, in bench.py's order:

  * the 1-pass render's FPS and its clipped and overflow counts;
  * the exact render (4096 a tile) and the 2-pass compact render sized from
    the measured overflow (bench.py:320-331), both PSNRs against the exact
    render, and the 2-pass FPS;
  * train_step it/s at lambda 0.2 on the seeded random ground truth
    (bench.py:364-388), and the B = 4 batched step's views/s
    (bench.py:390-425);
  * stage_ms: the render (fwd), the backward (loss forward and backward
    less the render), the binning and Adam, each dispatched op by op;
  * the held-out mapping quality of bench.py's protocol (bench.py:482-650,
    the functions below, which tools/quality_soak_30k.py shares): a fresh
    model fitted to 24 corrupted exact renders of the photo-textured room
    and scored on 2 clean held-out views.

The line has bench.py's layout (`emit`, bench.py:95-101): "metric",
"value", "unit", "vs_baseline" (against 30 FPS) and "extra" with bench.py's
keys, the device the run took, and the card's name and power limit as
nvidia-smi gives them. Every phase runs or fails the program: there is no
retry and no partial line. The deadline (--deadline seconds from the
start) only shortens the quality fit, and the line says how many
iterations it ran ("quality_iters"). Diagnostics go to stderr.

With --device cpu it runs the kernels' plain versions, and each timed loop
runs once (REPS): a CPU time is no device metric, so the line only shows
that every phase runs ("device": "cpu", "card": null).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from photo_slam_tpu_torch.mapper.trainer import StepGraphs, densify_step
from photo_slam_tpu_torch.models import gaussian_model as gm
from photo_slam_tpu_torch.models import optimizer as optim
from photo_slam_tpu_torch.ops import losses
from photo_slam_tpu_torch.ops.binning import bin_gaussians
from photo_slam_tpu_torch.ops.camera_math import (CameraMatrices,
                                                  build_camera_matrices)
from photo_slam_tpu_torch.ops.preprocess import preprocess, tight_extents
from photo_slam_tpu_torch.ops.render import (RenderSettings, render,
                                             render_jit)
from photo_slam_tpu_torch.tools.bench_room import (FOVX, HEIGHT, K_DUP32,
                                                   MAX_PER_TILE32,
                                                   N_GAUSSIANS, WIDTH,
                                                   room_scene)
from photo_slam_tpu_torch.tools.synth_replica import (corrupt_frame,
                                                      photo_atlas,
                                                      photo_colors)
from photo_slam_tpu_torch.utils.math import inverse_sigmoid

BASELINE_FPS = 30.0          # BASELINE.md's real-time north star
EXACT_PER_TILE = 4096
BATCH = 4


class Reps(NamedTuple):
    fps: int      # timed renders
    warmup: int   # steps before the timed train steps
    train: int    # timed train steps
    stage: int    # timed calls of each stage


# bench.py's counts on the card; once each on the CPU.
REPS = {"cuda": Reps(fps=30, warmup=3, train=20, stage=50),
        "cpu": Reps(fps=1, warmup=1, train=1, stage=1)}
LAMBDA_DSSIM = 0.2
LRS = (1.6e-4, 2.5e-3, 0.05, 5e-3, 1e-3)   # bench.py:366
DEADLINE_S = 1350.0          # bench.py's BENCH_DEADLINE_S default
SCORE_RESERVE_S = 45.0       # kept for the held-out scoring (bench.py)
DEADLINE_CHECK_EVERY = 200   # fit iterations between deadline checks
# fit's train_chunk length (JAX's soak's CHUNK): it divides the densify,
# telemetry, deadline-check and checkpoint periods.
CHUNK = 100

# The quality protocol (bench.py:482-650; tools/quality_soak_30k.py).
GT_OPACITY = 0.85
PROTOCOL_ITERS = 30_000
CORRUPT_SEED = 7
DENSIFY_EVERY, DENSIFY_FROM, DENSIFY_UNTIL = 100, 600, 15_000
DENSIFY = dict(grad_threshold=1e-3, min_opacity=0.02, max_screen_size=0,
               percent_dense=0.01)
POSITION_LR = 3.2e-4         # times the extent (replica_rgbd.yaml:55-73)
TELEMETRY_EVERY = 2000
# (yaw, tx, ty, tz) of the 24 training and 2 held-out views.
TRAIN_VIEWS = tuple((0.09 * (i - 11), 0.22 * (i % 5 - 2), 0.1 * (i % 3 - 1),
                     0.35 * (i % 4)) for i in range(24))
TEST_VIEWS = ((0.05, -0.15, 0.06, 0.2), (-0.35, 0.3, -0.05, 0.7))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def card_name_power() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_ms(fn, reps: int, device) -> float:
    """Mean ms per call of fn() over `reps` calls after one, the card
    waited for on both sides (bench.py's timeit)."""
    fn()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync(device)
    return (time.perf_counter() - t0) / reps * 1e3


def ceil_to(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def settings_for(width: int, height: int, max_per_tile: int,
                 **kw) -> RenderSettings:
    tan_x = float(np.tan(FOVX / 2))
    return RenderSettings(width=width, height=height, tan_fovx=tan_x,
                          tan_fovy=tan_x * height / width, sh_degree=3,
                          mode="pallas", max_tiles_per_gaussian=K_DUP32,
                          max_per_tile=max_per_tile, **kw)


def exact_settings(settings: RenderSettings, over_tiles: int,
                   max_depth: int) -> RenderSettings:
    """The 2-pass compact continuation sized from a render's overflow
    (bench.py:320-331): every overflowed tile with 25 % headroom, and the
    deepest tile's tail with 25 % more."""
    return settings._replace(
        overflow_passes=2,
        overflow_capacity=max(512, ceil_to(
            (max_depth - settings.max_per_tile) * 5 // 4, 128)),
        overflow_compact=ceil_to(max(over_tiles + over_tiles // 4, 32), 8))


def camera(yaw: float, tx: float, ty: float, tz: float, width: int,
           height: int, device) -> CameraMatrices:
    """bench.py's make_cam: turned by yaw about y, at (tx, ty, tz)."""
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
    return build_camera_matrices(R, np.array([tx, ty, tz]), 0.01, 100.0,
                                 FOVX, FOVX * height / width, device=device)


def render_image(state: gm.GaussianState, cam: CameraMatrices,
                 s: RenderSettings, bg: torch.Tensor):
    """The map's render from `cam` through render_jit."""
    sc, qu, op = gm.activated(state.params)
    return render_jit(state.params.xyz, sc, qu, op, cam, s, bg,
                      shs=gm.sh_features(state.params), live_mask=state.live)


def scene_extent(pts: np.ndarray) -> float:
    """The densify extent: the scene's radius from the points (bench.py;
    the cameras sit in a ~1 m blob inside the 8 x 12 m room)."""
    return 1.1 * float(np.percentile(
        np.linalg.norm(pts - pts.mean(0), axis=1), 95))


def densify_due(i: int) -> bool:
    """Densify after iteration i: every 100 in (600, 15000]."""
    return DENSIFY_FROM < i <= DENSIFY_UNTIL and i % DENSIFY_EVERY == 0


class Protocol(NamedTuple):
    """bench.py's quality protocol, on the device."""

    views: list           # 24 training CameraMatrices
    gt_views: torch.Tensor    # [24, 3, H, W] (corrupted unless clean)
    test_cams: list       # 2 held-out CameraMatrices
    gt_tests: torch.Tensor    # [2, 3, H, W] clean exact renders
    settings: RenderSettings  # the training render (1 pass)
    exact: RenderSettings     # the scoring render (2-pass compact)
    mask: torch.Tensor
    bg: torch.Tensor
    lrs: optim.LearningRates
    extent: float


def gt_world(pts: np.ndarray, device) -> gm.GaussianState:
    """The ground-truth world: the points textured by the photo atlas
    (tools/data/grace_hopper.png over pink noise), opacity 0.85."""
    st = gm.create_from_pcd(pts, photo_colors(pts, photo_atlas()),
                            sh_degree=3, capacity=pts.shape[0],
                            device=device)
    opacity = torch.full_like(st.params.opacity_logit, float(
        inverse_sigmoid(torch.tensor(GT_OPACITY, dtype=torch.float32))))
    return st._replace(params=st.params._replace(opacity_logit=opacity))


def probe_exact(gt_state: gm.GaussianState, settings: RenderSettings,
                bg: torch.Tensor) -> RenderSettings:
    """The scoring render of the soak (and of tools/attr_quality.py):
    exact_settings sized from the 1-pass render of the GT world from the
    identity pose."""
    cam0 = camera(0.0, 0.0, 0.0, 0.0, settings.width, settings.height,
                  bg.device)
    probe = render_image(gt_state, cam0, settings, bg)
    return exact_settings(settings, int(probe.num_overflow_tiles),
                          int(probe.max_tile_depth))


def quality_protocol(pts: np.ndarray, width: int, height: int, device,
                     clean: bool = False,
                     exact: RenderSettings | None = None) -> Protocol:
    """The GT world's 24 training views rendered exact and corrupted by
    corrupt_frame (RandomState(7); left clean with `clean`), and its 2
    held-out views rendered exact. `exact` is the scoring render; None
    sizes it from a probe render of the GT world (the soak's way; bench.py
    sizes it from its 1-pass render of the bench state)."""
    settings = settings_for(width, height, MAX_PER_TILE32)
    bg = torch.zeros(3, device=device)
    gt_state = gt_world(pts, device)
    if exact is None:
        exact = probe_exact(gt_state, settings, bg)
    views = [camera(*v, width, height, device) for v in TRAIN_VIEWS]
    test_cams = [camera(*v, width, height, device) for v in TEST_VIEWS]
    crng = np.random.RandomState(CORRUPT_SEED)
    gt_views = []
    with torch.no_grad():
        for i, c in enumerate(views):
            img = render_image(gt_state, c, exact, bg).image
            if not clean:
                img = torch.from_numpy(corrupt_frame(
                    img.cpu().numpy(), i, crng)).to(device)
            gt_views.append(img)
        gt_tests = [render_image(gt_state, c, exact, bg).image
                    for c in test_cams]
    extent = scene_extent(pts)
    lrs = optim.LearningRates.create(*LRS)._replace(
        xyz=float(np.float32(POSITION_LR * max(extent, 1.0))))
    return Protocol(views=views, gt_views=torch.stack(gt_views),
                    test_cams=test_cams, gt_tests=torch.stack(gt_tests),
                    settings=settings, exact=exact,
                    mask=torch.ones((height, width), device=device), bg=bg,
                    lrs=lrs, extent=extent)


def fresh_points(pts: np.ndarray, rng: np.random.RandomState):
    """The fitted model's start: half the GT points (150,000 of 300,000),
    drawn from bench.py's stream, moved by 1 cm noise, in grey: (points,
    colours)."""
    n = pts.shape[0]
    sel = rng.choice(n, n // 2, replace=False)
    init = pts[sel] + rng.randn(n // 2, 3).astype(np.float32) * 0.01
    return init, np.full((n // 2, 3), 0.5, np.float32)


def fresh_model(pts: np.ndarray, rng: np.random.RandomState, capacity: int,
                device) -> gm.GaussianState:
    """fresh_points as an SH-3 map of `capacity` slots."""
    return gm.create_from_pcd(*fresh_points(pts, rng), sh_degree=3,
                              capacity=capacity, device=device)


def fit(proto: Protocol, state, opt, gen: torch.Generator, start: int,
        stop: int, on_iter=None, spans: dict | None = None):
    """Protocol iterations start + 1 .. stop: iteration i trains view
    (i - 1) % 24, then densifies where densify_due(i), its split samples
    drawn from `gen`. The steps run through one StepGraphs: train_chunk
    over each whole CHUNK of iterations between multiples of CHUNK, single
    train steps up to the next multiple where the range is not aligned (as
    JAX's soak, tools/quality_soak_30k.py:286-305). on_iter(i, state, opt,
    metrics) after each single step and after each chunk (i its last
    iteration, the metrics its last step's) may return True to stop there.
    spans["densify_s"] adds up the densify events' time (the card waited
    for on both sides). Returns (state, opt, the last iteration run)."""
    dev = proto.mask.device
    graphs = StepGraphs()
    cams = CameraMatrices(*(torch.stack(x) for x in zip(*proto.views)))

    def after(i, met) -> bool:
        nonlocal state, opt
        if densify_due(i):
            sync(dev)
            t0 = time.perf_counter()
            noise = torch.randn((2, state.capacity, 3), generator=gen,
                                device=dev)
            state, opt, _ = densify_step(state, opt, noise,
                                         max(proto.extent, 1.0), **DENSIFY)
            sync(dev)
            if spans is not None:
                spans["densify_s"] += time.perf_counter() - t0
        return on_iter is not None and bool(on_iter(i, state, opt, met))

    i = start
    while i < stop:
        n = min(CHUNK - i % CHUNK, stop - i)
        if n == CHUNK:
            state, opt, chunk = graphs.train_chunk(
                state, opt, cams, proto.gt_views, proto.mask, proto.lrs,
                proto.bg, LAMBDA_DSSIM, i, proto.settings, CHUNK)
            i += CHUNK
            if after(i, {k: v[-1] for k, v in chunk.items()}):
                break
            continue
        for _ in range(n):
            i += 1
            v = (i - 1) % len(proto.views)
            state, opt, met = graphs.train_step(
                state, opt, proto.views[v], proto.gt_views[v], proto.mask,
                proto.lrs, proto.bg, LAMBDA_DSSIM, proto.settings)
            if after(i, met):
                return state, opt, i
    return state, opt, i


def held_out(proto: Protocol, state, views=None) -> list[tuple[float, float]]:
    """(PSNR, SSIM) of the exact render against each held-out view (the
    first `views` of them)."""
    out = []
    with torch.no_grad():
        for c, gt in list(zip(proto.test_cams, proto.gt_tests))[:views]:
            img = render_image(state, c, proto.exact, proto.bg).image
            out.append((float(losses.psnr(img, gt)),
                        float(losses.ssim(img, gt))))
    return out


def check(cond, msg) -> None:
    if not cond:
        raise RuntimeError(msg)


def check_finite(what: str, x: torch.Tensor) -> None:
    check(bool(torch.isfinite(x).all()), f"{what} is not finite: {x}")


def parse_args(argv):
    ap = argparse.ArgumentParser(description="The port's benchmark: "
                                 "bench.py's measurements in one JSON line.")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "versions of the kernels)")
    ap.add_argument("--n", type=int, default=N_GAUSSIANS,
                    help="Gaussians of the room scene")
    ap.add_argument("--width", type=int, default=WIDTH)
    ap.add_argument("--height", type=int, default=HEIGHT)
    ap.add_argument("--quality-iters", type=int, default=PROTOCOL_ITERS,
                    help="iterations of the quality fit")
    ap.add_argument("--deadline", type=float, default=DEADLINE_S,
                    help="seconds from the start after which the quality "
                         "fit stops early")
    ap.add_argument("--clean", action="store_true",
                    help="train the quality fit on clean renders (the "
                         "sensor model off)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu to run the plain versions)")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return args, device


def main(argv=None) -> tuple[dict, gm.GaussianState]:
    """Run the benchmark; print its one JSON line and return it with the
    quality fit's state."""
    t_start = time.time()
    args, dev = parse_args(argv)
    n, width, height = args.n, args.width, args.height
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    card = card_name_power() if dev.type == "cuda" else None
    reps = REPS[dev.type]
    rng = np.random.RandomState(0)
    pts, cols = room_scene(n, rng=rng)
    state = gm.create_from_pcd(pts, cols, sh_degree=3, capacity=n,
                               device=dev)
    cam = camera(0.0, 0.0, 0.0, 0.0, width, height, dev)
    bg = torch.zeros(3, device=dev)
    settings = settings_for(width, height, MAX_PER_TILE32)
    log(f"[bench] N={n} {width}x{height} on {dev} ({card})")

    def forward(s):
        with torch.no_grad():
            return render_image(state, cam, s, bg)

    first = forward(settings)
    clipped, overflow = int(first.num_clipped), int(first.num_overflow)
    over_tiles, max_depth = (int(first.num_overflow_tiles),
                             int(first.max_tile_depth))
    frame_ms = timed_ms(lambda: forward(settings), reps.fps, dev)
    fps = 1e3 / frame_ms
    log(f"[bench] 1-pass {fps:.2f} FPS ({frame_ms:.2f} ms), clipped "
        f"{clipped} overflow {overflow} over_tiles {over_tiles} max_depth "
        f"{max_depth}")
    tag = f"{width}x{height}_{n // 1000}k"
    result = {"metric": f"render_fps_{tag}", "value": round(fps, 2),
              "unit": "fps", "vs_baseline": round(fps / BASELINE_FPS, 3)}
    extra = {"fps_1pass": round(fps, 2), "binning_clipped": clipped,
             "binning_overflow": overflow}

    exact_s = exact_settings(settings, over_tiles, max_depth)
    if overflow > 0:
        img = first.image
        exact_img = forward(settings_for(width, height,
                                         EXACT_PER_TILE)).image
        psnr_exact = float(losses.psnr(img, exact_img))
        two = forward(exact_s)
        fps_2 = 1e3 / timed_ms(lambda: forward(exact_s), reps.fps, dev)
        psnr_2 = float(losses.psnr(two.image, exact_img))
        log(f"[bench] 1-pass PSNR vs exact {psnr_exact:.2f} dB; 2-pass "
            f"(compact {exact_s.overflow_compact}, capacity "
            f"{exact_s.overflow_capacity}) {fps_2:.2f} FPS, residual "
            f"overflow {int(two.num_overflow)}, PSNR vs exact "
            f"{psnr_2:.2f} dB")
        extra.update({
            "psnr_vs_exact_db": round(psnr_exact, 2),
            "fps_2pass_overflow": round(fps_2, 2),
            "psnr_2pass_vs_exact_db": round(psnr_2, 2),
            "overflow_tiles": over_tiles, "max_tile_depth": max_depth,
            "cont_compact": exact_s.overflow_compact,
            "cont_capacity": exact_s.overflow_capacity})
        if psnr_2 >= 45.0:
            result.update({"metric": f"render_fps_{tag}_exact",
                           "value": round(fps_2, 2),
                           "vs_baseline": round(fps_2 / BASELINE_FPS, 3)})

    # Train throughput: the full step on the seeded random ground truth.
    opt = optim.init_adam(state.params)
    lrs = optim.LearningRates.create(*LRS)
    gt = torch.from_numpy(rng.rand(3, height, width).astype(np.float32)
                          ).to(dev)
    mask = torch.ones((height, width), device=dev)

    graphs = StepGraphs()

    def step(st, op):
        return graphs.train_step(st, op, cam, gt, mask, lrs, bg,
                                 LAMBDA_DSSIM, settings)

    def steps_per_s(fn, st, op):
        for _ in range(1 + reps.warmup):
            st, op, met = fn(st, op)
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(reps.train):
            st, op, met = fn(st, op)
        sync(dev)
        return reps.train / (time.perf_counter() - t0), st, op, met

    tps, state, opt, met = steps_per_s(step, state, opt)
    check_finite("train loss", met["loss"])
    log(f"[bench] train_step {tps:.2f} it/s ({1e3 / tps:.2f} ms)")
    extra["train_iters_per_sec"] = round(tps, 2)

    cams_b = CameraMatrices(*(torch.stack([x] * BATCH) for x in cam))
    gts_b, masks_b = torch.stack([gt] * BATCH), torch.stack([mask] * BATCH)
    graphs_b = StepGraphs()   # its own map: a copy of the step's
    bps, _, _, bmet = steps_per_s(
        lambda st, op: graphs_b.train_step_batched(
            st, op, cams_b, gts_b, masks_b, lrs, bg, LAMBDA_DSSIM, settings),
        gm.clone_state(state), optim.AdamState(
            m=gm.GaussianParams(*(x.clone() for x in opt.m)),
            v=gm.GaussianParams(*(x.clone() for x in opt.v)),
            step=opt.step.clone()))
    check_finite("batched loss", bmet["loss"])
    log(f"[bench] train_step_batched B={BATCH}: {BATCH * bps:.2f} views/s "
        f"({1e3 / bps:.2f} ms a step)")
    extra["train_views_per_sec_b4"] = round(BATCH * bps, 2)

    del graphs_b
    extra["stage_ms"] = stage_ms(state, cam, gt, settings, bg, lrs,
                                 reps.stage, dev)
    log(f"[bench] stage_ms {extra['stage_ms']}")

    # The quality fit.
    t0 = time.time()
    proto = quality_protocol(pts, width, height, dev, clean=args.clean,
                             exact=exact_s)
    model = fresh_model(pts, rng, n, dev)
    log(f"[bench] quality protocol set up in {time.time() - t0:.1f} s "
        f"(clean={args.clean})")
    gen = torch.Generator(device=dev).manual_seed(0)

    def on_iter(i, st, op, met):
        if i % DEADLINE_CHECK_EVERY:
            return False
        check_finite(f"quality loss at {i}", met["loss"])
        if i % TELEMETRY_EVERY == 0:
            log(f"[bench] quality iter {i}: loss {float(met['loss']):.4f} "
                f"held-out {held_out(proto, st, 1)[0][0]:.2f} dB live "
                f"{int(gm.num_live(st))} ({time.time() - t0:.0f} s)")
        left = args.deadline - (time.time() - t_start)
        if left < SCORE_RESERVE_S:
            log(f"[bench] deadline: {left:.0f} s left, the fit stops at "
                f"iteration {i}")
            return True
        return False

    t0 = time.time()
    model, model_opt, iters = fit(proto, model, optim.init_adam(
        model.params), gen, 0, args.quality_iters, on_iter)
    scores = held_out(proto, model)
    psnr = float(np.mean([p for p, _ in scores]))
    ssim = float(np.mean([s for _, s in scores]))
    check(np.isfinite(psnr) and np.isfinite(ssim), f"quality {scores}")
    live = int(gm.num_live(model))
    log(f"[bench] quality: {iters} iterations in {time.time() - t0:.1f} s, "
        f"held-out PSNR {psnr:.2f} dB SSIM {ssim:.4f}, live {live}")
    extra.update({
        "mapping_psnr_db": round(psnr, 2), "mapping_ssim": round(ssim, 4),
        "quality_iters": iters, "quality_resumed_from_iter": 0,
        "quality_protocol_iters": PROTOCOL_ITERS,
        "quality_gaussians": live, "quality_clean_train": args.clean,
        "wall_s": round(time.time() - t_start, 1), "device": str(dev),
        "card": card})
    result["extra"] = extra
    print(json.dumps(result), flush=True)
    return result, model


def stage_ms(state, cam, gt, settings, bg, lrs, stage_reps: int,
             dev) -> dict:
    """bench.py's stage breakdown of the train step, each stage dispatched
    op by op: fwd (the render's frame time), bwd (loss forward and
    backward less fwd), binning (its share of fwd) and Adam, in ms."""
    w, h = settings.width, settings.height
    live = state.live

    def frame():
        with torch.no_grad():
            sc, qu, op = gm.activated(state.params)
            return render(state.params.xyz, sc, qu, op, cam, settings, bg,
                          shs=gm.sh_features(state.params), live_mask=live)

    def loss_grads():
        params = gm.GaussianParams(*(p.detach().requires_grad_(True)
                                     for p in state.params))
        sc, qu, op = gm.activated(params)
        res = render(params.xyz, sc, qu, op, cam, settings, bg,
                     shs=gm.sh_features(params), live_mask=live)
        loss = losses.training_loss(res.image, gt, LAMBDA_DSSIM)
        return torch.autograd.grad(loss, list(params), allow_unused=True)

    with torch.no_grad():
        sc, qu, op = gm.activated(state.params)
        prep = preprocess(state.params.xyz, sc, qu, cam.viewmatrix,
                          cam.full_proj, cam.cam_center, w, h,
                          settings.tan_fovx, settings.tan_fovy, sh_degree=3,
                          shs=gm.sh_features(state.params), live_mask=live)
        ext = tight_extents(prep.conics, op, prep.radii)
    grads = gm.GaussianParams(*(torch.zeros_like(p) if g is None else g
                                for g, p in zip(loss_grads(),
                                                state.params)))
    adam_state = gm.clone_state(state)
    adam_opt = optim.init_adam(adam_state.params)
    ms_bin = timed_ms(lambda: bin_gaussians(
        prep.means2d, prep.depths, prep.radii, prep.visible, w, h, tile=32,
        max_tiles_per_gaussian=settings.max_tiles_per_gaussian,
        max_per_tile=settings.max_per_tile, extents=ext), stage_reps, dev)
    frame_ms = timed_ms(frame, stage_reps, dev)
    ms_grad = timed_ms(loss_grads, stage_reps, dev)
    with torch.no_grad():
        ms_adam = timed_ms(lambda: optim.adam_step(
            adam_state.params, grads, adam_opt, lrs, adam_state.live),
            stage_reps, dev)
    return {"fwd": round(frame_ms, 2),
            "bwd": round(max(ms_grad - frame_ms, 0.0), 2),
            "binning": round(ms_bin, 2), "adam": round(ms_adam, 2)}


if __name__ == "__main__":
    main()
