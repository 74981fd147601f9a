"""The port's bench and 30k soak (photo_slam_tpu_torch/tools/bench.py,
quality_soak_30k.py) against bench.py on the CPU: the quality protocol's
pieces equal bench.py's on the same seeds, 3 iterations of the port's fit
track JAX's train_step loop, the CLI prints one JSON line, and the soak's
checkpoint round-trips."""
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photo_slam_tpu.config import Config as JConfig
from photo_slam_tpu.mapper import trainer as jtrainer
from photo_slam_tpu.models import gaussian_model as jgm
from photo_slam_tpu.models import optimizer as joptim
from photo_slam_tpu.models.scene import Scene as JScene
from photo_slam_tpu.ops.camera_math import build_camera_matrices as jcam
from photo_slam_tpu.ops.render import RenderSettings as JSettings
from photo_slam_tpu_torch.config import Config
from photo_slam_tpu_torch.mapper.trainer import GaussianTrainer
from photo_slam_tpu_torch.models import gaussian_model as tgm
from photo_slam_tpu_torch.models import optimizer as toptim
from photo_slam_tpu_torch.models.scene import Scene
from photo_slam_tpu_torch.tools import bench as tbench
from photo_slam_tpu_torch.tools import quality_soak_30k as tsoak
from photo_slam_tpu_torch.tools import synth_replica
from photo_slam_tpu_torch.tools.bench_room import room_scene
from test_torch_blend import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
FIELDS = tgm.GaussianParams._fields


@pytest.fixture(scope="module")
def jbench():
    """bench.py, imported with the test process's signal handlers put back
    (it installs its own at import; tests/test_bench_quality.py:14-23)."""
    old_term = signal.getsignal(signal.SIGTERM)
    old_int = signal.getsignal(signal.SIGINT)
    import bench
    signal.signal(signal.SIGTERM, old_term)
    signal.signal(signal.SIGINT, old_int)
    return bench


@pytest.fixture(scope="module")
def world(jbench):
    """bench.py's room (300,000 points) from both streams, and the streams
    after it."""
    jrng, trng = np.random.RandomState(0), np.random.RandomState(0)
    return jbench.room_scene(300_000, jrng), room_scene(300_000, rng=trng), \
        jrng, trng


def test_world_and_streams_equal_bench(world):
    (jpts, jcols), (tpts, tcols), jrng, trng = world
    np.testing.assert_array_equal(tpts, jpts)
    np.testing.assert_array_equal(tcols, jcols)
    # Both streams go on alike: bench's train-step ground truth, then the
    # fresh model's draws (bench.py:548-553).
    np.testing.assert_array_equal(trng.rand(3, 8, 8), jrng.rand(3, 8, 8))
    sel = jrng.choice(300_000, 150_000, replace=False)
    want = jpts[sel] + jrng.randn(150_000, 3).astype(np.float32) * 0.01
    got, cols = tbench.fresh_points(tpts, trng)
    np.testing.assert_array_equal(got, want)
    assert (cols == 0.5).all() and cols.shape == (150_000, 3)


def test_colors_and_sensor_model_equal_bench(jbench, world):
    (jpts, _), _, _, _ = world
    np.testing.assert_array_equal(
        synth_replica.photo_colors(jpts, synth_replica.photo_atlas()),
        jbench.photo_colors(jpts, jbench.photo_atlas()))
    img = np.random.RandomState(3).rand(3, 40, 60).astype(np.float32)
    for i in (0, 1, 3, 10):
        np.testing.assert_array_equal(
            synth_replica.corrupt_frame(img, i, np.random.RandomState(7)),
            jbench.corrupt_frame(img, i, np.random.RandomState(7)))


def test_cameras_extent_lr_and_schedule_equal_bench(world):
    """The 24 + 2 cameras of bench.py:455-470 (make_cam over view_params
    and the two test views), the densify extent and position LR
    (bench.py:557-574) and the densify schedule (bench.py:590-591)."""
    (pts, _), _, _, _ = world
    fovx, w, h = 1.2, 1200, 680

    def make_cam(yaw, tx, ty, tz):
        cy, sy = np.cos(yaw), np.sin(yaw)
        R = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        return jcam(R, np.array([tx, ty, tz]), 0.01, 100.0, fovx,
                    fovx * h / w)

    view_params = [(0.09 * (i - 11), 0.22 * (i % 5 - 2), 0.1 * (i % 3 - 1),
                    0.35 * (i % 4)) for i in range(24)]
    tests = [(0.05, -0.15, 0.06, 0.2), (-0.35, 0.3, -0.05, 0.7)]
    assert list(tbench.TRAIN_VIEWS) == view_params
    assert list(tbench.TEST_VIEWS) == tests
    for vp in view_params + tests:
        want = make_cam(*vp)
        got = tbench.camera(*vp, w, h, "cpu")
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    extent = 1.1 * float(np.percentile(
        np.linalg.norm(pts - pts.mean(0), axis=1), 95))
    assert tbench.scene_extent(pts) == extent
    assert float(np.float32(tbench.POSITION_LR * max(extent, 1.0))) == float(
        jnp.float32(3.2e-4 * max(extent, 1.0)))
    for i in range(30_001):
        assert tbench.densify_due(i) == (600 < i <= 15000 and i % 100 == 0)
    assert tbench.DENSIFY == dict(grad_threshold=1e-3, min_opacity=0.02,
                                  max_screen_size=0, percent_dense=0.01)
    assert tbench.GT_OPACITY == 0.85 and tbench.CORRUPT_SEED == 7


def small_map(n=60, cap=64, seed=5):
    rng = np.random.RandomState(seed)
    pts = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.2, 1.2, n),
                    rng.uniform(4.0, 7.0, n)], 1).astype(np.float32)
    state = tgm.create_from_pcd(pts, rng.rand(n, 3), sh_degree=3,
                                capacity=cap, device="cpu")
    arrays = {k: getattr(state.params, k).numpy() for k in FIELDS}
    arrays["log_scales"] += rng.uniform(-0.4, 0.4, (cap, 3)).astype(
        np.float32)
    arrays["quats"] = rng.randn(cap, 4).astype(np.float32)
    return arrays, state.live.numpy()


def test_fit_tracks_jax_train_step_loop():
    """3 iterations of the port's fit (views (i - 1) % 3 of bench's first
    cameras at 64x48) against JAX's train_step loop in its CPU "tiled" mode
    at 32 px tiles: each loss within 1e-4 relative, each group's update
    within 6e-3 of its largest (the trainer tests' tolerances)."""
    w, h = 64, 48
    arrays, live = small_map()
    cap = live.shape[0]
    gts = np.random.RandomState(2).rand(3, 3, h, w).astype(np.float32)
    vps = tbench.TRAIN_VIEWS[:3]
    settings = tbench.settings_for(w, h, 1024)
    lr_xyz = float(np.float32(tbench.POSITION_LR * 7.5))
    proto = tbench.Protocol(
        views=[tbench.camera(*vp, w, h, "cpu") for vp in vps],
        gt_views=torch.from_numpy(gts), test_cams=[], gt_tests=None,
        settings=settings, exact=settings, mask=torch.ones((h, w)),
        bg=torch.zeros(3),
        lrs=toptim.LearningRates.create(*tbench.LRS)._replace(xyz=lr_xyz),
        extent=7.5)
    state = tgm.state_from_numpy(arrays, live, device="cpu")
    losses = []

    def on_iter(i, st, op, met):
        losses.append(float(met["loss"]))

    state, opt, last = tbench.fit(proto, state, toptim.init_adam(
        state.params), torch.Generator().manual_seed(0), 0, 3, on_iter)
    assert last == 3 and int(opt.step) == 3

    j_state = jgm.GaussianState(
        params=jgm.GaussianParams(**{k: jnp.asarray(v)
                                     for k, v in arrays.items()}),
        live=jnp.asarray(live), max_radii2d=jnp.zeros(cap),
        xyz_grad_accum=jnp.zeros(cap), denom=jnp.zeros(cap),
        exist_since_iter=jnp.zeros(cap, jnp.int32))
    j_opt = joptim.init_adam(j_state.params)
    j_lrs = joptim.LearningRates.create(*tbench.LRS)._replace(
        xyz=jnp.float32(lr_xyz))
    js = JSettings(width=w, height=h, tan_fovx=settings.tan_fovx,
                   tan_fovy=settings.tan_fovy, sh_degree=3, tile=32,
                   max_tiles_per_gaussian=16, max_per_tile=1024,
                   tiles_per_chunk=2, mode="tiled")
    for i in range(1, 4):
        yaw, tx, ty, tz = vps[(i - 1) % 3]
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        j_state, j_opt, jm = jtrainer.train_step(
            j_state, j_opt, jcam(R, np.array([tx, ty, tz]), 0.01, 100.0,
                                 1.2, 1.2 * h / w),
            jnp.asarray(gts[(i - 1) % 3]), jnp.ones((h, w)), j_lrs,
            jnp.zeros(3), jnp.float32(tbench.LAMBDA_DSSIM), js)
        assert losses[i - 1] == pytest.approx(float(jm["loss"]), rel=1e-4)
    for k in FIELDS:
        a = getattr(state.params, k).numpy() - arrays[k]
        b = np.asarray(getattr(j_state.params, k)) - arrays[k]
        scale = np.abs(b).max()
        assert scale > 0, k
        np.testing.assert_allclose(a, b, atol=6e-3 * scale,
                                   err_msg=f"update of {k}")


def test_cli_prints_one_json_line():
    """python -m photo_slam_tpu_torch.tools.bench --device cpu at 2,000
    Gaussians and 64x48: exactly one line on stdout, bench.py's layout,
    finite numbers."""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "photo_slam_tpu_torch.tools.bench",
         "--device", "cpu", "--n", "2000", "--width", "64", "--height",
         "48", "--quality-iters", "3"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=600, check=True)
    lines = proc.stdout.splitlines()
    assert len(lines) == 1, proc.stdout
    out = json.loads(lines[0])
    assert set(out) == {"metric", "value", "unit", "vs_baseline", "extra"}
    assert out["metric"] == "render_fps_64x48_2k" and out["unit"] == "fps"
    extra = out["extra"]
    for k in ("fps_1pass", "binning_clipped", "binning_overflow",
              "train_iters_per_sec", "train_views_per_sec_b4", "stage_ms",
              "mapping_psnr_db", "mapping_ssim", "quality_iters",
              "quality_resumed_from_iter", "quality_protocol_iters",
              "quality_gaussians", "wall_s"):
        assert k in extra, k
    assert set(extra["stage_ms"]) == {"fwd", "bwd", "binning", "adam"}
    assert extra["quality_iters"] == 3 and extra["device"] == "cpu"
    assert extra["card"] is None
    numbers = [v for v in extra.values() if isinstance(v, (int, float))]
    numbers += list(extra["stage_ms"].values()) + [out["value"]]
    assert all(np.isfinite(numbers))


def test_soak_checkpoint_round_trips(tmp_path):
    """save_ckpt / load_ckpt give back the map, the Adam state, the
    iteration and the densify generator; both packages' GaussianTrainer
    load the checkpoint."""
    arrays, live = small_map()
    state = tgm.state_from_numpy(arrays, live, device="cpu")
    opt = toptim.init_adam(state.params)
    opt = opt._replace(m=tgm.GaussianParams(*(x + 0.5 for x in opt.m)),
                       step=torch.tensor(1200, dtype=torch.int32))
    gen = torch.Generator().manual_seed(3)
    torch.randn(5, generator=gen)
    path = tmp_path / "ckpt_001200.npz"
    tsoak.save_ckpt(path, state, opt, 1200, gen, 7.5)
    st2, opt2, it, gen2 = tsoak.load_ckpt(path, "cpu")
    assert it == 1200 and int(opt2.step) == 1200
    for a, b in ((state.params, st2.params), (opt.m, opt2.m),
                 (opt.v, opt2.v)):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert torch.equal(torch.randn(4, generator=gen),
                       torch.randn(4, generator=gen2))

    port = GaussianTrainer(Config(), Scene(), device="cpu")
    port.load_checkpoint(path)
    jt = jtrainer.GaussianTrainer(JConfig(), JScene())
    jt.load_checkpoint(path)
    for tr in (port, jt):
        assert (tr.iteration, tr.default_sh) == (1200, 3)
        assert tr.spatial_lr_scale == 7.5
        assert tr.position_lr_init_live == pytest.approx(
            tbench.POSITION_LR)
    np.testing.assert_array_equal(np.asarray(jt.state.params.xyz),
                                  arrays["xyz"])
