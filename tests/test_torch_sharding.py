"""The port's multi-process half of parallel/sharding.py on gloo, on the
CPU: the launcher (parallel/launch.py), the tile-band render and the
view-parallel step at 2 and 4 ranks against the port's single-process
path, and at 4 ranks against the JAX package's make_mesh(4) runs (its 8
virtual CPU devices, tests/conftest.py); the dry run of
__graft_entry__.py at 2 and 4 ranks (JAX runs it on 8 virtual devices; 8
spawned processes, each importing torch, would cost the suite more time
than they add).

Tolerances: N ranks against 1 within atol 1e-6, rtol 1e-5 (the view sums
are taken in another order: tests/test_sharding.py:149-152); the band
render within 2e-5 of the single render with caps that do not bind
(tests/test_sharding.py:198); against JAX's "tiled" f32 mode, the image
within 1e-4 (tests/test_torch_render.py's bound) and each parameter
group's update within 6e-3 of its largest
(tests/test_torch_batched_training.py)."""
import math
import operator
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photo_slam_tpu.models import gaussian_model as jgm
from photo_slam_tpu.models import optimizer as joptim
from photo_slam_tpu.ops.camera_math import CameraMatrices as JCams
from photo_slam_tpu.ops.camera_math import build_camera_matrices as jcam
from photo_slam_tpu.ops.render import RenderSettings as JSettings
from photo_slam_tpu.parallel import sharding as jsharding
from photo_slam_tpu_torch.models import optimizer as toptim
from photo_slam_tpu_torch.ops.render import RenderSettings, render
from photo_slam_tpu_torch.parallel import dryrun, launch
from photo_slam_tpu_torch.parallel import sharding as tsharding
from test_torch_batched_training import (LAMBDA, LRS, SETTINGS, initial_map,
                                         port_state, port_views)
from test_torch_blend import one_torch_thread  # noqa: F401
from test_torch_trainer import FIELDS, H, W, gt_model, render_gt

RANKS = (2, 4)
TIMEOUT = 240


def spawn(fn, n, *args):
    """A rank program of parallel/dryrun.py over n gloo ranks on the CPU
    (its last argument is the device)."""
    return launch.spawn_local(fn, n, backend="gloo", device="cpu",
                              args=(*args, "cpu"), timeout=TIMEOUT)


# ---- The launcher ----------------------------------------------------------


def test_spawn_local_returns_every_rank_in_order():
    assert launch.spawn_local(operator.add, 3, backend="gloo", device="cpu",
                              timeout=TIMEOUT) == [3, 4, 5]


def test_failing_rank_raises_in_the_parent_with_its_traceback():
    """math.log(rank, world) fails on rank 0 only (log of 0)."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 0 of 2 failed") as e:
        launch.spawn_local(math.log, 2, backend="gloo", device="cpu",
                           timeout=TIMEOUT)
    assert "Traceback" in str(e.value) and "ValueError" in str(e.value)
    assert time.monotonic() - t0 < TIMEOUT


def test_timeout_raises_and_stops_the_ranks():
    """A timeout shorter than a child's start: the parent raises
    TimeoutError and every child has exited."""
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not finish"):
        launch.spawn_local(operator.add, 2, backend="gloo", device="cpu",
                           timeout=0.05)
    assert time.monotonic() - t0 < 30


def test_nccl_needs_a_card_per_rank():
    with pytest.raises(ValueError, match="a card per rank"):
        launch.spawn_local(operator.add, 2, backend="nccl", device="cuda:0")


def test_band_rows():
    """Whole tile rows, split over the ranks and rounded up: 680 rows are
    22 tile rows, 11 a band for 2 ranks (352 px), 6 for 4."""
    assert tsharding.band_rows(680, 1) == 704
    assert tsharding.band_rows(680, 2) == 352
    assert tsharding.band_rows(680, 4) == 192
    assert tsharding.band_rows(48, 4) == 32


@pytest.mark.parametrize("n", RANKS)
def test_dryrun_multichip(n, capsys):
    """__graft_entry__.py::dryrun_multichip's sequence over n gloo ranks;
    no rank imports JAX or the JAX package, and every rank ends with the
    same numbers."""
    out = dryrun.dryrun_multichip(n, device="cpu", timeout=TIMEOUT)
    assert "[dryrun_multichip] n_ranks=%d ok" % n in capsys.readouterr().out
    assert not any(r["jax_imported"] for r in out)
    assert all(r == out[0] for r in out)
    assert out[0]["gp_rows_per_rank"] == 256 // n
    assert out[0]["gp_loss"] == pytest.approx(out[0]["ref_loss"], rel=1e-5)


def test_dryrun_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    """The dry run's CLI places its ranks on the card by default: a card
    per rank over NCCL where there are enough cards, else gloo on cuda:0;
    without a card it raises unless the caller passes the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        dryrun.main(["--ranks", "2"])
    assert dryrun.placement(2, "cpu") == ("cpu", "gloo")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert dryrun.placement(2) == ("cuda:0", "gloo")
    assert dryrun.placement(1) == ("cuda:{rank}", "nccl")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert dryrun.placement(4) == ("cuda:{rank}", "nccl")
    assert dryrun.placement(4, backend="gloo") == ("cuda:{rank}", "gloo")


# ---- The tile-band render --------------------------------------------------

RW, RH = 64, 96   # 2 x 3 tiles: 2 ranks take 2 tile rows each, 4 ranks 1


@pytest.fixture(scope="module")
def render_case():
    """tests/test_sharding.py::TestImageShardedRender's scene, smaller, with
    caps that do not bind."""
    rng = np.random.RandomState(0)
    n = 200
    case = dict(
        means=np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n),
                        rng.uniform(3, 9, n)], 1).astype(np.float32),
        scales=rng.uniform(0.05, 0.2, (n, 3)).astype(np.float32))
    quats = rng.randn(n, 4).astype(np.float32)
    case["quats"] = quats / np.linalg.norm(quats, axis=1, keepdims=True)
    case["opacities"] = rng.uniform(0.3, 0.95, n).astype(np.float32)
    case["colors"] = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    cam = jcam(np.eye(3), np.zeros(3), 0.01, 100.0, 1.0, 0.8)
    case["cam"] = tuple(np.asarray(x) for x in cam)
    case["bg"] = np.array([0.1, 0.2, 0.3], np.float32)
    case["settings"] = RenderSettings(
        width=RW, height=RH, tan_fovx=0.546, tan_fovy=0.422, tile=32,
        max_per_tile=512, max_tiles_per_gaussian=64, tiles_per_chunk=2)
    return case


def single_render(case):
    c = {k: torch.from_numpy(np.asarray(v)) for k, v in case.items()
         if k not in ("cam", "settings")}
    cam = tsharding.CameraMatrices(*(torch.from_numpy(np.array(x))
                                     for x in case["cam"]))
    res = render(c["means"], c["scales"], c["quats"], c["opacities"], cam,
                 case["settings"], c["bg"], colors_precomp=c["colors"])
    assert int(res.num_clipped) == 0 and int(res.num_overflow) == 0
    return res.image.numpy()


@pytest.mark.parametrize("n", RANKS)
def test_band_keys_error_on_the_dry_run_scene(n):
    """sharded_room.band_keys_error (every band keyed for its own tiles, as
    JAX keys its bands, rendered in one process) on the dry run's scene at
    caps that do not bind: within the band render's bound of the single
    render, since at 256 Gaussians no depths that tie in the frame's code
    split in a band's."""
    from photo_slam_tpu_torch.models import gaussian_model as tgm
    from photo_slam_tpu_torch.tools import sharded_room as sr

    state, cam, w, h, tanf = dryrun.make_scene(n=256, width=64, height=96,
                                               device="cpu")
    s = RenderSettings(width=w, height=h, tan_fovx=tanf,
                       tan_fovy=tanf * h / w, sh_degree=3, max_per_tile=256,
                       max_tiles_per_gaussian=6)
    sc, qu, op = tgm.activated(state.params)
    shs = tgm.sh_features(state.params)
    bg = torch.tensor([0.1, 0.2, 0.3])
    ref = render(state.params.xyz, sc, qu, op, cam, s, bg, shs=shs,
                 live_mask=state.live)
    assert int(ref.num_clipped) == 0 and int(ref.num_overflow) == 0
    assert sr.band_keys_error(state.params.xyz, sc, qu, op, cam, s, bg, shs,
                              state.live, n, ref.image) <= 2e-5


@pytest.fixture(scope="module")
def band_images(render_case):
    return {n: spawn(dryrun.band_render_rank, n, render_case)
            for n in RANKS}


@pytest.mark.parametrize("n", RANKS)
def test_band_render_matches_the_single_render(render_case, band_images, n):
    ref = single_render(render_case)
    for img in band_images[n]:
        assert img.shape == (3, RH, RW)
        np.testing.assert_allclose(img, ref, atol=2e-5, rtol=0)
    # Every rank holds the same gathered image.
    for img in band_images[n][1:]:
        np.testing.assert_array_equal(img, band_images[n][0])


def test_band_render_matches_jax_make_mesh_4(render_case, band_images):
    c = render_case
    mesh = jsharding.make_mesh(4)
    want = jsharding.render_image_sharded(
        mesh, *(jnp.asarray(c[k]) for k in ("means", "scales", "quats",
                                            "opacities")),
        JCams(*(jnp.asarray(x) for x in c["cam"])),
        JSettings(mode="tiled", **{k: v for k, v in
                                   c["settings"]._asdict().items()
                                   if k in JSettings._fields
                                   and k != "mode"}),
        jnp.asarray(c["bg"]), colors_precomp=jnp.asarray(c["colors"]))
    np.testing.assert_allclose(band_images[4][0], np.asarray(want),
                               atol=1e-4, rtol=0)


# ---- The view-parallel step ------------------------------------------------

VIEWS8 = tuple((0.1 * i - 0.35, 0.03 * (i % 3), 0.02 * (i % 2))
               for i in range(8))
STEPS = 2


@pytest.fixture(scope="module")
def view_case():
    model = gt_model(n=40, seed=5)
    arrays, live = initial_map(model)
    gts = np.stack([render_gt(model, np.array(t)) for t in VIEWS8])
    cams = port_views(VIEWS8)
    return dict(params=arrays, live=live, gts=gts,
                masks=np.ones((len(VIEWS8), H, W), np.float32),
                cams=tuple(x.numpy() for x in cams), lrs=(
                    toptim.LearningRates.create(*LRS)),
                bg=np.zeros(3, np.float32), **{"lambda": LAMBDA},
                settings=RenderSettings(mode="pallas", **SETTINGS),
                steps=STEPS)


def batch(case, b):
    return {**case, "gts": case["gts"][:b], "masks": case["masks"][:b],
            "cams": tuple(x[:b] for x in case["cams"])}


@pytest.fixture(scope="module")
def view_runs(view_case):
    """{n: every rank's result} with B = 2n views."""
    return {n: spawn(dryrun.view_step_rank, n, batch(view_case, 2 * n))
            for n in RANKS}


def single_process_steps(case):
    state, opt = port_state(case["params"], case["live"])
    cams = tsharding.CameraMatrices(*(torch.from_numpy(x)
                                      for x in case["cams"]))
    losses = []
    for _ in range(case["steps"]):
        state, opt, m = tsharding.train_step_batched(
            state, opt, cams, torch.from_numpy(case["gts"]),
            torch.from_numpy(case["masks"]), case["lrs"], torch.zeros(3),
            case["lambda"], case["settings"])
        losses.append(float(m["loss"]))
    return state, opt, losses


@pytest.mark.parametrize("n", RANKS)
def test_view_parallel_step_matches_one_process(view_case, view_runs, n):
    """2 ranks with 4 views and 4 ranks with 8 against train_step_batched
    without a group on the same batch: loss, parameters, densification
    statistics and Adam moments, on every rank."""
    case = batch(view_case, 2 * n)
    state, opt, losses = single_process_steps(case)
    for r, out in enumerate(view_runs[n]):
        for step, m in enumerate(out["metrics"]):
            assert float(m["loss"]) == pytest.approx(losses[step], rel=1e-6)
        assert int(out["step"]) == STEPS
        for name, got, want in [
                *((f"params.{k}", out["params"][k],
                   getattr(state.params, k)) for k in FIELDS),
                *((f"m.{k}", out["m"][k], getattr(opt.m, k))
                  for k in FIELDS),
                *((f"v.{k}", out["v"][k], getattr(opt.v, k))
                  for k in FIELDS),
                ("xyz_grad_accum", out["xyz_grad_accum"],
                 state.xyz_grad_accum),
                ("denom", out["denom"], state.denom),
                ("max_radii2d", out["max_radii2d"], state.max_radii2d)]:
            np.testing.assert_allclose(
                got, want.numpy(), atol=1e-6, rtol=1e-5,
                err_msg=f"rank {r} of {n}: {name}")


def test_view_parallel_step_matches_jax_make_mesh_4(view_case, view_runs):
    """4 ranks with 8 views against JAX's train_step_batched over
    make_mesh(4) in "tiled" mode."""
    case = view_case
    arrays, live = case["params"], case["live"]
    cap = len(live)
    mesh = jsharding.make_mesh(4)
    j_state = jgm.GaussianState(
        params=jgm.GaussianParams(**{k: jnp.asarray(v)
                                     for k, v in arrays.items()}),
        live=jnp.asarray(live), max_radii2d=jnp.zeros(cap),
        xyz_grad_accum=jnp.zeros(cap), denom=jnp.zeros(cap),
        exist_since_iter=jnp.zeros(cap, jnp.int32))
    j_state = jsharding.replicate(mesh, j_state)
    j_opt = jsharding.replicate(mesh, joptim.init_adam(j_state.params))
    cams, gts, masks = jsharding.shard_batch_args(
        mesh, JCams(*(jnp.asarray(x) for x in case["cams"])),
        jnp.asarray(case["gts"]), jnp.asarray(case["masks"]))
    settings = JSettings(mode="tiled", **SETTINGS)
    got = view_runs[4][0]
    for step in range(STEPS):
        j_state, j_opt, jm = jsharding.train_step_batched(
            j_state, j_opt, cams, gts, masks,
            joptim.LearningRates.create(*LRS), jnp.zeros(3),
            jnp.float32(LAMBDA), settings, mesh=mesh)
        assert float(got["metrics"][step]["loss"]) == pytest.approx(
            float(jm["loss"]), rel=1e-4)
        assert int(got["metrics"][step]["num_visible"]) == int(
            jm["num_visible"])
    for k in FIELDS:
        if arrays[k].size == 0:   # features_rest at SH degree 0
            continue
        upd = got["params"][k] - arrays[k]
        want = np.asarray(getattr(j_state.params, k)) - arrays[k]
        scale = np.abs(want).max()
        assert scale > 0, k
        np.testing.assert_allclose(upd, want, atol=6e-3 * scale,
                                   err_msg=f"update of {k}")
    np.testing.assert_array_equal(got["max_radii2d"],
                                  np.asarray(j_state.max_radii2d))
    np.testing.assert_array_equal(got["denom"], np.asarray(j_state.denom))
    acc = np.asarray(j_state.xyz_grad_accum)
    np.testing.assert_allclose(got["xyz_grad_accum"], acc,
                               atol=6e-3 * np.abs(acc).max())


def test_shard_batch_args_refuses_a_ragged_batch(view_case):
    with pytest.raises(RuntimeError, match="a batch of 3 over 2 ranks"):
        spawn(dryrun.view_step_rank, 2, batch(view_case, 3))

