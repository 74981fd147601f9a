"""photo_slam_tpu_torch/tools/attr_quality.py on the CPU against the JAX
package: a small room (3,000 points at 128x96, where k_dup 6 clips and
1,024 entries a tile overflow), a state of 3 protocol steps saved by the
soak's save_ckpt and scored by the tool's main from its directory; each of
the four attributions held against the same scores computed through the
JAX package's render (its CPU "tiled" mode at 32 px tiles: the exact
render with tiles that do not overflow, the 1-pass one at 1,024 entries a
tile) and psnr, at k_dup 6 and 16, within 0.01 dB. Also the tool's own
check against the soak's summary, and the TF32 flag put back."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photo_slam_tpu.models import gaussian_model as jgm
from photo_slam_tpu.ops.camera_math import build_camera_matrices as jcam
from photo_slam_tpu.ops.losses import psnr as jpsnr
from photo_slam_tpu.ops.render import RenderSettings as JSettings
from photo_slam_tpu.ops.render import render as jrender
from photo_slam_tpu_torch.models import gaussian_model as tgm
from photo_slam_tpu_torch.models import optimizer as toptim
from photo_slam_tpu_torch.tools import attr_quality, bench
from photo_slam_tpu_torch.tools import quality_soak_30k as soak
from photo_slam_tpu_torch.tools.bench_room import room_scene
from test_torch_blend import one_torch_thread  # noqa: F401

N, W, H = 3000, 128, 96
STEPS = 3
TOL_DB = 0.01
ARGS = ["--n", str(N), "--width", str(W), "--height", str(H), "--device",
        "cpu", "--commit", "test"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(the tool's report, the scored state's arrays and live mask, the
    room's points, the checkpoint's directory): a fresh model of the
    protocol fitted STEPS iterations on three of the scored training views
    (exact renders), saved by save_ckpt beside a soak summary that holds
    its held-out PSNR as the soak scores it (bench.held_out), then scored
    by attr_quality.main."""
    ckpt_dir = tmp_path_factory.mktemp("soak")
    rng = np.random.RandomState(0)
    pts, _ = room_scene(N, rng=rng)
    sc = attr_quality.scoring(pts, W, H, "cpu")
    extent = bench.scene_extent(pts)
    views = sc.train_cams[:STEPS]
    proto = bench.Protocol(
        views=views,
        gt_views=torch.stack(attr_quality.renders(sc.gt, views, sc.exact,
                                                  sc.bg)),
        test_cams=sc.test_cams,
        gt_tests=torch.stack(attr_quality.renders(sc.gt, sc.test_cams,
                                                  sc.exact, sc.bg)),
        settings=sc.settings, exact=sc.exact, mask=torch.ones((H, W)),
        bg=sc.bg, lrs=toptim.LearningRates.create(*bench.LRS)._replace(
            xyz=float(np.float32(bench.POSITION_LR * max(extent, 1.0)))),
        extent=extent)
    state = bench.fresh_model(pts, rng, N, "cpu")
    gen = torch.Generator().manual_seed(0)
    state, opt, done = bench.fit(proto, state, toptim.init_adam(
        state.params), gen, 0, STEPS)
    soak.save_ckpt(ckpt_dir / f"ckpt_{done:06d}.npz", state, opt, done, gen,
                   proto.extent)
    mapping = float(np.mean([p for p, _ in bench.held_out(proto, state)]))
    (ckpt_dir / "summary.json").write_text(json.dumps({
        "iters_done": done, "mapping_psnr_db": round(mapping, 2),
        "protocol": {"gaussians_gt": N, "width": W, "height": H}}))
    report = attr_quality.main(["--ckpt-dir", str(ckpt_dir)] + ARGS)
    arrays = {k: getattr(state.params, k).numpy()
              for k in tgm.GaussianParams._fields}
    return report, arrays, state.live.numpy(), pts, ckpt_dir


@pytest.fixture(scope="module")
def jax_scores(run):
    """The four attributions through the JAX package's render and psnr:
    items 1-3 in its "tiled" mode (exact at 4,096 entries a tile), item 4,
    whose PSNR is high enough to see a pixel stop, through its Pallas
    kernels, interpreted, with the 2-pass continuation the tool sized."""
    report, arrays, live, pts, _ = run

    def jstate(params, alive):
        return jgm.GaussianParams(**{k: jnp.asarray(v)
                                     for k, v in params.items()}), \
            jnp.asarray(alive)

    gt = bench.gt_world(pts, "cpu")
    gt_params = jstate({k: getattr(gt.params, k).numpy()
                        for k in tgm.GaussianParams._fields},
                       gt.live.numpy())
    fit_params = jstate(arrays, live)
    tan_x = float(np.tan(bench.FOVX / 2))

    def settings(k_dup, per_tile, **kw):
        return JSettings(width=W, height=H, tan_fovx=tan_x,
                         tan_fovy=tan_x * H / W, sh_degree=3, tile=32,
                         max_tiles_per_gaussian=k_dup,
                         max_per_tile=per_tile, tiles_per_chunk=4, **kw)

    def cam(yaw, tx, ty, tz):
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        return jcam(R, np.array([tx, ty, tz]), 0.01, 100.0, bench.FOVX,
                    bench.FOVX * H / W)

    def image(ps, c, s):
        params, alive = ps
        sc, qu, op = jgm.activated(params)
        return jrender(params.xyz, sc, qu, op, c, s, jnp.zeros(3),
                       shs=jgm.sh_features(params), live_mask=alive).image

    def mean_psnr(ps, views, s_fit, s_gt):
        return float(np.mean([float(jpsnr(image(ps, cam(*v), s_fit),
                                          image(gt_params, cam(*v), s_gt)))
                              for v in views]))

    exact6 = settings(6, 4096, mode="tiled")
    exact16 = settings(16, 4096, mode="tiled")
    train = [bench.TRAIN_VIEWS[i] for i in attr_quality.TRAIN_SCORED]
    ho = mean_psnr(fit_params, bench.TEST_VIEWS, exact6, exact6)
    one_pass = settings(6, 1024, mode="pallas")
    two_pass = one_pass._replace(
        overflow_passes=2, overflow_capacity=report["exact_capacity"],
        overflow_compact=report["exact_compact"])
    return {"held_out_psnr_db": ho,
            "train_view_psnr_db": mean_psnr(fit_params, train, exact6,
                                            exact6),
            "held_out_psnr_kdup16_db": mean_psnr(
                fit_params, bench.TEST_VIEWS, exact16, exact16),
            # On the CPU TF32 changes nothing: the f32 score.
            "held_out_psnr_tf32_db": ho,
            "gt_render_1pass_vs_exact_db": mean_psnr(
                gt_params, bench.TEST_VIEWS, one_pass, two_pass)}


@pytest.mark.parametrize("key", ["held_out_psnr_db", "train_view_psnr_db",
                                 "held_out_psnr_kdup16_db",
                                 "held_out_psnr_tf32_db",
                                 "gt_render_1pass_vs_exact_db"])
def test_attribution_matches_jax(run, jax_scores, key):
    report = run[0]
    assert report[key] == pytest.approx(jax_scores[key], abs=TOL_DB), key
    assert np.isfinite(report[key])


def test_report_and_derived_keys(run):
    report, _, _, _, ckpt_dir = run
    on_disk = json.loads((ckpt_dir / "attribution.json").read_text())
    assert on_disk == json.loads(json.dumps(report))
    assert report["ckpt_iter"] == STEPS and report["ckpt"] == \
        f"ckpt_{STEPS:06d}.npz"
    assert report["live"] == N // 2
    # The small room clips at k_dup 6 and overflows 1,024 entries a tile.
    assert report["held_out_psnr_kdup16_db"] != report["held_out_psnr_db"]
    assert min(report["per_view"]["gt_1pass_vs_exact"]) < 60.0
    assert report["generalization_gap_db"] == pytest.approx(
        report["train_view_psnr_db"] - report["held_out_psnr_db"])
    assert report["kdup6_clipping_db"] == pytest.approx(
        report["held_out_psnr_kdup16_db"] - report["held_out_psnr_db"])
    assert report["device"] == "cpu" and report["card"] is None
    assert report["commit"] == "test"


def test_baseline_is_held_to_the_soak(run):
    """The run above reproduced its soak summary's mapping_psnr_db (held
    within 0.01 dB, or main raises); a summary 0.05 dB off fails, and one
    of another iteration or shape is not held to."""
    report, _, _, _, ckpt_dir = run
    assert report["soak_mapping_psnr_db"] == round(
        report["held_out_psnr_db"], 2)
    attr_quality.check_baseline(report["held_out_psnr_db"], None)
    with pytest.raises(RuntimeError, match="does not reproduce"):
        attr_quality.check_baseline(report["held_out_psnr_db"],
                                    report["soak_mapping_psnr_db"] + 0.05)
    assert attr_quality.soak_baseline(ckpt_dir, STEPS + 1, N, W, H) is None
    assert attr_quality.soak_baseline(ckpt_dir, STEPS, N, W, H + 1) is None
    assert attr_quality.soak_baseline(ckpt_dir, STEPS, N, W, H) == \
        report["soak_mapping_psnr_db"]


def test_tf32_flag_is_put_back():
    before = torch.backends.cuda.matmul.allow_tf32
    with attr_quality.tf32_matmuls():
        assert torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32 == before
    with pytest.raises(ValueError):
        with attr_quality.tf32_matmuls():
            raise ValueError
    assert torch.backends.cuda.matmul.allow_tf32 == before
