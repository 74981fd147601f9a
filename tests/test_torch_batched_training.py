"""The port's multi-view batched step against the JAX package's:
tests/test_batched_training.py's scenario on the port;
parallel/sharding.train_step_batched against JAX's (mesh=None, JAX
"tiled": f32 autodiff) with 3 distinct views over 5 steps; the B = 1 step
against the port's own train_step; and train_iteration_batched against
JAX's through a densify event, with JAX's split draws injected.

Tolerances: the loss within 1e-4 relative; each parameter group's update
within 6e-3 of its largest (tests/test_torch_trainer.py's bound against
"tiled"); max_radii2d equal; xyz_grad_accum within 6e-3 of its largest;
B = 1 within 1e-6 of train_step."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photo_slam_tpu.config import Config as JConfig
from photo_slam_tpu.mapper import trainer as jtrainer
from photo_slam_tpu.models import gaussian_model as jgm
from photo_slam_tpu.models import optimizer as joptim
from photo_slam_tpu.models.camera import Camera as JCamera
from photo_slam_tpu.models.keyframe import Keyframe as JKeyframe
from photo_slam_tpu.models.scene import Scene as JScene
from photo_slam_tpu.ops.camera_math import CameraMatrices as JCams
from photo_slam_tpu.ops.camera_math import build_camera_matrices as jcam
from photo_slam_tpu.ops.render import RenderSettings as JSettings
from photo_slam_tpu.parallel import sharding as jsharding
from photo_slam_tpu_torch.config import Config
from photo_slam_tpu_torch.mapper import trainer as ttrainer
from photo_slam_tpu_torch.models import gaussian_model as tgm
from photo_slam_tpu_torch.models import optimizer as toptim
from photo_slam_tpu_torch.models.camera import PINHOLE, Camera
from photo_slam_tpu_torch.models.keyframe import Keyframe
from photo_slam_tpu_torch.models.scene import Scene
from photo_slam_tpu_torch.ops.camera_math import CameraMatrices
from photo_slam_tpu_torch.ops.camera_math import build_camera_matrices as tcam
from photo_slam_tpu_torch.ops.render import RenderSettings
from photo_slam_tpu_torch.parallel import sharding as tsharding
from test_torch_blend import one_torch_thread  # noqa: F401
from test_torch_mapper import port_twin_cfg
from test_torch_trainer import FIELDS, FOVX, FOVY, FX, FY, H, W
from test_torch_trainer import gt_model, render_gt

VIEWS = ((-0.3, 0.0, 0.0), (0.0, 0.1, 0.0), (0.3, -0.05, 0.1))
LAMBDA = 0.2
LRS = (1.6e-4, 2.5e-3, 0.05, 5e-3, 1e-3)
SETTINGS = dict(width=W, height=H, tan_fovx=W / (2 * FX),
                tan_fovy=H / (2 * FY), sh_degree=0, tile=32,
                max_tiles_per_gaussian=16, max_per_tile=256,
                tiles_per_chunk=2)


def test_batched_iteration_trains():
    """tests/test_batched_training.py::test_batched_iteration_trains on the
    port, on the CPU."""
    cfg = Config()
    cfg.renderer.initial_capacity = 256
    cfg.mapper.do_gaus_pyramid_training = False
    cam = Camera(camera_id=0, model_id=PINHOLE, width=W, height=H,
                 fx=60.0, fy=60.0, cx=W / 2, cy=H / 2)
    scene = Scene()
    scene.add_camera(cam)
    rng = np.random.RandomState(0)
    kfs = []
    for i in range(4):
        kf = Keyframe(fid=i, camera=cam)
        kf.set_pose(np.array([1.0, 0, 0, 0]), np.array([0.05 * i, 0, 0]),
                    device="cpu")
        kf.set_image(np.full((3, H, W), 0.6, np.float32))
        kf.remaining_times_of_use = 10**9
        scene.add_keyframe(kf)
        kfs.append(kf)
    trainer = ttrainer.GaussianTrainer(cfg, scene, device="cpu")
    pts = np.stack([rng.uniform(-1, 1, 40), rng.uniform(-0.8, 0.8, 40),
                    rng.uniform(4, 6, 40)], 1).astype(np.float32)
    trainer.initialize_map(pts, rng.rand(40, 3).astype(np.float32))

    losses = []
    for _ in range(6):
        m = trainer.train_iteration_batched(kfs)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert trainer.iteration == 6


def initial_map(model, cap=64):
    """tests/test_torch_trainer.py::run_train_steps's starting map: numpy
    parameter arrays and the live mask."""
    rng = np.random.RandomState(1)
    init = model[0] + rng.randn(*model[0].shape).astype(np.float32) * 0.05
    state0 = tgm.create_from_pcd(init, rng.rand(*init.shape), sh_degree=0,
                                 capacity=cap, device="cpu")
    arrays = {k: getattr(state0.params, k).numpy() for k in FIELDS}
    arrays["log_scales"] += rng.uniform(-0.4, 0.4, (cap, 3)).astype(
        np.float32)
    arrays["quats"] = rng.randn(cap, 4).astype(np.float32)
    return arrays, state0.live.numpy()


def port_views(views):
    cams = [tcam(np.eye(3), np.array(t), 0.01, 100.0, FOVX, FOVY,
                 device="cpu") for t in views]
    return CameraMatrices(*(torch.stack(x) for x in zip(*cams)))


def port_state(arrays, live):
    state = tgm.state_from_numpy(arrays, live, device="cpu")
    return state, toptim.init_adam(state.params)


def test_train_step_batched_tracks_jax_over_five_steps():
    model = gt_model(n=40, seed=5)
    arrays, live = initial_map(model)
    b = len(VIEWS)
    gts = np.stack([render_gt(model, np.array(t)) for t in VIEWS])
    masks = np.ones((b, H, W), np.float32)
    jcams = [jcam(np.eye(3), np.array(t), 0.01, 100.0, FOVX, FOVY)
             for t in VIEWS]
    jcams = JCams(*(jnp.stack(x) for x in zip(*jcams)))
    cap = len(live)
    j_state = jgm.GaussianState(
        params=jgm.GaussianParams(**{k: jnp.asarray(v)
                                     for k, v in arrays.items()}),
        live=jnp.asarray(live), max_radii2d=jnp.zeros(cap),
        xyz_grad_accum=jnp.zeros(cap), denom=jnp.zeros(cap),
        exist_since_iter=jnp.zeros(cap, jnp.int32))
    j_opt = joptim.init_adam(j_state.params)
    t_state, t_opt = port_state(arrays, live)
    tcams = port_views(VIEWS)
    for _ in range(5):
        j_state, j_opt, jm = jsharding.train_step_batched(
            j_state, j_opt, jcams, jnp.asarray(gts), jnp.asarray(masks),
            joptim.LearningRates.create(*LRS), jnp.zeros(3),
            jnp.float32(LAMBDA), JSettings(mode="tiled", **SETTINGS))
        t_state, t_opt, tm = tsharding.train_step_batched(
            t_state, t_opt, tcams, torch.from_numpy(gts),
            torch.from_numpy(masks), toptim.LearningRates.create(*LRS),
            torch.zeros(3), LAMBDA, RenderSettings(mode="pallas",
                                                   **SETTINGS))
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=1e-4)
        assert int(tm["num_visible"]) == int(jm["num_visible"])
    assert int(t_opt.step) == int(j_opt.step) == 5
    for k in FIELDS:
        if arrays[k].size == 0:   # features_rest at SH degree 0
            continue
        a = getattr(t_state.params, k).numpy() - arrays[k]
        want = np.asarray(getattr(j_state.params, k)) - arrays[k]
        scale = np.abs(want).max()
        assert scale > 0, k
        np.testing.assert_allclose(a, want, atol=6e-3 * scale,
                                   err_msg=f"update of {k}")
    np.testing.assert_array_equal(t_state.max_radii2d.numpy(),
                                  np.asarray(j_state.max_radii2d))
    np.testing.assert_array_equal(t_state.denom.numpy(),
                                  np.asarray(j_state.denom))
    acc = np.asarray(j_state.xyz_grad_accum)
    np.testing.assert_allclose(t_state.xyz_grad_accum.numpy(), acc,
                               atol=6e-3 * np.abs(acc).max())


def test_single_view_batch_is_train_step():
    """B = 1 gives the port's train_step, 3 steps, within 1e-6."""
    model = gt_model(n=40, seed=5)
    arrays, live = initial_map(model)
    gt = torch.from_numpy(render_gt(model, np.array(VIEWS[0])))
    cams = port_views(VIEWS[:1])
    settings = RenderSettings(mode="pallas", **SETTINGS)
    lrs = toptim.LearningRates.create(*LRS)
    (a, a_opt), (b, b_opt) = port_state(arrays, live), port_state(arrays,
                                                                 live)
    for _ in range(3):
        a, a_opt, am = tsharding.train_step_batched(
            a, a_opt, cams, gt[None], torch.ones((1, H, W)), lrs,
            torch.zeros(3), LAMBDA, settings)
        b, b_opt, bm = ttrainer.train_step(
            b, b_opt, CameraMatrices(*(x[0] for x in cams)), gt,
            torch.ones((H, W)), lrs, torch.zeros(3), LAMBDA, settings)
        assert float(am["loss"]) == pytest.approx(float(bm["loss"]),
                                                  rel=1e-6)
        assert int(am["num_visible"]) == int(bm["num_visible"])
    for name in ("max_radii2d", "xyz_grad_accum", "denom"):
        np.testing.assert_allclose(getattr(a, name).numpy(),
                                   getattr(b, name).numpy(), atol=1e-6)
    for x, y in zip([*a.params, *a_opt.m, *a_opt.v],
                    [*b.params, *b_opt.m, *b_opt.v]):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-6)


def make_trainers():
    """A JAX trainer and a port trainer over one scene of three keyframes
    rendered from gt_model, the port holding the JAX trainer's initial map
    (densify from iteration 1 every 3, no opacity reset)."""
    jcfg = JConfig()
    jcfg.renderer.initial_capacity = 128
    jcfg.mapper.do_gaus_pyramid_training = False
    jcfg.opt.densify_from_iter = 1
    jcfg.opt.densification_interval = 3
    jcfg.opt.densify_until_iter = 100
    jcfg.opt.opacity_reset_interval = 0
    model = gt_model()
    trainers = []
    for cam_cls, kf_cls, scene_cls, kw in (
            (JCamera, JKeyframe, JScene, {}),
            (Camera, Keyframe, Scene, {"device": "cpu"})):
        cam = cam_cls(camera_id=0, model_id=PINHOLE, width=W, height=H,
                      fx=FX, fy=FY, cx=W / 2, cy=H / 2)
        scene = scene_cls()
        scene.add_camera(cam)
        for i, t in enumerate(VIEWS):
            kf = kf_cls(fid=i, camera=cam)
            kf.set_pose(np.array([1.0, 0, 0, 0]), np.array(t), **kw)
            kf.set_image(render_gt(model, np.array(t)))
            kf.remaining_times_of_use = 10**9
            scene.add_keyframe(kf)
        trainers.append(scene)
    jt = jtrainer.GaussianTrainer(jcfg, trainers[0])
    tt = ttrainer.GaussianTrainer(port_twin_cfg(jcfg), trainers[1],
                                  device="cpu")
    rng = np.random.RandomState(0)
    # Colors off 0: at 0 the colour clamp's kink (JAX's max, torch's
    # clamp_min) makes the gradient hang on the last bit of C0 f + 0.5.
    cols = np.clip(model[4] + rng.randn(*model[4].shape) * 0.2, 0.05, 0.95)
    jt.initialize_map(model[0], cols.astype(np.float32))
    tt.initialize_map(model[0], cols.astype(np.float32))
    js = jt.state
    tt.state = tgm.state_from_numpy(
        {k: np.asarray(getattr(js.params, k)) for k in FIELDS},
        np.asarray(js.live), device="cpu")
    tt.opt_state = toptim.init_adam(tt.state.params)
    tt.spatial_lr_scale = jt.spatial_lr_scale
    tt.scene.cameras_extent = jt.scene.cameras_extent
    return jt, tt


def test_train_iteration_batched_tracks_jax_through_densify(monkeypatch):
    """Four batched iterations over the three keyframes, a densify event at
    the third: the same clones, splits and prunes (JAX's split draws
    injected into the port), the map within the step's tolerance."""
    jt, tt = make_trainers()
    draws, events = [], []
    j_densify, t_densify = jtrainer.densify_step, ttrainer.densify_step

    def jax_densify(state, opt_state, key, *a, **k):
        k1, k2 = jax.random.split(key)
        cap = state.capacity
        draws.append(np.stack([np.asarray(jax.random.normal(k1, (cap, 3))),
                               np.asarray(jax.random.normal(k2, (cap, 3)))]))
        out = j_densify(state, opt_state, key, *a, **k)
        events.append(out[2])
        return out

    def port_densify(state, opt_state, noise, *a, **k):
        assert noise.shape == draws[-1].shape
        out = t_densify(state, opt_state, torch.from_numpy(draws[-1]), *a,
                        **k)
        events.append(out[2])
        return out

    monkeypatch.setattr(jtrainer, "densify_step", jax_densify)
    monkeypatch.setattr(ttrainer, "densify_step", port_densify)
    live0 = np.asarray(jt.state.live)
    init = {k: np.asarray(getattr(jt.state.params, k)).copy()
            for k in FIELDS}
    for it in range(4):
        jm = jt.train_iteration_batched(
            [jt.scene.keyframes[i] for i in (0, 1, 2)])
        tm = tt.train_iteration_batched(
            [tt.scene.keyframes[i] for i in (0, 1, 2)])
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=1e-4), it
    assert tt.iteration == jt.iteration == 4
    assert len(events) == 2
    jinfo, tinfo = events
    for f in tinfo._fields:
        assert int(getattr(tinfo, f)) == int(getattr(jinfo, f)), f
    assert int(jinfo.num_cloned) + int(jinfo.num_split) > 0
    js, ts = jt.state, tt.state
    np.testing.assert_array_equal(ts.live.numpy(), np.asarray(js.live))
    assert tt.metrics.num_live == jt.metrics.num_live
    assert tt.ema_loss == pytest.approx(jt.ema_loss, rel=1e-4)
    live = ts.live.numpy()
    for k in ("xyz", "features_dc", "opacity_logit", "log_scales"):
        a = getattr(ts.params, k).numpy()
        b = np.asarray(getattr(js.params, k))
        # Within 6e-3 of the largest change JAX made to a Gaussian that
        # was live from the start; the densified ones start from parents
        # held to the same bound.
        scale = np.abs(b[live0] - init[k][live0]).max()
        assert scale > 0, k
        np.testing.assert_allclose(a[live], b[live], atol=6e-3 * scale,
                                   err_msg=k)
    for k in ("max_radii2d", "denom"):
        np.testing.assert_array_equal(getattr(ts, k).numpy(),
                                      np.asarray(getattr(js, k)), err_msg=k)
    acc = np.asarray(js.xyz_grad_accum)
    np.testing.assert_allclose(ts.xyz_grad_accum.numpy(), acc,
                               atol=6e-3 * np.abs(acc).max())
