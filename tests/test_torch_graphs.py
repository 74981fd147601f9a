"""The code the port's captured CUDA graphs replay (utils/graphs.py,
mapper/trainer.StepGraphs, ops/render.render_jit), on the CPU, where the
graph cache calls each function directly: the donating train step (its
densification statistics, step count and learning rates written in place
or read from 0-d tensors) bit-equal to the functional step and against
JAX's train_step; train_chunk with its device view index against JAX's
scanned train_chunk; a 300-iteration GaussianTrainer on the new route
bit-equal to the functional route through densify, opacity resets, a
capacity growth and a checkpoint resume; the render graphs a capacity
growth drops; render_jit's keys and the cache's eviction; and the
replay-aware launch counts."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photo_slam_tpu.mapper import trainer as jtrainer
from photo_slam_tpu.models import gaussian_model as jgm
from photo_slam_tpu.models import optimizer as joptim
from photo_slam_tpu.ops.camera_math import build_camera_matrices as jcam
from photo_slam_tpu.ops.render import RenderSettings as JSettings
from photo_slam_tpu_torch.config import Config
from photo_slam_tpu_torch.mapper import trainer as ttrainer
from photo_slam_tpu_torch.models import densify as tdz
from photo_slam_tpu_torch.models import gaussian_model as tgm
from photo_slam_tpu_torch.models import optimizer as toptim
from photo_slam_tpu_torch.models.camera import PINHOLE, Camera
from photo_slam_tpu_torch.models.keyframe import Keyframe
from photo_slam_tpu_torch.models.scene import Scene
from photo_slam_tpu_torch.ops import losses as tlosses
from photo_slam_tpu_torch.ops import render as trender
from photo_slam_tpu_torch.ops.camera_math import CameraMatrices
from photo_slam_tpu_torch.ops.camera_math import build_camera_matrices as tcam
from photo_slam_tpu_torch.ops.render import RenderSettings, render
from photo_slam_tpu_torch.utils import graphs
from test_torch_blend import one_torch_thread  # noqa: F401
from test_torch_trainer import (FIELDS, FOVX, FOVY, FX, FY, H, SHIFTS, W,
                                gt_model, render_gt)

KW = dict(width=W, height=H, tan_fovx=W / (2 * FX), tan_fovy=H / (2 * FY),
          sh_degree=0, tile=32, max_tiles_per_gaussian=16, max_per_tile=256,
          tiles_per_chunk=2)
LRS = (1.6e-4, 2.5e-3, 0.05, 5e-3, 1e-3)
LAMBDA = 0.2
CAP = 64


def position_lrs(step):
    """The position LR of step `step` on expon_lr's schedule (it changes
    every step), with bench.py's other rates."""
    pos = toptim.expon_lr(step, 1.6e-4, 1.6e-6, max_steps=10)
    return (pos,) + LRS[1:]


def initial_map(seed=1):
    """run_train_steps' start: the model's points moved by noise,
    anisotropic scales and turned quats, as numpy arrays and a live
    mask."""
    model = gt_model(n=40, seed=5)
    rng = np.random.RandomState(seed)
    init = model[0] + rng.randn(*model[0].shape).astype(np.float32) * 0.05
    state0 = tgm.create_from_pcd(init, rng.rand(*init.shape), sh_degree=0,
                                 capacity=CAP, device="cpu")
    arrays = {k: getattr(state0.params, k).numpy() for k in FIELDS}
    arrays["log_scales"] += rng.uniform(-0.4, 0.4, (CAP, 3)).astype(
        np.float32)
    arrays["quats"] = rng.randn(CAP, 4).astype(np.float32)
    return model, arrays, state0.live.numpy()


def port_views():
    return [tcam(np.eye(3), np.array([dx, 0.0, 0.0]), 0.01, 100.0, FOVX,
                 FOVY, device="cpu") for dx in SHIFTS]


def functional_adam(params, grads, opt, lrs, live):
    """optimizer.adam_step as new tensors: the step count a new tensor,
    nothing written in place."""
    step = opt.step + 1
    t = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(toptim.BETA1, t)
    bc2 = 1.0 - torch.pow(toptim.BETA2, t)
    out_p, out_m, out_v = [], [], []
    for name, p, g, m, v in zip(toptim.GROUPS, params, grads, opt.m, opt.v):
        mask = live.reshape((live.shape[0],) + (1,) * (p.dim() - 1))
        g = torch.where(mask, g, 0.0)
        m = toptim.BETA1 * m + (1.0 - toptim.BETA1) * g
        v = toptim.BETA2 * v + (1.0 - toptim.BETA2) * (g * g)
        update = getattr(lrs, name) * (m / bc1) / (
            torch.sqrt(v / bc2) + toptim.ADAM_EPS)
        out_p.append(torch.where(mask, p - update, p))
        out_m.append(m)
        out_v.append(v)
    return (tgm.GaussianParams(*out_p),
            toptim.AdamState(m=tgm.GaussianParams(*out_m),
                             v=tgm.GaussianParams(*out_v), step=step))


def functional_step(state, opt, cam, gt, mask, lrs, bg, lam, settings,
                    lock=None):
    """The train step with every result a new tensor: the functional
    densification statistics of models/densify.py, functional_adam and
    float learning rates."""
    live = state.live
    params = tgm.GaussianParams(*(p.detach().requires_grad_(True)
                                  for p in state.params))
    offset = torch.zeros((state.capacity, 2), requires_grad=True)
    sc, q, o = tgm.activated(params)
    res = render(params.xyz, sc, q, o, cam, settings, bg,
                 shs=tgm.sh_features(params), live_mask=live,
                 means2d_offset=offset)
    masked = res.image * mask[None]
    loss = tlosses.training_loss(masked, gt, lam)
    grads = torch.autograd.grad(loss, [*params, offset], allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for g, x in zip(grads, [*params, offset])]
    with torch.no_grad():
        state = tdz.update_max_radii(state, res.radii, res.visible)
        state = tdz.add_densification_stats(state, grads[-1], res.visible,
                                            settings.width, settings.height)
        new_params, opt = functional_adam(
            state.params, tgm.GaussianParams(*grads[:-1]), opt, lrs, live)
        metrics = {"loss": loss.detach(),
                   "psnr": tlosses.psnr(masked.detach(), gt),
                   "num_visible": res.visible.sum(dtype=torch.int32),
                   "binning_clipped": res.num_clipped,
                   "binning_overflow": res.num_overflow}
    return state._replace(params=new_params), opt, metrics


def all_tensors(state, opt):
    return {"params": list(state.params), "stats": list(state[1:]),
            "m": list(opt.m), "v": list(opt.v), "step": [opt.step]}


def assert_bit_equal(a, b):
    for k in a:
        for i, (x, y) in enumerate(zip(a[k], b[k])):
            assert torch.equal(x, y), f"{k}[{i}]"


@pytest.mark.parametrize("reference", ["functional", "jax_tiled"])
def test_donating_step_over_five_steps(reference):
    """Five donating steps with the position LR changing every step, read
    from 0-d tensors (optim.lr_tensors): bit-equal to the functional step
    with float rates, and within test_torch_trainer's tolerances of JAX's
    train_step in "tiled" mode (loss 1e-4 relative, each group's update 6e-3
    of its largest). The statistics and the step count are the tensors
    passed in."""
    model, arrays, live = initial_map()
    gts = [render_gt(model, np.array([dx, 0.0, 0.0])) for dx in SHIFTS]
    views = port_views()
    settings = RenderSettings(mode="pallas", **KW)
    state = tgm.state_from_numpy(arrays, live, device="cpu")
    opt = toptim.init_adam(state.params)
    stats_in = (state.xyz_grad_accum, state.denom, state.max_radii2d,
                opt.step)
    lr_t = toptim.lr_tensors("cpu")
    if reference == "functional":
        ref_state = tgm.state_from_numpy(arrays, live, device="cpu")
        ref_opt = toptim.init_adam(ref_state.params)
    else:
        ref_state = jgm.GaussianState(
            params=jgm.GaussianParams(**{k: jnp.asarray(v)
                                         for k, v in arrays.items()}),
            live=jnp.asarray(live), max_radii2d=jnp.zeros(CAP),
            xyz_grad_accum=jnp.zeros(CAP), denom=jnp.zeros(CAP),
            exist_since_iter=jnp.zeros(CAP, jnp.int32))
        ref_opt = joptim.init_adam(ref_state.params)
    for step in range(5):
        lrs = toptim.LearningRates.create(*position_lrs(step))
        toptim.set_lrs(lr_t, lrs)
        assert float(lr_t.xyz) == lrs.xyz
        gt = torch.from_numpy(gts[step % 3])
        state, opt, met = ttrainer.train_step(
            state, opt, views[step % 3], gt, torch.ones((H, W)), lr_t,
            torch.zeros(3), LAMBDA, settings)
        if reference == "functional":
            ref_state, ref_opt, ref_met = functional_step(
                ref_state, ref_opt, views[step % 3], gt, torch.ones((H, W)),
                lrs, torch.zeros(3), LAMBDA, settings)
            for k in met:
                assert torch.equal(met[k], ref_met[k]), k
        else:
            ref_state, ref_opt, ref_met = jtrainer.train_step(
                ref_state, ref_opt,
                jcam(np.eye(3), np.array([SHIFTS[step % 3], 0.0, 0.0]), 0.01,
                     100.0, FOVX, FOVY),
                jnp.asarray(gts[step % 3]), jnp.ones((H, W)),
                joptim.LearningRates.create(*position_lrs(step)),
                jnp.zeros(3), jnp.float32(LAMBDA),
                JSettings(mode="tiled", **KW))
            assert float(met["loss"]) == pytest.approx(
                float(ref_met["loss"]), rel=1e-4)
            assert int(met["num_visible"]) == int(ref_met["num_visible"])
    for a, b in zip(stats_in, (state.xyz_grad_accum, state.denom,
                               state.max_radii2d, opt.step)):
        assert a is b
    assert int(opt.step) == 5
    if reference == "functional":
        assert_bit_equal(all_tensors(state, opt),
                         all_tensors(ref_state, ref_opt))
        return
    for k in FIELDS:
        if arrays[k].size == 0:
            continue
        a = getattr(state.params, k).numpy() - arrays[k]
        b = np.asarray(getattr(ref_state.params, k)) - arrays[k]
        np.testing.assert_allclose(a, b, atol=6e-3 * np.abs(b).max(),
                                   err_msg=f"update of {k}")
    scale = np.abs(np.asarray(ref_state.xyz_grad_accum)).max()
    np.testing.assert_allclose(state.xyz_grad_accum.numpy(),
                               np.asarray(ref_state.xyz_grad_accum),
                               atol=6e-3 * scale)
    np.testing.assert_array_equal(state.max_radii2d.numpy(),
                                  np.asarray(ref_state.max_radii2d))


@pytest.mark.parametrize("route", ["train_chunk", "StepGraphs"])
def test_train_chunk_matches_jax_train_chunk(route):
    """7 steps from ring offset 2 (tests/test_trainer.py::TestTrainChunk)
    with the device view index: each step's loss within 1e-4 of JAX's
    scanned train_chunk ("tiled"), the updates within 6e-3 of each group's
    largest, and the chunk bit-equal to the same 7 train_step calls."""
    model, arrays, live = initial_map()
    gts = np.stack([render_gt(model, np.array([dx, 0.0, 0.0]))
                    for dx in SHIFTS])
    views = port_views()
    settings = RenderSettings(mode="pallas", **KW)
    lrs = toptim.LearningRates.create(*LRS)
    num_steps, start = 7, 2
    cams = CameraMatrices(*(torch.stack(x) for x in zip(*views)))
    state = tgm.state_from_numpy(arrays, live, device="cpu")
    opt = toptim.init_adam(state.params)
    chunk = ttrainer.train_chunk if route == "train_chunk" \
        else ttrainer.StepGraphs().train_chunk
    state, opt, met = chunk(state, opt, cams, torch.from_numpy(gts),
                            torch.ones((H, W)), lrs, torch.zeros(3), LAMBDA,
                            start, settings, num_steps)
    assert met["loss"].shape == (num_steps,)

    seq_state = tgm.state_from_numpy(arrays, live, device="cpu")
    seq_opt = toptim.init_adam(seq_state.params)
    for j in range(num_steps):
        v = (start + j) % len(views)
        seq_state, seq_opt, m = ttrainer.train_step(
            seq_state, seq_opt, views[v], torch.from_numpy(gts[v]),
            torch.ones((H, W)), lrs, torch.zeros(3), LAMBDA, settings)
        for k in m:
            assert torch.equal(met[k][j], m[k].to(met[k].dtype)), (k, j)
    assert_bit_equal(all_tensors(state, opt), all_tensors(seq_state,
                                                          seq_opt))

    j_state = jgm.GaussianState(
        params=jgm.GaussianParams(**{k: jnp.asarray(v)
                                     for k, v in arrays.items()}),
        live=jnp.asarray(live), max_radii2d=jnp.zeros(CAP),
        xyz_grad_accum=jnp.zeros(CAP), denom=jnp.zeros(CAP),
        exist_since_iter=jnp.zeros(CAP, jnp.int32))
    j_cams = [jcam(np.eye(3), np.array([dx, 0.0, 0.0]), 0.01, 100.0, FOVX,
                   FOVY) for dx in SHIFTS]
    j_state, j_opt, j_met = jtrainer.train_chunk(
        j_state, joptim.init_adam(j_state.params),
        jax.tree.map(lambda *xs: jnp.stack(xs), *j_cams), jnp.asarray(gts),
        jnp.ones((H, W)), joptim.LearningRates.create(*LRS), jnp.zeros(3),
        jnp.float32(LAMBDA), jnp.int32(start), JSettings(mode="tiled", **KW),
        num_steps)
    np.testing.assert_allclose(met["loss"].numpy(),
                               np.asarray(j_met["loss"]), rtol=1e-4)
    np.testing.assert_array_equal(met["num_visible"].numpy(),
                                  np.asarray(j_met["num_visible"]))
    assert int(opt.step) == int(j_opt.step) == num_steps
    for k in FIELDS:
        if arrays[k].size == 0:
            continue
        a = getattr(state.params, k).numpy() - arrays[k]
        b = np.asarray(getattr(j_state.params, k)) - arrays[k]
        np.testing.assert_allclose(a, b, atol=6e-3 * np.abs(b).max(),
                                   err_msg=f"update of {k}")


class FunctionalRoute:
    """The trainer's route before the graphs: functional_step, and densify
    and the opacity reset as new tensors (the extent a 0-d tensor, as
    StepGraphs passes it)."""

    captures = 0

    def train_step(self, *args, **kw):
        return functional_step(*args, **kw)

    def split_noise(self, capacity, device):
        return torch.empty((2, capacity, 3), device=device)

    def densify_step(self, state, opt_state, noise, extent, **kw):
        return ttrainer.densify_step(state, opt_state, noise,
                                     torch.tensor(extent, dtype=torch.float32),
                                     **kw)

    def opacity_reset_step(self, state, opt_state):
        return ttrainer.opacity_reset_step(state, opt_state)

    def drop(self):
        pass


TRAINER_ITERS = 300
RESUME_AT = 150
GROW_AT = 60
SW, SH, SF = 32, 24, 30.0   # the trainer run's keyframes: one 32 px tile


def trainer_cfg():
    cfg = Config()
    cfg.renderer.initial_capacity = 64
    cfg.opt.densify_from_iter = 20
    cfg.opt.densification_interval = 25
    cfg.opt.densify_until_iter = 260
    # 50x the default: the map grows from 60 to ~100 Gaussians, so the
    # plain blends' loops stay short.
    cfg.opt.densify_grad_threshold = 0.01
    cfg.opt.opacity_reset_interval = 100
    cfg.opt.position_lr_max_steps = 300
    cfg.mapper.do_gaus_pyramid_training = False
    return cfg


def small_scene():
    """Three keyframes of 32x24 px (one tile, so the plain blends loop over
    few entries) seen from SHIFTS, rendered from gt_model(n=20) through the
    dense oracle; returns (scene, model)."""
    cam = Camera(camera_id=0, model_id=PINHOLE, width=SW, height=SH, fx=SF,
                 fy=SF, cx=SW / 2, cy=SH / 2)
    scene = Scene()
    scene.add_camera(cam)
    model = gt_model(n=20, seed=3)
    pts, scales, quats, opac, colors = (torch.from_numpy(x) for x in model)
    fx = 2 * np.arctan(SW / (2 * SF))
    fy = 2 * np.arctan(SH / (2 * SF))
    for i, dx in enumerate(SHIFTS):
        kf = Keyframe(fid=i, camera=cam)
        kf.set_pose(np.array([1.0, 0, 0, 0]), np.array([dx, 0.0, 0.0]),
                    device="cpu")
        img = render(pts, scales, quats, opac,
                     tcam(np.eye(3), np.array([dx, 0.0, 0.0]), 0.01, 100.0,
                          fx, fy, device="cpu"),
                     RenderSettings(width=SW, height=SH,
                                    tan_fovx=SW / (2 * SF),
                                    tan_fovy=SH / (2 * SF), mode="dense"),
                     torch.zeros(3), colors_precomp=colors).image
        kf.set_image(img.numpy())
        kf.remaining_times_of_use = 10**9
        scene.add_keyframe(kf)
    return scene, model


def run_trainer(functional, tmp_path):
    """GaussianTrainer for TRAINER_ITERS iterations: densify every 25 from
    20, opacity resets at 100 and 200, a capacity growth by increase_pcd at
    GROW_AT, and a checkpoint at RESUME_AT loaded into a new trainer that
    runs the rest. Returns (trainer, the iterations' losses, the
    capacities seen)."""
    def make(seed):
        scene, model = small_scene()
        tr = ttrainer.GaussianTrainer(trainer_cfg(), scene, seed=seed,
                                      device="cpu")
        if functional:
            tr.graphs = FunctionalRoute()
        return tr, model

    tr, model = make(0)
    rng = np.random.RandomState(0)
    tr.initialize_map(model[0], np.clip(
        model[4] + rng.randn(*model[4].shape) * 0.2, 0, 1).astype(
            np.float32))
    losses, caps = [], {tr.state.capacity}
    for i in range(1, TRAINER_ITERS + 1):
        if i == GROW_AT:
            tr.increase_pcd(
                (rng.randn(40, 3) * [0.8, 0.6, 0.5] + [0, 0, 5.5]).astype(
                    np.float32), rng.rand(40, 3).astype(np.float32))
        losses.append(float(tr.train_iteration()["loss"]))
        caps.add(tr.state.capacity)
        if i == RESUME_AT:
            path = tmp_path / f"ckpt_{functional}.npz"
            tr.save_checkpoint(path)
            tr, _ = make(1)
            tr.load_checkpoint(path)
    return tr, losses, caps


def test_trainer_300_iterations_bit_equal_to_functional_route(tmp_path):
    """The trainer's iterations through StepGraphs (on the CPU: the
    donating step, run directly) bit-equal, in every loss and every tensor
    of the map and its Adam state, to the same run through the functional
    step, across densify, the opacity resets, a capacity growth and a
    checkpoint resume."""
    new, new_losses, caps = run_trainer(False, tmp_path)
    old, old_losses, _ = run_trainer(True, tmp_path)
    assert len(caps) >= 2, caps
    assert new.iteration == old.iteration == TRAINER_ITERS
    assert new_losses == old_losses
    assert np.isfinite(new_losses).all()
    assert_bit_equal(all_tensors(new.state, new.opt_state),
                     all_tensors(old.state, old.opt_state))


def test_capacity_growth_drops_old_render_graphs(monkeypatch):
    """A capacity growth drops the render graphs of the old capacity and
    the map copies they held (their input buffers), and keeps those of
    other maps."""
    cache = graphs.GraphCache()
    monkeypatch.setattr(trender, "RENDER_GRAPHS", cache)
    scene, model = small_scene()
    tr = ttrainer.GaussianTrainer(trainer_cfg(), scene, device="cpu")
    tr.initialize_map(model[0], model[4])
    old = tr.state.capacity
    bufs = {rows: torch.zeros(rows, 3) for rows in (old, 7)}
    for rows, buf in bufs.items():
        cache.entry(("render", rows),
                    lambda buf=buf: graphs.Graphed(None, (buf,), (), {}))
        cache._inputs[(0, *graphs.spec(buf))] = buf
    rng = np.random.RandomState(0)
    tr.increase_pcd(rng.randn(40, 3).astype(np.float32) + [0, 0, 5.5],
                    rng.rand(40, 3).astype(np.float32))
    assert tr.state.capacity > old
    assert cache.keys() == [("render", 7)]
    assert [b.shape[0] for b in cache._inputs.values()] == [7]


def test_render_jit_keys_and_eviction():
    """render_jit's entry key: the same for the same settings and shapes
    (new tensors), another for a new image size, SH degree or capacity;
    the cache keeps the 64 most recently used entries. On the CPU it is
    render."""
    bg = torch.zeros(3)
    cam = port_views()[1]
    settings = RenderSettings(mode="pallas", **KW)

    def args(cap, s=settings, seed=0):
        rng = np.random.RandomState(seed)
        st = tgm.create_from_pcd(
            rng.randn(40, 3).astype(np.float32) + [0, 0, 5],
            rng.rand(40, 3).astype(np.float32), sh_degree=1, capacity=cap,
            device="cpu")
        sc, q, o = tgm.activated(st.params)
        return (st.params.xyz, sc, q, o, cam, s, bg), dict(
            shs=tgm.sh_features(st.params), live_mask=st.live)

    def key(cap, s=settings, seed=0):
        a, kw = args(cap, s, seed)
        return graphs.GraphCache.key_of(*trender.render_jit_args(*a, **kw))

    base = key(CAP)
    assert key(CAP, seed=1) == base
    assert key(CAP, settings._replace(width=96)) != base
    assert key(CAP, settings._replace(sh_degree=1)) != base
    assert key(2 * CAP) != base
    a, kw = args(CAP)
    got, want = trender.render_jit(*a, **kw), render(*a, **kw)
    for x, y in zip(got, want):
        assert torch.equal(x, y)

    cache = graphs.GraphCache()
    for i in range(graphs.GRAPH_CACHE_SIZE + 1):
        assert cache.entry(("k", i), lambda i=i: i) == i
    assert len(cache) == graphs.GRAPH_CACHE_SIZE
    assert ("k", 0) not in cache.keys()
    assert cache.entry(("k", 1), lambda: pytest.fail("rebuilt")) == 1
    cache.entry(("k", 99), lambda: 99)
    assert ("k", 1) in cache.keys() and ("k", 2) not in cache.keys()
    cache.clear()
    assert len(cache) == 0


def test_replay_aware_launch_counts(monkeypatch):
    """A launch while the current stream captures goes to the capture's
    tally, not to the count; each replay adds the tally; a launch on a
    stream that does not capture counts at once."""
    def wrapper():
        pass

    wrapper.launches = 0
    dev = torch.device("cuda", 0)
    stream = [11]
    monkeypatch.setattr(graphs, "_current_stream_handle",
                        lambda d: stream[0])
    graphs.count_launch(wrapper, dev)
    assert wrapper.launches == 1
    tally = {}
    monkeypatch.setitem(graphs._capturing, 11, tally)
    for _ in range(3):
        graphs.count_launch(wrapper, dev)
    assert wrapper.launches == 1 and tally == {wrapper: 3}
    stream[0] = 12
    graphs.count_launch(wrapper, dev)
    assert wrapper.launches == 2 and tally == {wrapper: 3}
    graphs.add_launches(tally)
    graphs.add_launches(tally, 5)
    assert wrapper.launches == 2 + 3 + 15


def test_graph_cache_runs_directly_on_cpu():
    """On CPU tensors GraphCache.run calls the function, `replays` times,
    and captures nothing."""
    cache = graphs.GraphCache()
    x = torch.zeros(3)
    out = cache.run("k", lambda a: (a.add_(1), a * 2), (x,), replays=4)
    assert torch.equal(x, torch.full((3,), 4.0))
    assert torch.equal(out[1], torch.full((3,), 8.0))
    assert cache.captures == 0 and len(cache) == 0
