"""The port's Gaussian-sharded half of parallel/sharding.py on gloo, on the
CPU: deal_gaussian_shards against JAX's exactly; shard then gather gives
the map back exactly; train_step_gaussian_sharded at 2 and 4 ranks against
the port's train_step and at 4 ranks against JAX's make_gp_mesh(4) run
(its 8 virtual CPU devices, tests/conftest.py); and JAX's densify scenario
(tests/test_sharding.py:274-315: capacity grown twofold, dealt, a step, a
shard-local densify with JAX's per-shard split draws injected, a step)
against JAX's.

Tolerances: N ranks against 1 within atol 1e-6, rtol 1e-5
(tests/test_sharding.py:269-272: the bands' gradients are summed in
another order); against JAX's "tiled" f32 mode each parameter group's
update within 6e-3 of its largest (tests/test_torch_batched_training.py),
the counts, live masks and densify counts equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from photo_slam_tpu.models import gaussian_model as jgm
from photo_slam_tpu.models import optimizer as joptim
from photo_slam_tpu.ops.camera_math import CameraMatrices as JCams
from photo_slam_tpu.ops.camera_math import build_camera_matrices
from photo_slam_tpu.ops.render import RenderSettings as JSettings
from photo_slam_tpu.parallel import sharding as jsharding
from photo_slam_tpu_torch.mapper import trainer as ttrainer
from photo_slam_tpu_torch.models import gaussian_model as tgm
from photo_slam_tpu_torch.models import optimizer as toptim
from photo_slam_tpu_torch.ops.camera_math import CameraMatrices
from photo_slam_tpu_torch.ops.render import RenderSettings
from photo_slam_tpu_torch.parallel import dryrun, launch
from photo_slam_tpu_torch.parallel import sharding as tsharding
from test_torch_blend import one_torch_thread  # noqa: F401

RANKS = (2, 4)
TIMEOUT = 240
FIELDS = tgm.GaussianParams._fields
WIDTH, HEIGHT = 64, 48
LRS = (1.6e-4, 2.5e-3, 0.05, 5e-3, 1e-3)
LAMBDA = 0.2
STEPS = 2
DENSIFY = dict(grad_threshold=0.0, min_opacity=0.005, max_screen_size=0,
               percent_dense=0.5)
EXTENT = 100.0


def spawn(fn, n, *args):
    """A rank program of parallel/dryrun.py over n gloo ranks on the CPU
    (its last argument is the device)."""
    return launch.spawn_local(fn, n, backend="gloo", device="cpu",
                              args=(*args, "cpu"), timeout=TIMEOUT)


def jax_arrays(state):
    return ({k: np.asarray(getattr(state.params, k)) for k in FIELDS},
            np.asarray(state.live))


@pytest.fixture(scope="module")
def scene():
    """tests/test_sharding.py::TestGaussianSharded._setup: the JAX scene of
    __graft_entry__._make_scene (128 Gaussians, SH 3) at 64x48, caps that do
    not bind (a band-clipped rect then bins the same per-tile lists), a
    random ground truth; with random rotations and scales that differ by
    axis, as tests/test_torch_batched_training.py::initial_map sets them.
    _make_scene's Gaussians are isotropic, and the loss of an isotropic
    Gaussian does not change with its rotation: the rotation's gradient is
    rounding noise (~1e-15 against ~1e-7, differently in each framework),
    which Adam scales up to steps of the full learning rate."""
    state, _, _, _, tanf = ge._make_scene(n=128, width=WIDTH, height=HEIGHT)
    rng = np.random.RandomState(7)
    params = state.params
    state = state._replace(params=params._replace(
        log_scales=params.log_scales + rng.uniform(
            -0.4, 0.4, params.log_scales.shape).astype(np.float32),
        quats=jnp.asarray(rng.randn(*params.quats.shape).astype(
            np.float32))))
    cam = build_camera_matrices(np.eye(3), np.zeros(3), 0.01, 100.0, 1.0,
                                1.0)
    kw = dict(width=WIDTH, height=HEIGHT, tan_fovx=tanf,
              tan_fovy=tanf * HEIGHT / WIDTH, sh_degree=3, tile=32,
              max_per_tile=512, max_tiles_per_gaussian=64,
              tiles_per_chunk=2)
    params, live = jax_arrays(state)
    case = dict(params=params, live=live,
                cam=tuple(np.asarray(x) for x in cam),
                gt=rng.rand(3, HEIGHT, WIDTH).astype(np.float32),
                mask=np.ones((HEIGHT, WIDTH), np.float32),
                lrs=toptim.LearningRates.create(*LRS),
                bg=np.zeros(3, np.float32), settings=RenderSettings(**kw),
                program=["step"] * STEPS, **{"lambda": LAMBDA})
    return case, state, JSettings(mode="tiled", **kw)


def test_deal_gaussian_shards_equals_jax():
    """The same permutation of every field and moment, for a live mask
    with gaps, over 4 shards."""
    rng = np.random.RandomState(2)
    cap = 64
    live = rng.rand(cap) < 0.6
    params = {"xyz": rng.randn(cap, 3), "features_dc": rng.randn(cap, 1, 3),
              "features_rest": rng.randn(cap, 15, 3),
              "opacity_logit": rng.randn(cap, 1),
              "log_scales": rng.randn(cap, 3), "quats": rng.randn(cap, 4)}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    stats = dict(max_radii2d=rng.rand(cap).astype(np.float32),
                 xyz_grad_accum=rng.rand(cap).astype(np.float32),
                 denom=rng.rand(cap).astype(np.float32),
                 exist_since_iter=rng.randint(0, 9, cap).astype(np.int32))
    m = {k: rng.randn(*v.shape).astype(np.float32) for k, v in params.items()}
    v = {k: rng.rand(*x.shape).astype(np.float32) for k, x in params.items()}
    j_state = jgm.GaussianState(
        params=jgm.GaussianParams(**{k: jnp.asarray(x)
                                     for k, x in params.items()}),
        live=jnp.asarray(live), **{k: jnp.asarray(x)
                                   for k, x in stats.items()})
    j_opt = joptim.AdamState(
        m=jgm.GaussianParams(**{k: jnp.asarray(x) for k, x in m.items()}),
        v=jgm.GaussianParams(**{k: jnp.asarray(x) for k, x in v.items()}),
        step=jnp.int32(3))
    j_state, j_opt = jsharding.deal_gaussian_shards(j_state, j_opt, 4)
    t_state = tgm.state_from_numpy(params, live, device="cpu", **stats)
    t_opt = toptim.adam_from_numpy(m, v, 3, device="cpu")
    t_state, t_opt = tsharding.deal_gaussian_shards(t_state, t_opt, 4)
    for name in ("live", "max_radii2d", "xyz_grad_accum", "denom",
                 "exist_since_iter"):
        np.testing.assert_array_equal(getattr(t_state, name).numpy(),
                                      np.asarray(getattr(j_state, name)))
    for k in FIELDS:
        for t, j in ((t_state.params, j_state.params), (t_opt.m, j_opt.m),
                     (t_opt.v, j_opt.v)):
            np.testing.assert_array_equal(getattr(t, k).numpy(),
                                          np.asarray(getattr(j, k)))
    assert int(t_opt.step) == 3
    # Live rows spread evenly: 4 blocks of 16 rows each.
    per_block = t_state.live.numpy().reshape(4, 16).sum(1)
    assert per_block.max() - per_block.min() <= 1


def test_deal_refuses_a_capacity_the_shards_do_not_divide():
    state = tgm.empty_state(10, 0, device="cpu")
    with pytest.raises(ValueError, match="capacity 10 over 4"):
        tsharding.deal_gaussian_shards(state, toptim.init_adam(
            state.params), 4)


@pytest.fixture(scope="module")
def gp_runs(scene):
    return {n: spawn(dryrun.gaussian_sharded_rank, n, scene[0])
            for n in RANKS}


def single_process_steps(case, steps):
    state = tgm.state_from_numpy(case["params"], case["live"], device="cpu")
    opt = toptim.init_adam(state.params)
    cam = CameraMatrices(*(torch.from_numpy(np.array(x)) for x in case["cam"]))
    metrics = []
    for _ in range(steps):
        state, opt, m = ttrainer.train_step(
            state, opt, cam, torch.from_numpy(case["gt"]),
            torch.from_numpy(case["mask"]), case["lrs"], torch.zeros(3),
            case["lambda"], case["settings"])
        metrics.append(m)
    return state, opt, metrics


@pytest.mark.parametrize("n", RANKS)
def test_shard_then_gather_is_exact(gp_runs, n):
    for out in gp_runs[n]:
        assert out["shard_gather_exact"]
        assert out["rows"] == 128 // n


@pytest.mark.parametrize("n", RANKS)
def test_gaussian_sharded_step_matches_train_step(scene, gp_runs, n):
    """Two steps on the sharded map against train_step on the whole map:
    loss, counts, parameters, statistics and Adam moments, on every
    rank."""
    case = scene[0]
    state, opt, metrics = single_process_steps(case, STEPS)
    for r, out in enumerate(gp_runs[n]):
        for got, want in zip(out["events"], metrics):
            assert float(got["loss"]) == pytest.approx(float(want["loss"]),
                                                       rel=1e-6, abs=1e-7)
            for k in ("num_visible", "binning_clipped", "binning_overflow"):
                assert int(got[k]) == int(want[k]), k
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
                ("max_radii2d", out["max_radii2d"], state.max_radii2d),
                ("denom", out["denom"], state.denom)]:
            np.testing.assert_allclose(
                got, want.numpy(), atol=1e-6, rtol=1e-5,
                err_msg=f"rank {r} of {n}: {name}")


def assert_updates_close(got, params0, j_params, rows=None):
    for k in FIELDS:
        upd = got["params"][k] - params0[k]
        want = np.asarray(getattr(j_params, k)) - params0[k]
        if rows is not None:
            upd, want = upd[rows], want[rows]
        scale = np.abs(want).max()
        assert scale > 0, k
        np.testing.assert_allclose(upd, want, atol=6e-3 * scale,
                                   err_msg=f"update of {k}")


def test_gaussian_sharded_step_matches_jax_make_gp_mesh_4(scene, gp_runs):
    case, j_state0, jset = scene
    mesh = jsharding.make_gp_mesh(4)
    st, opt = jsharding.shard_gaussian_state(
        mesh, jax.tree.map(jnp.copy, j_state0),
        joptim.init_adam(j_state0.params))
    cam = JCams(*(jnp.asarray(x) for x in case["cam"]))
    got = gp_runs[4][0]
    for step in range(STEPS):
        st, opt, jm = jsharding.train_step_gaussian_sharded(
            st, opt, cam, jnp.asarray(case["gt"]), jnp.asarray(case["mask"]),
            joptim.LearningRates.create(*LRS), jnp.zeros(3),
            jnp.float32(LAMBDA), jset, mesh)
        ev = got["events"][step]
        assert float(ev["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=1e-4)
        for k in ("num_visible", "binning_clipped", "binning_overflow"):
            assert int(ev[k]) == int(jm[k]), k
    assert_updates_close(got, case["params"], st.params)
    np.testing.assert_array_equal(got["max_radii2d"],
                                  np.asarray(st.max_radii2d))
    np.testing.assert_array_equal(got["denom"], np.asarray(st.denom))
    acc = np.asarray(st.xyz_grad_accum)
    np.testing.assert_allclose(got["xyz_grad_accum"], acc,
                               atol=6e-3 * np.abs(acc).max())


def test_densify_scenario_matches_jax(scene):
    """tests/test_sharding.py::test_sharded_densify_and_second_step on 4
    ranks and on make_gp_mesh(4): capacity grown twofold, dealt, a step, a
    shard-local densify (each shard's split draws from fold_in(key,
    shard), as JAX draws them), a step."""
    case, j_state0, jset = scene
    j_state = jgm.grow_capacity(jax.tree.map(jnp.copy, j_state0),
                                2 * j_state0.capacity)
    j_opt = joptim.init_adam(j_state.params)
    j_state, j_opt = jsharding.deal_gaussian_shards(j_state, j_opt, 4)
    cap = j_state.capacity
    per = cap // 4
    key = jax.random.PRNGKey(0)
    # JAX's draws: shard d folds d into the key (sharding.py:505), then
    # splits it for the two children (models/densify.py:158-162).
    draws = []
    for d in range(4):
        k1, k2 = jax.random.split(jax.random.fold_in(key, d))
        draws.append(np.stack([np.asarray(jax.random.normal(k1, (per, 3))),
                               np.asarray(jax.random.normal(k2, (per, 3)))]))
    noise = np.concatenate(draws, axis=1)
    params0, live0 = jax_arrays(j_state)

    mesh = jsharding.make_gp_mesh(4)
    st, opt = jsharding.shard_gaussian_state(mesh, j_state, j_opt)
    cam = JCams(*(jnp.asarray(x) for x in case["cam"]))
    args = (cam, jnp.asarray(case["gt"]), jnp.asarray(case["mask"]),
            joptim.LearningRates.create(*LRS), jnp.zeros(3),
            jnp.float32(LAMBDA), jset, mesh)
    st, opt, jm1 = jsharding.train_step_gaussian_sharded(st, opt, *args)
    st, opt, j_info = jsharding.densify_step_gaussian_sharded(
        st, opt, key, jnp.float32(EXTENT), mesh=mesh, **DENSIFY)
    live_after = np.asarray(st.live)
    assert float(jnp.abs(st.xyz_grad_accum).max()) == 0.0
    st, opt, jm2 = jsharding.train_step_gaussian_sharded(st, opt, *args)

    # The port gets the grown map already dealt (the same rows).
    out = spawn(dryrun.gaussian_sharded_rank, 4, {
        **case, "params": params0, "live": live0, "deal": False,
        "program": ["step", ("densify", noise, EXTENT, DENSIFY), "step"]})
    got = out[0]
    ev1, info, ev2 = got["events"]
    for f in jsharding.dz.DensifyInfo._fields:
        assert int(info[f]) == int(getattr(j_info, f)), f
    assert int(j_info.num_cloned) > 0
    np.testing.assert_array_equal(got["live"], live_after)
    assert live_after.sum() > live0.sum()
    for ev, jm in ((ev1, jm1), (ev2, jm2)):
        assert float(ev["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=1e-4)
        assert np.isfinite(float(ev["loss"]))
        assert int(ev["num_visible"]) == int(jm["num_visible"])
    # The rows live from the start carry the two steps' updates.
    assert_updates_close(got, params0, st.params, rows=live0)
    np.testing.assert_array_equal(got["denom"], np.asarray(st.denom))
    for r in out[1:]:
        np.testing.assert_array_equal(r["live"], got["live"])
