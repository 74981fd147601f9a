"""The rest of the port's compiled dispatch on the CPU, where the graph
cache calls each function directly (mapper/trainer.StepGraphs): densify
and the opacity reset written in place into the map (bit-equal to the
functional forms, and against JAX's jitted densify_step and
opacity_reset_step with JAX's split draws injected), the two map
transforms with their scalars as 0-d tensors through one StepGraphs
(against JAX's jitted ones), the graph keys (the thresholds, not the
extent), and the helper that picks the multi-process route (gloo refused
on a card, run op by op on the CPU)."""
import datetime

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from photo_slam_tpu.mapper import trainer as jtrainer
from photo_slam_tpu.models import gaussian_model as jgm
from photo_slam_tpu.models import optimizer as joptim
from photo_slam_tpu.models import transforms as jxf
from photo_slam_tpu_torch.mapper import trainer as ttrainer
from photo_slam_tpu_torch.models import densify as tdz
from photo_slam_tpu_torch.models import gaussian_model as tgm
from photo_slam_tpu_torch.models import optimizer as toptim
from photo_slam_tpu_torch.ops.camera_math import CameraMatrices
from photo_slam_tpu_torch.ops.render import RenderSettings
from photo_slam_tpu_torch.parallel import launch, sharding
from photo_slam_tpu_torch.utils import graphs
from test_torch_blend import one_torch_thread  # noqa: F401
from test_torch_mapper import (both_states, random_rotation, seeded_state,
                               view_of)
from test_torch_mapper import assert_maps_close as assert_transform_close
from test_torch_optim import (FIELDS, assert_adam_equal, assert_state_equal,
                              jax_state, random_moments, random_state,
                              torch_state)

THRESHOLDS = dict(grad_threshold=2e-4, min_opacity=0.005)


def densify_case(case):
    """test_torch_optim.py::test_densify_and_prune_matches_jax's case:
    (params, live, stats, m, v, max_screen_size, extent, percent_dense)."""
    n_live = {"ample": 120, "scarce": 250, "screen": 150,
              "nonfinite": 120}[case]
    params, live, stats = random_state(n_live=n_live, seed=8)
    if case == "nonfinite":
        params["xyz"][np.flatnonzero(live)[:3]] = np.nan
    m, v = random_moments(params, 9)
    extent, pdense = (4.0, 0.05) if case == "screen" else (3.0, 0.1)
    return (params, live, stats, m, v, 20 if case == "screen" else 0,
            extent, pdense)


def jax_adam(m, v, step):
    return joptim.AdamState(
        m=jgm.GaussianParams(**{k: jnp.asarray(m[k]) for k in FIELDS}),
        v=jgm.GaussianParams(**{k: jnp.asarray(v[k]) for k in FIELDS}),
        step=jnp.int32(step))


def all_tensors(state, opt):
    return ttrainer._tensors(state, opt)


def bits(x):
    """x's bytes (NaN rows compare equal when their bits are)."""
    return x.reshape(-1).view(torch.uint8) if x.is_floating_point() else x


def assert_bit_equal(a, b):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype and x.shape == y.shape, i
        assert torch.equal(bits(x), bits(y)), i


@pytest.mark.parametrize("case", ["ample", "scarce", "screen", "nonfinite"])
def test_inplace_densify_matches_functional_and_jax(case):
    """densify_step_ (the form StepGraphs.densify_step captures) writes,
    into the tensors it is given, bit for bit what the functional
    densify_step returns, and StepGraphs.densify_step's plain route does
    the same; all against JAX's jitted densify_step (extent traced, the
    thresholds static) with JAX's own split draws injected."""
    params, live, stats, m, v, screen, extent, pdense = densify_case(case)
    static = dict(max_screen_size=screen, percent_dense=pdense,
                  **THRESHOLDS)
    key = jax.random.PRNGKey(11)
    j_state, j_opt, j_info = jtrainer.densify_step(
        jax_state(params, live, stats), jax_adam(m, v, 4), key,
        jnp.float32(extent), **static)
    k1, k2 = jax.random.split(key)
    cap = len(live)
    noise = torch.from_numpy(np.stack([
        np.asarray(jax.random.normal(k1, (cap, 3))),
        np.asarray(jax.random.normal(k2, (cap, 3)))]))
    ext = torch.tensor(extent, dtype=torch.float32)

    def start():
        return (torch_state(params, live, stats),
                toptim.adam_from_numpy(m, v, 4, device="cpu"))

    f_state, f_opt, f_info = ttrainer.densify_step(*start(), noise, ext,
                                                   **static)
    st, op = start()
    ptrs = [x.data_ptr() for x in all_tensors(st, op)]
    info = ttrainer.densify_step_(st, op, noise, ext, **static)
    assert [x.data_ptr() for x in all_tensors(st, op)] == ptrs
    assert_bit_equal(all_tensors(st, op), all_tensors(f_state, f_opt))
    sg = ttrainer.StepGraphs()
    noise_in = sg.split_noise(cap, "cpu")
    noise_in.copy_(noise)
    g_state, g_opt, g_info = sg.densify_step(*start(), noise_in, extent,
                                             **static)
    assert_bit_equal(all_tensors(g_state, g_opt), all_tensors(st, op))
    for f in tdz.DensifyInfo._fields:
        want = int(getattr(j_info, f))
        assert int(getattr(info, f)) == int(getattr(f_info, f)) == want, f
        assert int(getattr(g_info, f)) == want, f
    assert int(j_info.num_cloned) > 0 and int(j_info.num_split) > 0
    assert_state_equal(st, j_state)
    assert_adam_equal(op, j_opt, rtol=0)


def test_inplace_reset_matches_jax():
    """opacity_reset_step_ and StepGraphs.opacity_reset_step write JAX's
    jitted opacity_reset_step into the tensors they are given."""
    params, live, stats = random_state(cap=64, n_live=40, seed=14)
    m, v = random_moments(params, 15)
    j_state, j_opt = jtrainer.opacity_reset_step(
        jax_state(params, live, stats), jax_adam(m, v, 2))

    def start():
        return (torch_state(params, live, stats),
                toptim.adam_from_numpy(m, v, 2, device="cpu"))

    st, op = start()
    logit = st.params.opacity_logit
    ttrainer.opacity_reset_step_(st, op)
    assert st.params.opacity_logit is logit
    assert_bit_equal(all_tensors(st, op),
                     all_tensors(*ttrainer.opacity_reset_step(*start())))
    g_state, g_opt = ttrainer.StepGraphs().opacity_reset_step(*start())
    assert_bit_equal(all_tensors(g_state, g_opt), all_tensors(st, op))
    assert_state_equal(st, j_state)
    assert_adam_equal(op, j_opt, rtol=0)


def test_transforms_through_one_stepgraphs_match_jax():
    """Two scale refinements with other s and T, then a loop closure over
    two keyframes sharing one not_transformed mask, through one
    StepGraphs with every scalar a 0-d tensor, against JAX's jitted
    transforms applied in the same order."""
    params, live, exist, m, v = seeded_state(seed=5)
    (ts, to), (js, jo) = both_states(params, live, exist, m, v)
    rng = np.random.RandomState(6)
    sg = ttrainer.StepGraphs()
    for s in (1.7, 0.8):
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = random_rotation(rng)
        T[:3, 3] = rng.randn(3) * 0.2
        ts, to = sg.apply_scaled_transformation(
            ts, to, torch.from_numpy(T), torch.tensor(s))
        js, jo = jxf.apply_scaled_transformation(js, jo, jnp.asarray(T),
                                                 jnp.float32(s))
        assert_transform_close(ts, to, js, jo)
    nt = sg.transform_mask(ts.capacity, "cpu")
    j_nt = jnp.ones(ts.capacity, bool)
    moved = 0
    for k, (it, scale) in enumerate(((2, 1.1), (4, 0.9))):
        diff = np.eye(4, dtype=np.float32)
        diff[:3, :3] = random_rotation(rng)
        diff[:3, 3] = rng.randn(3) * 0.2
        tm, jm = view_of(np.eye(3), np.array([0.1 * k, 0.0, 0.0]))
        ts, to, nt, num = sg.scaled_transform_visible_points_of_keyframe(
            ts, to, nt, torch.from_numpy(diff), tm.viewmatrix, tm.full_proj,
            torch.tensor(it, dtype=torch.int32),
            torch.tensor(3, dtype=torch.int32), torch.tensor(scale))
        js, jo, j_nt, j_num = \
            jxf.scaled_transform_visible_points_of_keyframe(
                js, jo, j_nt, jnp.asarray(diff), jm.viewmatrix,
                jm.full_proj, jnp.int32(it), jnp.int32(3),
                jnp.float32(scale))
        assert_transform_close(ts, to, js, jo)
        np.testing.assert_array_equal(nt.numpy(), np.asarray(j_nt))
        assert int(num) == int(j_num)
        moved += int(num)
    # Dead rows leave the mask too (it is and-ed with the live mask).
    assert moved > 0 and int((~nt.numpy() & live).sum()) == moved


class KeyRecorder:
    """A GraphCache.run that records each call's entry key and its fresh
    inputs, then calls the function (the CPU's direct route)."""

    def __init__(self):
        self.calls = []

    def __call__(self, key, fn, fresh, resident=(), clone=False, replays=1):
        self.calls.append((graphs.GraphCache.key_of(key, fresh, resident),
                           [x.clone() for x in fresh]))
        return tuple(fn(*fresh, *resident))


def test_graph_keys_hold_the_thresholds_not_the_extent(monkeypatch):
    """Densify's graph key holds its four thresholds (JAX's static
    arguments) and not the extent, which is a 0-d input; the transforms'
    keys hold none of their scalars, so one graph serves every keyframe
    and every scale refinement."""
    rec = KeyRecorder()
    sg = ttrainer.StepGraphs()
    monkeypatch.setattr(sg.cache, "run", rec)
    params, live, stats = random_state(cap=64, n_live=40, seed=3)
    state = torch_state(params, live, stats)
    opt = toptim.init_adam(state.params)
    noise = torch.zeros((2, 64, 3))
    for extent, screen in ((3.0, 0), (5.0, 0), (3.0, 20)):
        state, opt, _ = sg.densify_step(state, opt, noise, extent,
                                        max_screen_size=screen,
                                        percent_dense=0.01, **THRESHOLDS)
    sg.opacity_reset_step(state, opt)
    for s in (1.1, 0.9):
        sg.apply_scaled_transformation(state, opt, torch.eye(4), s)
    nt = sg.transform_mask(64, "cpu")
    for it, scale in ((1, 1.0), (7, 1.2)):
        sg.scaled_transform_visible_points_of_keyframe(
            state, opt, nt, torch.eye(4), torch.eye(4), torch.eye(4), it, 2,
            scale)
    keys = [k for k, _ in rec.calls]
    densify = keys[:3]
    assert densify[0] == densify[1] != densify[2]
    assert densify[0][0] == ("densify_step", ("grad_threshold", 2e-4),
                             ("min_opacity", 0.005), ("max_screen_size", 0),
                             ("percent_dense", 0.01))
    assert dict(densify[2][0][1:])["max_screen_size"] == 20
    assert [float(f[1]) for _, f in rec.calls[:3]] == [3.0, 5.0, 3.0]
    assert all(f[1].shape == () and f[1].dtype == torch.float32
               for _, f in rec.calls[:3])
    assert keys[3][0] == ("opacity_reset_step",)
    assert keys[4] == keys[5] and keys[6] == keys[7]
    assert [float(f[1]) for _, f in rec.calls[4:6]] == pytest.approx(
        [1.1, 0.9])
    assert [int(f[3]) for _, f in rec.calls[6:8]] == [1, 7]
    assert [float(f[5]) for _, f in rec.calls[6:8]] == pytest.approx(
        [1.0, 1.2])
    assert len(set(keys)) == 5


@pytest.fixture(scope="module")
def gloo_group():
    """A one-rank gloo group in this process (the default group)."""
    if dist.is_initialized():
        pytest.fail("a default process group is already initialized")
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{launch.free_port()}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def test_sharded_route_refuses_gloo_on_a_card_and_runs_it_on_the_cpu(
        gloo_group):
    """graph_route: a gloo group on a card raises and names the backend
    (nothing runs op by op in a graph's place); on the CPU the route is
    op by op, and StepGraphs' multi-process methods then equal the
    functions of parallel/sharding called by name."""
    group = gloo_group
    for dev in (torch.device("cuda", 0), "cuda"):
        with pytest.raises(ValueError, match="gloo"):
            sharding.graph_route(group, dev)
        with pytest.raises(ValueError, match="gloo"):
            ttrainer.StepGraphs()._graphed(torch.device(dev), group)
    assert sharding.graph_route(group, "cpu") is False
    assert sharding.group_key(group) == (1, 0, "gloo")
    assert sharding.group_key(None) == ()

    rng = np.random.RandomState(0)
    n, w, h = 32, 32, 32
    state = tgm.create_from_pcd(
        rng.randn(n, 3).astype(np.float32) * 0.5 + [0, 0, 4],
        rng.rand(n, 3).astype(np.float32), sh_degree=0, capacity=n,
        device="cpu")
    settings = RenderSettings(width=w, height=h, tan_fovx=0.5, tan_fovy=0.5,
                              sh_degree=0, mode="pallas",
                              max_tiles_per_gaussian=4, max_per_tile=64)
    cam = CameraMatrices(*(torch.stack([x]) for x in view_of(
        np.eye(3), np.zeros(3))[0]))
    gt = torch.rand((1, 3, h, w), generator=torch.Generator().manual_seed(1))
    mask = torch.ones((1, h, w))
    bg = torch.zeros(3)
    lrs = toptim.LearningRates.create(1.6e-4, 2.5e-3, 0.05, 5e-3, 1e-3)
    sg = ttrainer.StepGraphs()

    def start():
        st = tgm.clone_state(state)
        return st, toptim.init_adam(st.params)

    a = sg.train_step_batched(*start(), cam, gt, mask, lrs, bg, 0.2,
                              settings, group=group)
    b = sharding.train_step_batched(*start(), cam, gt, mask, lrs, bg, 0.2,
                                    settings, group=group)
    assert_bit_equal([*all_tensors(a[0], a[1]), a[2]["loss"]],
                     [*all_tensors(b[0], b[1]), b[2]["loss"]])
    one = CameraMatrices(*(x[0] for x in cam))
    a = sg.train_step_gaussian_sharded(*start(), one, gt[0], mask[0], lrs,
                                       bg, 0.2, settings, group)
    b = sharding.train_step_gaussian_sharded(*start(), one, gt[0], mask[0],
                                             lrs, bg, 0.2, settings, group)
    assert_bit_equal([*all_tensors(a[0], a[1]), a[2]["loss"]],
                     [*all_tensors(b[0], b[1]), b[2]["loss"]])
    noise = torch.randn((2, n, 3), generator=torch.Generator().manual_seed(2))
    kw = dict(max_screen_size=0, percent_dense=0.01, group=group,
              grad_threshold=0.0, min_opacity=0.005)
    a = sg.densify_step_gaussian_sharded(*start(), noise, 3.0, **kw)
    b = sharding.densify_step_gaussian_sharded(*start(), noise, 3.0, **kw)
    assert_bit_equal(all_tensors(a[0], a[1]), all_tensors(b[0], b[1]))
    assert [int(x) for x in a[2]] == [int(x) for x in b[2]]
    sc, qu, op = tgm.activated(state.params)
    args = (state.params.xyz, sc, qu, op, one, settings, bg)
    kw = dict(shs=tgm.sh_features(state.params), live_mask=state.live)
    got = sg.render_image_sharded(group, *args, **kw)
    with torch.no_grad():
        want = sharding.render_image_sharded(group, *args, **kw)
    assert torch.equal(got, want) and got.shape == (3, h, w)
    assert sg.captures == 0
