"""The port's map surgery and optimizer against the JAX package on identical
numpy inputs: masked Adam and the moment surgery, the LR schedule, the
densification statistics, densify_and_prune (JAX's own split normals
injected: clone, split, prune, budget and drop), reset_opacity,
insert_points and grow_capacity. Masks, counts and slots exact; values
1e-6 relative."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photo_slam_tpu.models import densify as jdz
from photo_slam_tpu.models import gaussian_model as jgm
from photo_slam_tpu.models import optimizer as joptim
from photo_slam_tpu_torch.models import densify as tdz
from photo_slam_tpu_torch.models import gaussian_model as tgm
from photo_slam_tpu_torch.models import optimizer as toptim
from test_torch_blend import one_torch_thread  # noqa: F401

FIELDS = jgm.GaussianParams._fields
STATS = ("max_radii2d", "xyz_grad_accum", "denom", "exist_since_iter")


def random_state(cap=256, n_live=200, seed=0):
    """numpy arrays of a map state: parameters, live mask and statistics,
    with a spread of opacities, sizes and accumulated gradients that makes
    some slots clone, some split and some prune."""
    rng = np.random.RandomState(seed)
    params = dict(
        xyz=rng.randn(cap, 3).astype(np.float32) * 2,
        features_dc=rng.randn(cap, 1, 3).astype(np.float32),
        features_rest=rng.randn(cap, 3, 3).astype(np.float32) * 0.1,
        opacity_logit=rng.randn(cap, 1).astype(np.float32) * 3,
        log_scales=np.log(rng.uniform(0.005, 0.5, (cap, 3))).astype(
            np.float32),
        quats=rng.randn(cap, 4).astype(np.float32),
    )
    live = np.zeros(cap, bool)
    live[rng.permutation(cap)[:n_live]] = True
    stats = dict(
        max_radii2d=rng.uniform(0, 40, cap).astype(np.float32),
        xyz_grad_accum=(rng.rand(cap) * 4e-3 * live).astype(np.float32),
        denom=(rng.randint(0, 5, cap) * live).astype(np.float32),
        exist_since_iter=rng.randint(0, 100, cap).astype(np.int32),
    )
    return params, live, stats


def random_moments(params, seed):
    rng = np.random.RandomState(seed)
    m = {k: rng.randn(*v.shape).astype(np.float32) * 1e-3
         for k, v in params.items()}
    v = {k: rng.rand(*v.shape).astype(np.float32) * 1e-6
         for k, v in params.items()}
    return m, v


def jax_state(params, live, stats):
    return jgm.GaussianState(
        params=jgm.GaussianParams(**{k: jnp.asarray(params[k])
                                     for k in FIELDS}),
        live=jnp.asarray(live), **{k: jnp.asarray(stats[k]) for k in STATS})


def torch_state(params, live, stats):
    return tgm.state_from_numpy(params, live, device="cpu", **stats)


def assert_state_equal(t, j, rtol=1e-6):
    np.testing.assert_array_equal(t.live.numpy(), np.asarray(j.live))
    np.testing.assert_array_equal(t.exist_since_iter.numpy(),
                                  np.asarray(j.exist_since_iter))
    for k in FIELDS:
        np.testing.assert_allclose(getattr(t.params, k).numpy(),
                                   np.asarray(getattr(j.params, k)),
                                   rtol=rtol, atol=1e-7, err_msg=k)
    for k in ("max_radii2d", "xyz_grad_accum", "denom"):
        np.testing.assert_allclose(getattr(t, k).numpy(),
                                   np.asarray(getattr(j, k)), rtol=rtol,
                                   atol=1e-12, err_msg=k)


def assert_adam_equal(t, j, rtol=1e-6):
    assert int(t.step) == int(j.step)
    for tm, jm in ((t.m, j.m), (t.v, j.v)):
        for k in FIELDS:
            np.testing.assert_allclose(getattr(tm, k).numpy(),
                                       np.asarray(getattr(jm, k)),
                                       rtol=rtol, atol=1e-12, err_msg=k)


def test_adam_step_matches_jax():
    params, live, _ = random_state(seed=1)
    m, v = random_moments(params, 2)
    rng = np.random.RandomState(3)
    grads = {k: rng.randn(*x.shape).astype(np.float32) * 1e-2
             for k, x in params.items()}
    grads["xyz"][~live] = np.nan   # dead slots are frozen, NaN included
    j_lrs = joptim.LearningRates.create(1.6e-4, 2.5e-3, 0.05, 5e-3, 1e-3)
    t_lrs = toptim.LearningRates.create(1.6e-4, 2.5e-3, 0.05, 5e-3, 1e-3)
    for name in FIELDS:
        assert getattr(t_lrs, name) == pytest.approx(
            float(getattr(j_lrs, name)), rel=1e-7)

    jp, jopt = joptim.adam_step(
        jgm.GaussianParams(**{k: jnp.asarray(params[k]) for k in FIELDS}),
        jgm.GaussianParams(**{k: jnp.asarray(grads[k]) for k in FIELDS}),
        joptim.AdamState(
            m=jgm.GaussianParams(**{k: jnp.asarray(m[k]) for k in FIELDS}),
            v=jgm.GaussianParams(**{k: jnp.asarray(v[k]) for k in FIELDS}),
            step=jnp.int32(6)),
        j_lrs, jnp.asarray(live))
    tp = tgm.GaussianParams(**{k: torch.from_numpy(params[k].copy())
                               for k in FIELDS})
    topt = toptim.adam_from_numpy(m, v, 6, device="cpu")
    tp2, topt2 = toptim.adam_step(
        tp, tgm.GaussianParams(**{k: torch.from_numpy(grads[k])
                                  for k in FIELDS}), topt, t_lrs,
        torch.from_numpy(live))
    assert tp2.xyz is tp.xyz and topt2.m.xyz is topt.m.xyz   # in place
    for k in FIELDS:
        np.testing.assert_allclose(getattr(tp2, k).numpy(),
                                   np.asarray(getattr(jp, k)), rtol=1e-6,
                                   atol=1e-9, err_msg=k)
    assert_adam_equal(topt2, jopt)


def test_moment_surgery_matches_jax():
    params, live, _ = random_state(seed=4)
    m, v = random_moments(params, 5)
    jopt = joptim.AdamState(
        m=jgm.GaussianParams(**{k: jnp.asarray(m[k]) for k in FIELDS}),
        v=jgm.GaussianParams(**{k: jnp.asarray(v[k]) for k in FIELDS}),
        step=jnp.int32(3))
    topt = toptim.adam_from_numpy(m, v, 3, device="cpu")
    slots = np.array([5, 17, 0, 0, 250], np.int32)
    mask = np.array([True, True, False, False, True])
    assert_adam_equal(
        toptim.zero_moments_at(topt, torch.from_numpy(slots),
                               torch.from_numpy(mask)),
        joptim.zero_moments_at(jopt, jnp.asarray(slots), jnp.asarray(mask)),
        rtol=0)
    for group in (None, "opacity_logit"):
        assert_adam_equal(
            toptim.zero_moments_where(topt, torch.from_numpy(live), group),
            joptim.zero_moments_where(jopt, jnp.asarray(live), group),
            rtol=0)


@pytest.mark.parametrize("kw", [
    dict(lr_init=1.6e-4, lr_final=1.6e-6, max_steps=30000),
    dict(lr_init=1.6e-4, lr_final=1.6e-6, lr_delay_steps=500,
         lr_delay_mult=0.01, max_steps=3000),
    dict(lr_init=0.0, lr_final=0.0),
])
def test_expon_lr_matches_jax(kw):
    for step in (0, 1, 250, 2999, 10**6, -1):
        assert toptim.expon_lr(step, **kw) == pytest.approx(
            float(joptim.expon_lr(step, **kw)), rel=1e-6, abs=1e-12)


def test_densification_stats_match_jax():
    params, live, stats = random_state(seed=6)
    rng = np.random.RandomState(7)
    g2d = rng.randn(len(live), 2).astype(np.float32) * 1e-4
    radii = rng.randint(0, 60, len(live)).astype(np.int32)
    visible = live & (radii > 0)
    j = jdz.add_densification_stats(jax_state(params, live, stats),
                                    jnp.asarray(g2d), jnp.asarray(visible),
                                    96, 64)
    j = jdz.update_max_radii(j, jnp.asarray(radii), jnp.asarray(visible))
    t = tdz.add_densification_stats(torch_state(params, live, stats),
                                    torch.from_numpy(g2d),
                                    torch.from_numpy(visible), 96, 64)
    t = tdz.update_max_radii(t, torch.from_numpy(radii),
                             torch.from_numpy(visible))
    assert_state_equal(t, j)


@pytest.mark.parametrize("case", ["ample", "scarce", "screen", "nonfinite"])
def test_densify_and_prune_matches_jax(case):
    n_live = {"ample": 120, "scarce": 250, "screen": 150,
              "nonfinite": 120}[case]
    params, live, stats = random_state(n_live=n_live, seed=8)
    if case == "nonfinite":
        params["xyz"][np.flatnonzero(live)[:3]] = np.nan
    m, v = random_moments(params, 9)
    max_screen = 20 if case == "screen" else 0
    # The world-size prune (0.1 extent) must leave some splits (max scale
    # above percent_dense * extent).
    extent, pdense = (4.0, 0.05) if case == "screen" else (3.0, 0.1)
    key = jax.random.PRNGKey(11)
    j_state, j_opt, j_info = jdz.densify_and_prune(
        jax_state(params, live, stats),
        joptim.AdamState(
            m=jgm.GaussianParams(**{k: jnp.asarray(m[k]) for k in FIELDS}),
            v=jgm.GaussianParams(**{k: jnp.asarray(v[k]) for k in FIELDS}),
            step=jnp.int32(4)),
        key, 2e-4, 0.005, extent, max_screen, pdense)
    # JAX's own split draws (densify.py:158-163).
    k1, k2 = jax.random.split(key)
    cap = len(live)
    noise = np.stack([np.asarray(jax.random.normal(k1, (cap, 3))),
                      np.asarray(jax.random.normal(k2, (cap, 3)))])
    t_state, t_opt, t_info = tdz.densify_and_prune(
        torch_state(params, live, stats),
        toptim.adam_from_numpy(m, v, 4, device="cpu"),
        torch.from_numpy(noise), 2e-4, 0.005, extent, max_screen,
        pdense)
    for f in tdz.DensifyInfo._fields:
        assert int(getattr(t_info, f)) == int(getattr(j_info, f)), f
    assert int(j_info.num_cloned) > 0 and int(j_info.num_split) > 0
    assert int(j_info.num_pruned) > 0
    if case == "scarce":
        # The budget binds: fewer approved than want to densify.
        hot = (stats["xyz_grad_accum"] / np.maximum(stats["denom"], 1)
               >= 2e-4) & live
        assert int(j_info.num_cloned) + int(j_info.num_split) < hot.sum()
    assert_state_equal(t_state, j_state)
    assert_adam_equal(t_opt, j_opt, rtol=0)


def test_insert_points_drops_overflow_like_jax():
    params, live, stats = random_state(cap=64, n_live=50, seed=12)
    rng = np.random.RandomState(13)
    pts = rng.randn(20, 3).astype(np.float32)
    cols = rng.rand(20, 3).astype(np.float32)
    valid = np.ones(20, bool)
    valid[[3, 8]] = False
    j_state, j_dst = jgm.insert_points(
        jax_state(params, live, stats), jnp.asarray(pts), jnp.asarray(cols),
        jnp.asarray(valid), jnp.int32(42))
    t_state, t_dst = tgm.insert_points(
        torch_state(params, live, stats), torch.from_numpy(pts),
        torch.from_numpy(cols), torch.from_numpy(valid), 42)
    np.testing.assert_array_equal(t_dst.numpy(), np.asarray(j_dst))
    # 14 dead slots, 18 valid candidates: 4 dropped.
    assert (t_dst.numpy() >= 0).sum() == 14
    assert_state_equal(t_state, j_state)
    assert tgm.num_live(t_state).item() == 64


def test_grow_capacity_and_reset_opacity_match_jax():
    params, live, stats = random_state(cap=64, n_live=40, seed=14)
    m, v = random_moments(params, 15)
    j_grown = jgm.grow_capacity(jax_state(params, live, stats), 128)
    t_grown = tgm.grow_capacity(torch_state(params, live, stats), 128)
    assert t_grown.capacity == 128
    assert_state_equal(t_grown, j_grown, rtol=0)
    j_state, j_opt = jdz.reset_opacity(
        jax_state(params, live, stats),
        joptim.AdamState(
            m=jgm.GaussianParams(**{k: jnp.asarray(m[k]) for k in FIELDS}),
            v=jgm.GaussianParams(**{k: jnp.asarray(v[k]) for k in FIELDS}),
            step=jnp.int32(2)))
    t_state, t_opt = tdz.reset_opacity(
        torch_state(params, live, stats),
        toptim.adam_from_numpy(m, v, 2, device="cpu"))
    assert_state_equal(t_state, j_state)
    assert_adam_equal(t_opt, j_opt, rtol=0)
