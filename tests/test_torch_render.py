"""The whole serving slice, render(mode="pallas"), against the JAX package
on one map carried across with state_from_numpy: the 1-pass render, the
2-pass overflow continuation on both the compact and the full route, and
mode="dense". JAX runs its Pallas blend interpreted on the CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photo_slam_tpu.models import gaussian_model as jgm
from photo_slam_tpu.ops.camera_math import build_camera_matrices as jcam
from photo_slam_tpu.ops.render import RenderSettings as JSettings
from photo_slam_tpu.ops.render import render as jrender
from photo_slam_tpu_torch.models import gaussian_model as tgm
from photo_slam_tpu_torch.ops.camera_math import build_camera_matrices as tcam
from photo_slam_tpu_torch.ops.losses import l1_loss, psnr
from photo_slam_tpu_torch.ops.render import RenderSettings, render

W, H = 128, 96   # 4 x 3 tiles of 32 px
FOVX = 1.0


def random_map(n=900, cap=1024, seed=0):
    """Raw parameter arrays of an SH-3 map, denser in the left half of the
    view so that some tiles overflow a small per-tile capacity."""
    rng = np.random.RandomState(seed)
    xyz = np.zeros((cap, 3), np.float32)
    x = np.where(rng.rand(n) < 0.7, rng.uniform(-2.2, 0.0, n),
                 rng.uniform(-2.2, 2.2, n))
    xyz[:n] = np.stack([x, rng.uniform(-1.6, 1.6, n),
                        rng.uniform(3.0, 8.0, n)], 1)
    quats = rng.randn(cap, 4).astype(np.float32)
    params = dict(
        xyz=xyz,
        features_dc=rng.randn(cap, 1, 3).astype(np.float32) * 0.8,
        features_rest=rng.randn(cap, 15, 3).astype(np.float32) * 0.15,
        opacity_logit=rng.randn(cap, 1).astype(np.float32) * 1.5,
        log_scales=np.log(rng.uniform(0.04, 0.2, (cap, 3))).astype(np.float32),
        quats=quats,
    )
    live = np.zeros(cap, bool)
    live[:n] = True
    live[rng.rand(cap) < 0.05] = False
    return params, live


def render_both(params, live, **overrides):
    kw = dict(width=W, height=H, tan_fovx=float(np.tan(FOVX / 2)),
              tan_fovy=float(np.tan(FOVX / 2) * H / W), sh_degree=3,
              mode="pallas", max_tiles_per_gaussian=8, max_per_tile=128)
    kw.update(overrides)
    R, t = np.eye(3), np.array([0.1, -0.05, 0.0])
    fovy = 2 * np.arctan(np.tan(FOVX / 2) * H / W)

    jp = jgm.GaussianParams(**{k: jnp.asarray(v) for k, v in params.items()})
    js, jq, jo = jgm.activated(jp)
    jres = jrender(jp.xyz, js, jq, jo,
                   jcam(R, t, 0.01, 100.0, FOVX, fovy), JSettings(**kw),
                   jnp.array([0.1, 0.2, 0.3]), shs=jgm.sh_features(jp),
                   live_mask=jnp.asarray(live))

    state = tgm.state_from_numpy(params, live, device="cpu")
    ts, tq, to = tgm.activated(state.params)
    tres = render(state.params.xyz, ts, tq, to,
                  tcam(R, t, 0.01, 100.0, FOVX, fovy, device="cpu"),
                  RenderSettings(**kw), torch.tensor([0.1, 0.2, 0.3]),
                  shs=tgm.sh_features(state.params), live_mask=state.live)
    return tres, jres


def assert_same_render(tres, jres):
    assert tres.image.shape == (3, H, W)
    np.testing.assert_allclose(tres.image.numpy(), np.asarray(jres.image),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(tres.final_T.numpy(), np.asarray(jres.final_T),
                               atol=1e-4, rtol=0)
    np.testing.assert_array_equal(tres.radii.numpy(), np.asarray(jres.radii))
    np.testing.assert_array_equal(tres.visible.numpy(),
                                  np.asarray(jres.visible))
    for f in ("num_clipped", "num_overflow", "num_overflow_tiles",
              "max_tile_depth"):
        assert int(getattr(tres, f)) == int(getattr(jres, f)), f


@pytest.fixture(scope="module")
def scene():
    return random_map()


def test_one_pass_matches_jax(scene):
    tres, jres = render_both(*scene)
    assert_same_render(tres, jres)
    # The capacity binds: this is the overflowing 1-pass render.
    assert 0 < int(jres.num_overflow_tiles) < 12
    assert int(jres.num_overflow) > 0


@pytest.mark.parametrize("route", ["compact", "full"])
def test_two_pass_continuation_matches_jax(scene, route):
    one, _ = render_both(*scene)
    over_tiles = int(one.num_overflow_tiles)
    # Compact: cover every overflowed tile (argsort ties may pick other
    # tiles otherwise); the subset is still smaller than the grid.
    compact = over_tiles if route == "compact" else 0
    tres, jres = render_both(*scene, overflow_passes=2,
                             overflow_capacity=128, overflow_compact=compact)
    assert_same_render(tres, jres)
    assert int(tres.num_overflow) < int(one.num_overflow)
    # The continuation changes the image where tiles overflowed.
    assert float((tres.image - one.image).abs().max()) > 1e-3


def test_dense_matches_jax(scene):
    params, live = scene
    live = live.copy()
    live[300:] = False   # the O(N*H*W) oracle at a few hundred Gaussians
    tres, jres = render_both(params, live, mode="dense")
    assert_same_render(tres, jres)


def test_losses(scene):
    tres, jres = render_both(*scene)
    gt = torch.from_numpy(np.random.RandomState(1).rand(3, H, W)
                          .astype(np.float32))
    from photo_slam_tpu.ops import losses as jl
    np.testing.assert_allclose(float(l1_loss(tres.image, gt)),
                               float(jl.l1_loss(jres.image, gt.numpy())),
                               rtol=1e-5)
    np.testing.assert_allclose(float(psnr(tres.image, gt)),
                               float(jl.psnr(jres.image, gt.numpy())),
                               rtol=1e-5)
