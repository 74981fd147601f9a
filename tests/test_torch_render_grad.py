"""Gradients of the port's render(mode="pallas") against the JAX package:
all six differentiable inputs against JAX mode="pallas" (interpreted) and
mode="tiled" (f32 autodiff), the 2-pass compact continuation against the
1-pass render at a capacity that does not overflow, and the f32
entry-gather transpose against a numpy scatter-add."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photo_slam_tpu.ops.camera_math import build_camera_matrices as jcam
from photo_slam_tpu.ops.render import RenderSettings as JSettings
from photo_slam_tpu.ops.render import render as jrender
from photo_slam_tpu_torch.ops import tiled as ttiled
from photo_slam_tpu_torch.ops.camera_math import build_camera_matrices as tcam
from photo_slam_tpu_torch.ops.render import RenderSettings, render
from test_torch_blend import one_torch_thread  # noqa: F401

W = H = 64   # 2 x 2 tiles of 32 px
FOV = 1.0
NAMES = ("means3d", "scales", "quats", "opacities", "colors",
         "means2d_offset")


def make_scene(n, seed):
    """tests/test_pallas_blend.py::make_scene."""
    rng = np.random.RandomState(seed)
    means = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n),
                      rng.uniform(3, 8, n)], axis=1).astype(np.float32)
    scales = rng.uniform(0.05, 0.2, (n, 3)).astype(np.float32)
    quats = rng.randn(n, 4).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    opac = rng.uniform(0.3, 0.95, n).astype(np.float32)
    colors = rng.uniform(0.05, 0.95, (n, 3)).astype(np.float32)
    return means, scales, quats, opac, colors, np.zeros((n, 2), np.float32)


def settings_kw(max_per_tile=128, passes=1, cap=128, compact=128, width=W):
    """Square pixels at the angular resolution of a 64 px, 1 rad view."""
    return dict(width=width, height=H,
                tan_fovx=float(np.tan(FOV / 2)) * width / W,
                tan_fovy=float(np.tan(FOV / 2)), tile=32,
                max_per_tile=max_per_tile, max_tiles_per_gaussian=16,
                overflow_passes=passes, overflow_capacity=cap,
                overflow_compact=compact)


def torch_grads(inputs, gt, bg, **kw):
    xs = [torch.from_numpy(x).requires_grad_(True) for x in inputs]
    cam = tcam(np.eye(3), np.zeros(3), 0.01, 100.0,
               2 * np.arctan(kw["tan_fovx"]), FOV, device="cpu")
    res = render(xs[0], xs[1], xs[2], xs[3], cam,
                 RenderSettings(mode="pallas", **kw), torch.tensor(bg),
                 colors_precomp=xs[4], means2d_offset=xs[5])
    ((res.image - torch.from_numpy(gt)) ** 2).mean().backward()
    return [x.grad.numpy() for x in xs], res


def jax_grads(inputs, gt, bg, mode, **kw):
    cam = jcam(np.eye(3), np.zeros(3), 0.01, 100.0, FOV, FOV)

    def loss(m, s, q, o, col, off):
        res = jrender(m, s, q, o, cam, JSettings(mode=mode, **kw),
                      jnp.asarray(bg), colors_precomp=col,
                      means2d_offset=off)
        return jnp.mean((res.image - gt) ** 2)

    return jax.grad(loss, argnums=tuple(range(6)))(
        *(jnp.asarray(x) for x in inputs))


def assert_close(got, want, atol):
    for name, a, b in zip(NAMES, got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert np.isfinite(a).all(), name
        assert np.abs(b).max() > 0, f"{name}: zero reference gradient"
        scale = np.abs(b).max()
        np.testing.assert_allclose(a / scale, b / scale, atol=atol,
                                   err_msg=f"gradient of {name}")


@pytest.mark.parametrize("bg", [(0.0, 0.0, 0.0), (1.0, 0.5, 0.2)])
def test_render_grads_match_jax_pallas_and_tiled(bg):
    """Normalized 6e-3 against JAX pallas, whose transpose rounds routed
    rows to bf16 (photo_slam_tpu/ops/tiled.py:139-153); 1e-5 against the
    f32 autodiff of the tiled path, which composites the same entries."""
    inputs = make_scene(60, seed=0)
    gt = np.random.RandomState(7).rand(3, H, W).astype(np.float32)
    bg = np.asarray(bg, np.float32)
    got, _ = torch_grads(inputs, gt, bg, **settings_kw())
    assert_close(got, jax_grads(inputs, gt, bg, "tiled", **settings_kw()),
                 atol=1e-5)
    assert_close(got, jax_grads(inputs, gt, bg, "pallas", **settings_kw()),
                 atol=6e-3)


def test_two_pass_compact_gradients_match_big_capacity():
    """tests/test_pallas_blend.py::test_two_pass_gradients_match_big_capacity
    on the port: the continuation is exact, so the starved 2-pass render's
    gradients (through index_copy of the compact route) match the 1-pass
    render's at a capacity that does not overflow. 4 x 2 tiles, of which
    4 overflow 128 entries."""
    inputs = make_scene(600, seed=3)
    gt = np.random.RandomState(1).rand(3, H, 2 * W).astype(np.float32)
    bg = np.zeros(3, np.float32)
    full, res_full = torch_grads(inputs, gt, bg,
                                 **settings_kw(512, width=2 * W))
    assert int(res_full.num_overflow) == 0
    for compact in (4, 0):   # compact subset route, full-window route
        two, res_two = torch_grads(
            inputs, gt, bg, **settings_kw(128, passes=2, cap=384,
                                          compact=compact, width=2 * W))
        assert int(res_two.num_overflow_tiles) == 4
        assert int(res_two.num_overflow) == 0
        assert_close(two, full, atol=6e-3)


def test_entry_gather_transpose_matches_numpy_scatter_add():
    rng = np.random.RandomState(4)
    n, k_dup, d = 50, 6, 16
    # Entry ids are unique within a table (bin_gaussians emits each
    # (Gaussian, slot) once): a random subset of them at random slots.
    lists = np.full(7 * 40, -1, np.int32)
    lists[rng.choice(7 * 40, 200, replace=False)] = rng.choice(
        n * k_dup, 200, replace=False)
    lists = lists.reshape(7, 40)
    g = rng.randn(7, 40, d).astype(np.float32)
    want = np.zeros((n, d), np.float64)
    for e, row in zip(lists.reshape(-1), g.reshape(-1, d)):
        if e >= 0:
            want[e // k_dup, :ttiled.GRAD_LANES] += row[:ttiled.GRAD_LANES]
    got = ttiled.entry_gather_transpose(torch.from_numpy(g),
                                        torch.from_numpy(lists), k_dup, n)
    assert got.dtype == torch.float32 and got.shape == (n, d)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    # The same rows through autograd of entry_gather.
    feat = torch.zeros((n, d), requires_grad=True)
    rows = ttiled.entry_gather(feat, torch.from_numpy(lists), k_dup)
    rows.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(feat.grad.numpy(), got.numpy())


def test_render_grads_reach_sh_and_live_mask():
    """With shs and a live mask (the trainer's call): finite gradients,
    zero for dead slots, and the SH gradient matches JAX tiled."""
    means, scales, quats, opac, _, _ = make_scene(40, seed=5)
    shs = np.random.RandomState(5).randn(40, 16, 3).astype(np.float32) * 0.3
    live = np.ones(40, bool)
    live[::7] = False
    gt = np.random.RandomState(6).rand(3, H, W).astype(np.float32)
    kw = settings_kw()
    cam_t = tcam(np.eye(3), np.zeros(3), 0.01, 100.0, FOV, FOV, device="cpu")
    t_sh = torch.from_numpy(shs).requires_grad_(True)
    t_m = torch.from_numpy(means).requires_grad_(True)
    res = render(t_m, torch.from_numpy(scales), torch.from_numpy(quats),
                 torch.from_numpy(opac), cam_t,
                 RenderSettings(mode="pallas", sh_degree=3, **kw),
                 torch.zeros(3), shs=t_sh, live_mask=torch.from_numpy(live))
    ((res.image - torch.from_numpy(gt)) ** 2).mean().backward()

    cam_j = jcam(np.eye(3), np.zeros(3), 0.01, 100.0, FOV, FOV)

    def loss(m, sh):
        r = jrender(m, jnp.asarray(scales), jnp.asarray(quats),
                    jnp.asarray(opac), cam_j,
                    JSettings(mode="tiled", sh_degree=3, **kw), jnp.zeros(3),
                    shs=sh, live_mask=jnp.asarray(live))
        return jnp.mean((r.image - gt) ** 2)

    j_m, j_sh = jax.grad(loss, argnums=(0, 1))(jnp.asarray(means),
                                               jnp.asarray(shs))
    for a, b in ((t_m.grad.numpy(), j_m), (t_sh.grad.numpy(), j_sh)):
        b = np.asarray(b)
        assert (a[~live] == 0).all() and np.abs(b).max() > 0
        np.testing.assert_allclose(a / np.abs(b).max(), b / np.abs(b).max(),
                                   atol=1e-5)
