"""K2's plain version (photo_slam_tpu_torch/ops/blend.py::blend_bwd_plain)
and the differentiable pallas_blend against the JAX package's blend
backward, run interpreted on the CPU, on identical packed tiles."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photo_slam_tpu.ops.pallas.blend import _blend_bwd_call
from photo_slam_tpu.ops.pallas.blend import pallas_blend as jblend
from photo_slam_tpu_torch.ops import blend as tblend
from test_torch_blend import one_torch_thread, packed_tiles  # noqa: F401


def cotangents(num_tiles, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(num_tiles, 3, 8, 128).astype(np.float32),
            rng.randn(num_tiles, 8, 128).astype(np.float32))


def counts_eff(counts, n_contrib):
    nc_max = np.asarray(n_contrib).reshape(len(counts), -1).max(-1)
    return np.minimum(counts, nc_max).astype(np.int32)


def assert_rows_match(t_d, j_d, ce):
    """Per lane, normalized by the lane's largest value: 1e-4 (the pixel
    sums run in another order, and JAX rebuilds T from group suffix
    products). Rows >= counts_eff and lanes 9-15 exact zeros."""
    t_d, j_d = np.asarray(t_d), np.asarray(j_d)
    for lane in range(9):
        scale = np.abs(j_d[..., lane]).max() + 1e-12
        np.testing.assert_allclose(t_d[..., lane] / scale,
                                   j_d[..., lane] / scale, atol=1e-4,
                                   err_msg=f"lane {lane}")
        assert np.abs(j_d[..., lane]).max() > 0, f"lane {lane} all zero"
    assert (t_d[..., 9:] == 0).all()
    rows = np.arange(t_d.shape[1])[None, :] >= ce[:, None]
    assert (t_d[rows] == 0).all()


@pytest.mark.parametrize("with_ids", [False, True])
def test_plain_backward_matches_jax_kernel(with_ids):
    tiles_x, grid_tiles, k = 3, 6, 128
    data, counts = packed_tiles(grid_tiles, k, tiles_x, seed=5)
    ids = np.array([4, 1, 5, 0], np.int32) if with_ids else None
    if with_ids:
        data, counts = data[ids], counts[ids]
    nb = data.shape[0]
    j_ids = None if ids is None else jnp.asarray(ids)
    _, final_t, n_contrib = jblend(jnp.asarray(data), jnp.asarray(counts),
                                   tiles_x, nb, j_ids)
    final_t, n_contrib = np.array(final_t), np.array(n_contrib)
    # Tiles that saturate: most pixels stop before their count.
    assert (final_t < 1e-3).mean() > 0.1
    ce = counts_eff(counts, n_contrib)
    g_c, g_t = cotangents(nb, 1)
    j_d = _blend_bwd_call(jnp.asarray(data), jnp.asarray(ce),
                          jnp.asarray(final_t), jnp.asarray(n_contrib),
                          jnp.asarray(g_c), jnp.asarray(g_t), tiles_x, nb,
                          j_ids)
    t_ids = None if ids is None else torch.from_numpy(ids)
    before = tblend.blend_bwd.launches
    t_d = tblend.blend_bwd(*(torch.from_numpy(x) for x in (
        data, ce, final_t, n_contrib, g_c, g_t)), tiles_x, nb, t_ids)
    assert tblend.blend_bwd.launches == before
    assert_rows_match(t_d.numpy(), j_d, ce)


def test_autograd_function_matches_jax_vjp():
    tiles_x, nb, k = 2, 4, 128
    data, counts = packed_tiles(nb, k, tiles_x, seed=6)
    g_c, g_t = cotangents(nb, 2)
    (j_c, j_t, j_n), vjp = jax.vjp(
        lambda d: jblend(d, jnp.asarray(counts), tiles_x, nb),
        jnp.asarray(data))
    (j_d,) = vjp((jnp.asarray(g_c), jnp.asarray(g_t),
                  np.zeros(j_n.shape, jax.dtypes.float0)))

    td = torch.from_numpy(data).requires_grad_(True)
    t_c, t_t, t_n = tblend.pallas_blend(td, torch.from_numpy(counts),
                                        tiles_x, nb)
    assert not t_n.requires_grad and t_c.requires_grad
    torch.autograd.backward([t_c, t_t], [torch.from_numpy(g_c),
                                         torch.from_numpy(g_t)])
    assert_rows_match(td.grad.numpy(), j_d,
                      counts_eff(counts, t_n.numpy()))

    # Only the color used downstream: final_T's cotangent is zero.
    td.grad = None
    t_c, _, _ = tblend.pallas_blend(td, torch.from_numpy(counts), tiles_x,
                                    nb)
    (t_c * torch.from_numpy(g_c)).sum().backward()
    (j_d0,) = vjp((jnp.asarray(g_c), jnp.zeros_like(j_t),
                   np.zeros(j_n.shape, jax.dtypes.float0)))
    assert_rows_match(td.grad.numpy(), j_d0,
                      counts_eff(counts, t_n.numpy()))


def test_nan_past_count_changes_nothing():
    """The port never reads rows >= counts_eff: NaN there leaves every
    gradient row as it was (JAX's group-wise kernel reads them, so it is
    not the reference here)."""
    tiles_x, nb, k = 2, 4, 96
    data, counts = packed_tiles(nb, k, tiles_x, seed=7)
    nan_data, _ = packed_tiles(nb, k, tiles_x, seed=7, garbage=np.nan)
    g_c, g_t = cotangents(nb, 3)
    grads = []
    for d in (data, nan_data):
        td = torch.from_numpy(d).requires_grad_(True)
        c, t, _ = tblend.pallas_blend(td, torch.from_numpy(counts), tiles_x,
                                      nb)
        torch.autograd.backward([c, t], [torch.from_numpy(g_c),
                                         torch.from_numpy(g_t)])
        grads.append(td.grad.numpy())
    assert np.isfinite(grads[0]).all()
    np.testing.assert_array_equal(grads[1], grads[0])
    with pytest.raises(ValueError):
        tblend.blend_bwd(*(torch.zeros(s).to("meta") for s in (
            (nb, k, 16), (nb,), (nb, 8, 128), (nb, 8, 128),
            (nb, 3, 8, 128), (nb, 8, 128))), tiles_x, nb)
