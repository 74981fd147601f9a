"""K1's plain version (photo_slam_tpu_torch/ops/blend.py) against the JAX
package's pallas_blend, run interpreted on the CPU, on identical packed
tiles, with and without the tile_ids remap of the compact continuation."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photo_slam_tpu.ops.pallas.blend import pallas_blend as jblend
from photo_slam_tpu_torch.ops import blend as tblend


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread per test process: the suite runs its files in
    parallel workers, and these tensors are small, so more threads only
    oversubscribe the cores. Imported by the other port test files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def packed_tiles(num_tiles, k, tiles_x, seed, garbage=0.5):
    """Random [T, K, 16] entries scattered around their tiles, with counts
    below K and `garbage` in every lane of the rows past each count (JAX's
    kernel multiplies the colors of a group's tail rows by zero, so only a
    finite value keeps its output finite)."""
    rng = np.random.RandomState(seed)
    ids = np.arange(num_tiles)
    ox = ((ids % tiles_x) * 32)[:, None]
    oy = ((ids // tiles_x) * 32)[:, None]
    data = np.zeros((num_tiles, k, 16), np.float32)
    data[..., 0] = ox + rng.rand(num_tiles, k) * 44 - 6
    data[..., 1] = oy + rng.rand(num_tiles, k) * 44 - 6
    a = rng.rand(num_tiles, k) * 0.05 + 0.003
    c = rng.rand(num_tiles, k) * 0.05 + 0.003
    data[..., 2] = a
    data[..., 3] = (rng.rand(num_tiles, k) - 0.5) * np.sqrt(a * c)
    data[..., 4] = c
    data[..., 5] = rng.rand(num_tiles, k) * 0.6 + 0.39
    data[..., 6:9] = rng.rand(num_tiles, k, 3)
    counts = rng.randint(k // 4, k, num_tiles).astype(np.int32)
    counts[0] = 0
    for t in range(num_tiles):
        data[t, counts[t]:, :9] = garbage
    return data, counts


def assert_matches(t_out, j_out):
    tc, tt, tn = (x.numpy() for x in t_out)
    jc, jt, jn = (np.asarray(x) for x in j_out)
    assert tc.shape == jc.shape and tn.dtype == np.int32
    np.testing.assert_allclose(tc, jc, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tt, jt, atol=1e-5, rtol=0)
    # n_contrib may differ only where a pixel's transmittance sits at the
    # 1e-4 stop threshold, which the two sides round differently.
    edge = np.abs(jt - 1e-4) < 1e-6
    np.testing.assert_array_equal(tn[~edge], jn[~edge])


@pytest.mark.parametrize("num_tiles,k,tiles_x,seed", [
    (4, 128, 2, 0), (6, 256, 3, 1), (3, 64, 1, 2)])
def test_plain_matches_jax_pallas_blend(num_tiles, k, tiles_x, seed):
    data, counts = packed_tiles(num_tiles, k, tiles_x, seed)
    j = jblend(jnp.asarray(data), jnp.asarray(counts), tiles_x, num_tiles)
    t = tblend.pallas_blend(torch.from_numpy(data), torch.from_numpy(counts),
                            tiles_x, num_tiles)
    assert_matches(t, j)
    # Most pixels saturated, so the early stop is exercised.
    assert (np.asarray(j[1]) < 1e-3).mean() > 0.1
    # Rows past a tile's count are never read: NaN there changes nothing.
    nan_data, _ = packed_tiles(num_tiles, k, tiles_x, seed, garbage=np.nan)
    t_nan = tblend.pallas_blend(torch.from_numpy(nan_data),
                                torch.from_numpy(counts), tiles_x, num_tiles)
    for a, b in zip(t_nan, t):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_plain_matches_jax_with_tile_ids():
    """Block i rasterizes image tile tile_ids[i] (compact continuation)."""
    tiles_x, grid_tiles = 4, 12
    data, counts = packed_tiles(grid_tiles, 128, tiles_x, seed=3)
    order = np.array([7, 2, 11], np.int32)
    sub_d, sub_c = data[order], counts[order]
    j = jblend(jnp.asarray(sub_d), jnp.asarray(sub_c), tiles_x, 3,
               jnp.asarray(order))
    t = tblend.pallas_blend(torch.from_numpy(sub_d), torch.from_numpy(sub_c),
                            tiles_x, 3, torch.from_numpy(order))
    assert_matches(t, j)
    # And block i equals the full render's tile order[i].
    full = tblend.blend_fwd_plain(torch.from_numpy(data),
                                  torch.from_numpy(counts), tiles_x,
                                  grid_tiles)
    for i, tile in enumerate(order):
        for a, b in zip(t, full):
            np.testing.assert_array_equal(a[i].numpy(), b[tile].numpy())


def test_wrapper_on_cpu_runs_plain_and_counts_no_launch():
    data, counts = packed_tiles(2, 64, 2, seed=4)
    before = tblend.blend_fwd.launches
    out = tblend.pallas_blend(torch.from_numpy(data), torch.from_numpy(counts),
                              2, 2)
    assert tblend.blend_fwd.launches == before
    for a, b in zip(out, tblend.blend_fwd_plain(torch.from_numpy(data),
                                                torch.from_numpy(counts),
                                                2, 2)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    # An empty tile: nothing composited, T stays 1.
    assert (out[0][0] == 0).all() and (out[1][0] == 1).all()
    assert (out[2][0] == 0).all()
    with pytest.raises(ValueError):
        tblend.pallas_blend(torch.from_numpy(data).to("meta"),
                            torch.from_numpy(counts).to("meta"), 2, 2)
