"""The entry transpose's deterministic sum (photo_slam_tpu_torch/ops/tiled.py:
entry_order, entry_sum and its plain version, which the CPU runs) against
index_add_, against JAX's f32 gather VJP and against JAX's kernel-path
entry_gather (photo_slam_tpu/ops/tiled.py::entry_gather, whose sort route
rounds each routed row to bf16), on identical numpy inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from photo_slam_tpu.ops.binning import bin_gaussians as jbin
from photo_slam_tpu.ops.tiled import ROUTE_LANES_PACKED
from photo_slam_tpu.ops.tiled import entry_gather as jentry_gather
from photo_slam_tpu_torch.ops import tiled as ttiled
from test_torch_blend import one_torch_thread  # noqa: F401

LANES = ttiled.GRAD_LANES


def random_table(seed, n=50, k_dup=6, shape=(7, 40), d=16):
    """Entry ids with repeats and -1s, and gradient rows [..., d]."""
    rng = np.random.RandomState(seed)
    lists = rng.randint(-1, n * k_dup, shape).astype(np.int32)
    g = rng.randn(*shape, d).astype(np.float32)
    return lists, g


def port_transpose(g, lists, k_dup, n):
    return ttiled.entry_gather_transpose(torch.from_numpy(g),
                                         torch.from_numpy(lists), k_dup, n)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_sum_matches_index_add(seed):
    """Within 1e-6 (f32 sums in another order) of index_add_ on random ids
    with repeats; lanes >= 9 are zero."""
    n, k_dup = 50, 6
    lists, g = random_table(seed, n, k_dup)
    got = port_transpose(g, lists, k_dup, n)
    ids = torch.from_numpy(lists).reshape(-1)
    valid = ids >= 0
    want = torch.zeros((n, LANES)).index_add_(
        0, torch.where(valid, ids // k_dup, 0),
        torch.where(valid[:, None], torch.from_numpy(g).reshape(-1, 16)[
            :, :LANES], 0.0))
    assert got.dtype == torch.float32 and got.shape == (n, 16)
    np.testing.assert_allclose(got[:, :LANES].numpy(), want.numpy(),
                               atol=1e-6, rtol=1e-6)
    assert (got[:, LANES:] == 0).all()


def test_order_and_bounds_are_stable_segments():
    """entry_order: each Gaussian's positions in table order, invalid ids
    after every segment."""
    lists = np.array([[5, -1, 0, 13], [2, 7, -1, 1]], np.int32)
    order, bounds = ttiled.entry_order(torch.from_numpy(lists), 6, 3)
    assert order.dtype == bounds.dtype == torch.int32
    assert bounds.tolist() == [0, 4, 5, 6]
    assert order.tolist() == [0, 2, 4, 7, 5, 3, 1, 6]


def test_two_calls_bit_equal_with_four_threads():
    n, k_dup = 2000, 6
    lists, g = random_table(3, n, k_dup, shape=(64, 256))
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        a = port_transpose(g, lists, k_dup, n)
        b = port_transpose(g, lists, k_dup, n)
    finally:
        torch.set_num_threads(threads)
    assert torch.equal(a, b)


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), n=st.integers(1, 40),
       k_dup=st.integers(1, 8), tiles=st.integers(1, 6),
       k=st.integers(1, 33))
def test_zero_lanes_and_invalid_ids_add_nothing(seed, n, k_dup, tiles, k):
    """Lanes 9-15 are 0, and what the rows of invalid ids hold changes
    nothing."""
    lists, g = random_table(seed, n, k_dup, shape=(tiles, k))
    out = port_transpose(g, lists, k_dup, n)
    assert (out[:, LANES:] == 0).all()
    g2 = g.copy()
    g2[lists < 0] = np.random.RandomState(seed ^ 1).randn(
        int((lists < 0).sum()), 16)
    assert torch.equal(port_transpose(g2, lists, k_dup, n), out)


def binned_table(kmax=32):
    """tests/test_renderer.py::TestEntryGatherTranspose._setup: a JAX
    binning with overflow, features and gradient rows zero past counts and
    in the lanes past the packed layout's."""
    rng = np.random.RandomState(3)
    n, k_dup, w, h = 3000, 6, 256, 128
    b = jbin(jnp.asarray(rng.uniform(0, [w, h], (n, 2)).astype(np.float32)),
             jnp.asarray(rng.uniform(1, 10, n).astype(np.float32)),
             jnp.asarray(rng.randint(1, 40, n).astype(np.int32)),
             jnp.asarray(rng.rand(n) > 0.1), w, h, tile=32,
             max_tiles_per_gaussian=k_dup, max_per_tile=kmax)
    feat = rng.randn(n, 16).astype(np.float32)
    g = rng.randn(*(b.tile_lists.shape + (16,))).astype(np.float32)
    g *= (np.arange(kmax)[None, :] < np.asarray(b.tile_counts)[:, None]
          )[..., None]
    g[..., LANES:] = 0.0
    return b, feat, g, n, k_dup


def port_vjp(feat, lists, g, k_dup):
    f = torch.from_numpy(feat).requires_grad_(True)
    rows = ttiled.entry_gather(f, torch.from_numpy(lists), k_dup)
    rows.backward(torch.from_numpy(g))
    return f.grad.numpy()


def test_vjp_matches_jax_f32_gather():
    """The port's entry_gather VJP against jax.vjp of the f32 gather
    feat[max(id, 0) // k_dup] (invalid rows carry zero cotangent): within
    1e-6 of the largest sum (f32 sums in another order)."""
    b, feat, g, n, k_dup = binned_table()
    lists = np.array(b.tile_lists)
    _, vjp = jax.vjp(lambda f: f[jnp.where(lists >= 0, lists // k_dup, 0)],
                     jnp.asarray(feat))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    got = port_vjp(feat, lists, g, k_dup)
    np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(want).max())


def test_vjp_matches_jax_kernel_path_entry_gather():
    """Against JAX's kernel-path entry_gather (the sort route of the main
    path, with overflow-dropped entries), which rounds each routed row to
    bf16: within 6e-3 of the largest sum."""
    b, feat, g, n, k_dup = binned_table()
    assert int(b.num_overflow) > 0
    _, vjp = jax.vjp(
        lambda f: jentry_gather(f, b.tile_lists, b.sorted_entries,
                                b.sorted_tiles, b.starts, b.tile_counts,
                                b.entry_counts, k_dup, 0,
                                ROUTE_LANES_PACKED), jnp.asarray(feat))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    got = port_vjp(feat, np.array(b.tile_lists), g, k_dup)
    np.testing.assert_allclose(got, want, atol=6e-3 * np.abs(want).max())
