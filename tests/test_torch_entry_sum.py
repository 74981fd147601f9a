"""The entry transpose in pointer form (photo_slam_tpu_torch/ops/tiled.py:
entry_pointer, entry_sum and its plain version, which the CPU runs) against
index_add_, against a table-order stable-sort sum, against JAX's f32 gather
VJP and against JAX's kernel-path entry_gather
(photo_slam_tpu/ops/tiled.py::entry_gather, whose sort route rounds each
routed row to bf16), on identical numpy inputs."""
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
    """Unique entry ids (a random subset of range(n * k_dup) at random
    slots of the table, the rest -1) and gradient rows [..., d]."""
    rng = np.random.RandomState(seed)
    slots, m = int(np.prod(shape)), n * k_dup
    count = rng.randint(min(slots, m) // 2, min(slots, m) + 1)
    lists = np.full(slots, -1, np.int32)
    lists[rng.choice(slots, count, replace=False)] = rng.choice(
        m, count, replace=False)
    g = rng.randn(*shape, d).astype(np.float32)
    return lists.reshape(shape), g


def port_transpose(g, lists, k_dup, n):
    return ttiled.entry_gather_transpose(torch.from_numpy(g),
                                         torch.from_numpy(lists), k_dup, n)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_sum_matches_index_add(seed):
    """Within 1e-6 (f32 sums in another order) of index_add_ on random
    unique ids; lanes >= 9 are zero."""
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


def test_pointer_layout_and_slot_order():
    """entry_pointer: ptr[i, j] is the table position of entry id
    i * k_dup + j, -1 where the table holds none; the sum adds a Gaussian's
    rows in slot order, not table order (1e8 + 1 rounds to 1e8 in f32, so
    the two orders give 2 and 0)."""
    lists = np.array([[5, -1, 0, 13], [2, 7, -1, 1]], np.int32)
    ptr = ttiled.entry_pointer(torch.from_numpy(lists), 6, 3)
    assert ptr.tolist() == [[2, 7, 4, -1, -1, 0],
                            [-1, 5, -1, -1, -1, -1],
                            [-1, 3, -1, -1, -1, -1]]
    g = np.zeros((2, 4, 16), np.float32)
    g.reshape(-1, 16)[[0, 2, 4, 7], 0] = [1.0, 1e8, 1.0, -1e8]
    out = port_transpose(g, lists, 6, 3)
    assert float(out[0, 0]) == 2.0
    table_order = np.float32(0)
    for v in g.reshape(-1, 16)[[0, 2, 4, 7], 0]:
        table_order += v
    assert table_order == 0.0


@pytest.mark.parametrize("bad", ["repeated", "out of range"])
def test_repeated_or_out_of_range_id_raises(bad):
    lists, g = random_table(4)
    ids = lists.reshape(-1)
    valid = np.flatnonzero(ids >= 0)
    ids[valid[1]] = ids[valid[0]] if bad == "repeated" else 50 * 6
    with pytest.raises(ValueError, match=bad.split()[0]):
        port_transpose(g, lists, 6, 50)


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


def table_order_sum(g, lists, k_dup, n):
    """The sort-based route as a reference: the table positions stably
    sorted by Gaussian, each Gaussian's rows added in table order from 0
    in f32."""
    ids, rows = lists.reshape(-1), g.reshape(-1, g.shape[-1])
    keys = np.where(ids >= 0, ids // k_dup, n)
    out = np.zeros((n, rows.shape[1]), np.float32)
    for p in np.argsort(keys, kind="stable"):
        if ids[p] < 0:
            break
        out[ids[p] // k_dup, :LANES] += rows[p, :LANES]
    return out


def test_pass1_table_sum_bit_equal_to_table_order_sort():
    """On JAX's binned table (tile order) a Gaussian's slots lie in rising
    tiles, so slot order is table order: the pointer-form sum is bit-equal
    to the stable-sort segmented sum it replaced."""
    b, _, g, n, k_dup = binned_table()
    lists = np.array(b.tile_lists)
    got = port_transpose(g, lists, k_dup, n).numpy()
    np.testing.assert_array_equal(got, table_order_sum(g, lists, k_dup, n))


def test_compact_continuation_window_matches_index_add():
    """A compact continuation window (the overflowed tiles' next windows,
    the tiles in score order, so a Gaussian's rows are not in slot order)
    against index_add_ within 1e-6 (f32 sums in another order)."""
    b, _, _, n, k_dup = binned_table()
    kmax, cap = 32, 64
    raw, starts = np.asarray(b.raw_counts), np.asarray(b.starts)
    se = np.asarray(b.sorted_entries)
    rng = np.random.RandomState(6)
    over = np.flatnonzero(raw > kmax)
    order = over[np.argsort(-rng.rand(over.size), kind="stable")]
    lists = np.full((order.size, cap), -1, np.int32)
    for r, t in enumerate(order):
        c = min(raw[t] - kmax, cap)
        lists[r, :c] = se[starts[t] + kmax: starts[t] + kmax + c]
    ids = lists.reshape(-1)
    pos_by_id = {e: p for p, e in enumerate(ids) if e >= 0}
    out_of_order = sum(
        1 for i in range(n)
        if np.any(np.diff([pos_by_id[i * k_dup + j] for j in range(k_dup)
                           if i * k_dup + j in pos_by_id]) < 0))
    assert out_of_order > 0
    g = rng.randn(order.size, cap, 16).astype(np.float32)
    got = port_transpose(g, lists, k_dup, n)
    valid = torch.from_numpy(ids >= 0)
    want = torch.zeros((n, LANES)).index_add_(
        0, torch.from_numpy(np.where(ids >= 0, ids // k_dup, 0)),
        torch.where(valid[:, None], torch.from_numpy(g).reshape(-1, 16)[
            :, :LANES], 0.0))
    np.testing.assert_allclose(got[:, :LANES].numpy(), want.numpy(),
                               atol=1e-6, rtol=1e-6)
    assert (got[:, LANES:] == 0).all()
