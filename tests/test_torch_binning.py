"""The port's tile binning and window gather (K3's plain version) against
the JAX package, fed identical numpy inputs.

Both sides sort unstably, so entries with equal packed keys may come out in
either order: the tests compare counters, per-tile KEY sequences and the set
of entry ids under each (tile, key), never the order of entry ids."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photo_slam_tpu.ops import binning as jb
from photo_slam_tpu_torch.ops import binning as tb


def inputs(n, w, h, seed, radius_hi=10, with_extents=False):
    rng = np.random.RandomState(seed)
    means = (rng.rand(n, 2) * [w * 1.2, h * 1.2] - [w * 0.1, h * 0.1]) \
        .astype(np.float32)
    # Quantized depths so that equal keys (ties) really occur.
    depths = (np.round(rng.rand(n) * 50) / 10 + 0.3).astype(np.float32)
    radii = rng.randint(0, radius_hi, n).astype(np.int32)
    visible = (radii > 0) & (rng.rand(n) > 0.1)
    ext = None
    if with_extents:
        ext = (rng.rand(n, 2) * radii[:, None]).astype(np.float32)
        ext[rng.rand(n) < 0.1] = 0.0
    return means, depths, radii, visible, ext


def depth_code(depths, num_tiles):
    depth_bits = 31 - max(1, num_tiles + 1).bit_length()
    bits = np.maximum(depths, 0).astype(np.float32).view(np.uint32)
    return (bits >> np.uint32(31 - depth_bits)).astype(np.int64)


def canonical_stream(b, k_dup, codes):
    """Per tile: (key sequence, entries sorted by (key, id))."""
    se, starts = np.asarray(b.sorted_entries), np.asarray(b.starts)
    raw = np.asarray(b.raw_counts)
    out = []
    for t in range(len(starts)):
        seg = se[starts[t]:starts[t] + raw[t]].astype(np.int64)
        keys = codes[seg // k_dup]
        out.append((keys, seg[np.lexsort((seg, keys))]))
    return out


def list_keys(lists, counts, k_dup, codes):
    lists, counts = np.asarray(lists), np.asarray(counts)
    for t in range(len(counts)):
        assert (lists[t, counts[t]:] == -1).all()
    return [codes[lists[t, :counts[t]].astype(np.int64) // k_dup]
            for t in range(len(counts))]


CASES = [
    # n, w, h, tile, k_dup, max_per_tile, extents
    (3000, 128, 96, 32, 8, 128, False),
    (2000, 96, 64, 32, 6, 64, True),
    (1500, 64, 48, 16, 16, 96, True),
    (400, 200, 136, 32, 6, 1024, True),   # the kernel path's caps
]


@pytest.mark.parametrize("n,w,h,tile,k_dup,kmax,with_ext", CASES)
def test_bin_gaussians_matches_jax(n, w, h, tile, k_dup, kmax, with_ext):
    means, depths, radii, visible, ext = inputs(n, w, h, seed=n,
                                                with_extents=with_ext)
    kw = dict(tile=tile, max_tiles_per_gaussian=k_dup, max_per_tile=kmax)
    jbin = jb.bin_gaussians(jnp.asarray(means), jnp.asarray(depths),
                            jnp.asarray(radii), jnp.asarray(visible), w, h,
                            extents=None if ext is None else jnp.asarray(ext),
                            **kw)
    tbin = tb.bin_gaussians(torch.from_numpy(means), torch.from_numpy(depths),
                            torch.from_numpy(radii), torch.from_numpy(visible),
                            w, h, extents=None if ext is None
                            else torch.from_numpy(ext), **kw)
    for f in ("tile_counts", "num_clipped", "num_overflow", "starts",
              "raw_counts", "entry_counts"):
        np.testing.assert_array_equal(getattr(tbin, f).numpy(),
                                      np.asarray(getattr(jbin, f)), err_msg=f)
    # Sorted tiles and keys are a pure function of the key multiset.
    np.testing.assert_array_equal(tbin.sorted_tiles.numpy(),
                                  np.asarray(jbin.sorted_tiles))
    gx, gy = jb.tile_grid(w, h, tile)
    codes = depth_code(depths, gx * gy)
    for (tk, te), (jk, je) in zip(canonical_stream(tbin, k_dup, codes),
                                  canonical_stream(jbin, k_dup, codes)):
        np.testing.assert_array_equal(tk, jk)
        np.testing.assert_array_equal(te, je)
    for tk, jk in zip(list_keys(tbin.tile_lists, tbin.tile_counts, k_dup,
                                codes),
                      list_keys(jbin.tile_lists, jbin.tile_counts, k_dup,
                                codes)):
        np.testing.assert_array_equal(tk, jk)
    assert int(tbin.num_overflow) > 0 or kmax == 1024


@pytest.mark.parametrize("offset,cap", [(128, 128), (0, 128), (64, 256)])
def test_window_lists_match_jax(offset, cap):
    n, w, h, k_dup = 3000, 128, 96, 8
    means, depths, radii, visible, _ = inputs(n, w, h, seed=11)
    kw = dict(tile=32, max_tiles_per_gaussian=k_dup, max_per_tile=128)
    jbin = jb.bin_gaussians(jnp.asarray(means), jnp.asarray(depths),
                            jnp.asarray(radii), jnp.asarray(visible), w, h,
                            **kw)
    tbin = tb.bin_gaussians(torch.from_numpy(means), torch.from_numpy(depths),
                            torch.from_numpy(radii), torch.from_numpy(visible),
                            w, h, **kw)
    jl, jc = jb.window_lists(jbin, offset, cap)
    tl, tc = tb.window_lists(tbin, offset, cap)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    codes = depth_code(depths, 12)
    for tk, jk in zip(list_keys(tl, tc, k_dup, codes),
                      list_keys(jl, jc, k_dup, codes)):
        np.testing.assert_array_equal(tk, jk)
    # The window is exactly [offset, offset+cap) of each tile's segment.
    se, st = tbin.sorted_entries.numpy(), tbin.starts.numpy()
    raw = tbin.raw_counts.numpy()
    for t in range(len(st)):
        want = se[st[t] + offset: st[t] + min(raw[t], offset + cap)]
        np.testing.assert_array_equal(tl.numpy()[t, :tc[t]], want)


@pytest.mark.parametrize("k", [128, 256, 1024])
def test_window_gather_plain_matches_both_jax_twins(k):
    """K3's plain version equals the Pallas kernel (interpreted) wherever
    the window lies inside the stream, and the XLA twin everywhere,
    starts past the end of the stream included."""
    rng = np.random.RandomState(k)
    e_total = 5000
    se = rng.randint(0, 10 ** 6, e_total).astype(np.int32)
    starts = np.array([0, 100, 4999, 5000, 5000 + 1024, 4000, 123, 777,
                       e_total - k, 2 * e_total], np.int32)
    got = tb.window_gather_plain(torch.from_numpy(se),
                                 torch.from_numpy(starts), k).numpy()
    xla = np.asarray(jb._window_gather_xla(jnp.asarray(se),
                                           jnp.asarray(starts), k))
    pallas = np.asarray(jb._window_gather_pallas(
        jnp.asarray(se), jnp.asarray(starts), k, interpret=True))
    np.testing.assert_array_equal(got, xla)
    in_range = (starts[:, None] + np.arange(k)[None, :]) < e_total
    np.testing.assert_array_equal(got[in_range], pallas[in_range])


def test_window_gather_wrapper_on_cpu_runs_plain():
    se = torch.arange(100, dtype=torch.int32)
    starts = torch.tensor([0, 50, 99, 150], dtype=torch.int32)
    before = tb.window_gather.launches
    out = tb.window_gather(se, starts, 16)
    assert tb.window_gather.launches == before
    np.testing.assert_array_equal(out.numpy(),
                                  tb.window_gather_plain(se, starts,
                                                         16).numpy())
    assert out.dtype == torch.int32 and out[3].tolist() == [99] * 16
    with pytest.raises(ValueError):
        tb.window_gather(se.to("meta"), starts.to("meta"), 16)


@pytest.mark.parametrize("k", [128, 256, 1024])
def test_window_gather_plain_with_counts_matches_jax(k):
    """The masked form: -1 where j >= counts[t], the XLA twin elsewhere
    (the callers' where(arange < counts, window, -1), moved into K3)."""
    rng = np.random.RandomState(k + 1)
    e_total = 5000
    se = rng.randint(0, 10 ** 6, e_total).astype(np.int32)
    starts = np.array([0, 100, 4999, 5000, 5000 + 1024, 4000, 123, 777,
                       e_total - k, 2 * e_total], np.int32)
    counts = np.array([0, k, k + 7, 3, k - 1, 1, 10 ** 6, k // 2, -2, 5],
                      np.int32)
    got = tb.window_gather_plain(torch.from_numpy(se),
                                 torch.from_numpy(starts), k,
                                 torch.from_numpy(counts)).numpy()
    want = np.asarray(jnp.where(
        jnp.arange(k)[None, :] < jnp.asarray(counts)[:, None],
        jb._window_gather_xla(jnp.asarray(se), jnp.asarray(starts), k), -1))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert (got[0] == -1).all() and (got[1] != -1).all()


def test_window_gather_wrapper_with_counts_on_cpu():
    se = torch.arange(100, dtype=torch.int32)
    starts = torch.tensor([0, 50, 99, 150], dtype=torch.int32)
    counts = torch.tensor([16, 3, 0, 20], dtype=torch.int32)
    before = tb.window_gather.launches
    out = tb.window_gather(se, starts, 16, counts)
    assert tb.window_gather.launches == before
    assert out.dtype == torch.int32
    assert out[0].tolist() == list(range(16))
    assert out[1].tolist() == [50, 51, 52] + [-1] * 13
    assert out[2].tolist() == [-1] * 16 and out[3].tolist() == [99] * 16
    with pytest.raises(ValueError):
        tb.window_gather(se.to("meta"), starts.to("meta"), 16,
                         counts.to("meta"))
