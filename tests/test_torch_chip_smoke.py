"""chip_smoke.py's pricing of the blend kernels' bounds on the CPU:
blend_pair_counts, which counts the entry-pixel pairs of each kind a
forward (K1's loop) and a backward (K2's) evaluate, against a count made
pixel by pixel, for K1's 32 px tiles, X4's 16 px quadrants and X1's bf16
chain; k1_cull_counts, k2_cull_counts, x1_cull_counts, x3_cull_counts,
x4f_cull_counts and x4b_cull_counts, K1's, K2's, X1's, X3's, X4f's and
X4b's warp skips, against a count made warp by warp with the kernels' own
thread-to-pixel map, as is
tools/time_blend.py's share of stopping pixels and warps; issue_bound,
X2's bound at the card's issue rates, against hand-worked numbers;
sass_loop_counts, the count of a main loop's instructions by class that
checks X2_SASS, on a listing in cuobjdump's layout; and
the online phase's helpers: its in-memory sequence (tools/synth_replica.py)
and the correction ops it makes and its CPU twin; and the euroc phase's:
the gravity angle, the share of disparities near the truth, the sgm
kernel's bound and its row of the `kernels` line; and the viewer and
batched phases': the stages of a /render request, a served PNG against a
render, the /render query and the batched step's launch check; and the
sharded phase's: the collective path, the ranks' launches summed, the
bytes of each collective, the twin checks and the caps that do not
bind."""
import numpy as np
import pytest
import torch

import chip_smoke as cs
from photo_slam_tpu_torch.config import dataset_config
from photo_slam_tpu_torch.mapper import mapper as mapper_mod
from photo_slam_tpu_torch.mapper import mapping_ops
from photo_slam_tpu_torch.models.keyframe import Keyframe
from photo_slam_tpu_torch.ops import blend as blend_mod
from photo_slam_tpu_torch.tools import bench_room, time_blend
from photo_slam_tpu_torch.tools import exp_blend16 as tx4
from photo_slam_tpu_torch.tools import exp_blend_bf16 as tx1
from photo_slam_tpu_torch.tools import synth_replica
from photo_slam_tpu_torch.tracking.gt_tracker import GroundTruthTracker
from photo_slam_tpu_torch.utils import math as cs_math
from test_torch_blend import one_torch_thread, packed_tiles  # noqa: F401


def count_by_pixel(power, alpha, counts, n_contrib, amin):
    """The kinds of blend_pair_counts, walking each pixel on its own:
    power, alpha [B, K, P] float32 numpy."""
    tally = dict.fromkeys(("k1_power_fail", "k1_alpha_fail", "k1_stop",
                           "k1_applied", "k2_power_fail", "k2_alpha_fail",
                           "k2_valid"), 0)
    nb, _, npix = power.shape
    for b in range(nb):
        for p in range(npix):
            trans = np.float32(1.0)
            for k in range(counts[b]):
                if not power[b, k, p] <= 0:
                    tally["k1_power_fail"] += 1
                elif not alpha[b, k, p] >= amin:
                    tally["k1_alpha_fail"] += 1
                else:
                    test_t = trans * (np.float32(1.0) - alpha[b, k, p])
                    if test_t < blend_mod.T_EPS:
                        tally["k1_stop"] += 1
                        break
                    tally["k1_applied"] += 1
                    trans = test_t
            for k in range(min(counts[b], n_contrib[b, p])):
                if not power[b, k, p] <= 0:
                    tally["k2_power_fail"] += 1
                elif not alpha[b, k, p] >= amin:
                    tally["k2_alpha_fail"] += 1
                else:
                    tally["k2_valid"] += 1
    return tally


@pytest.mark.parametrize("case", ["k1", "x4", "x1"])
def test_pair_counts_match_a_count_by_pixel(case):
    if case == "x4":
        rng = np.random.RandomState(5)
        tab = np.zeros((1, 48, 4, 16), np.float32)
        tab[..., 0:2] = rng.rand(1, 48, 4, 2) * 24 - 4
        tab[..., 2] = tab[..., 4] = rng.rand(1, 48, 4) * 0.05 + 0.01
        tab[..., 5] = rng.rand(1, 48, 4) * 0.6 + 0.39
        tab[..., 6:9] = rng.rand(1, 48, 4, 3)
        counts = torch.tensor([48, 30, 0, 7], dtype=torch.int32)
        d16c = torch.from_numpy(tab)
        data = tx4._quadrant_rows(d16c)
        n_contrib = tx4._quadrant_pixels(tx4.blend16_fwd_plain(d16c, counts,
                                                               1)[2])
        power_alpha = cs.f32_power_alpha(
            blend_mod, *tx4._local_pixels("cpu", torch.float32))
        amin = None
    else:
        d, c = packed_tiles(2, 48, 2, seed=9)
        data, counts = torch.from_numpy(d), torch.from_numpy(c)
        if case == "k1":
            out = blend_mod.blend_fwd_plain(data, counts, 2, 2)
            power_alpha = cs.f32_power_alpha(
                blend_mod, *cs.tile_pixels(torch, 2, 2, 32, "cpu"))
            amin = None
        else:
            out = tx1.call_bf16_plain(data, counts, 2, 2)
            ox, oy, lx, ly = tx1.tile_frame(2, 2, "cpu")
            power_alpha = lambda row: tx1.power_alpha_bf16(  # noqa: E731
                row, ox, oy, lx, ly)
            amin = tx1.ALPHA_MIN_BF16
        n_contrib = out[2].reshape(2, -1)
    got = cs.blend_pair_counts(torch, blend_mod, data, counts, n_contrib,
                               power_alpha, alpha_min=amin)
    pa = [power_alpha(data[:, k]) for k in range(data.shape[1])]
    power = torch.stack([p.float() for p, _ in pa], 1).numpy()
    alpha = torch.stack([a.float() for _, a in pa], 1).numpy()
    want = count_by_pixel(power, alpha, counts.numpy(), n_contrib.numpy(),
                          blend_mod.ALPHA_MIN if amin is None else amin)
    assert got == want
    assert want["k1_applied"] == want["k2_valid"] > 0
    assert want["k1_alpha_fail"] > 0 and want["k1_stop"] > 0


def kernel_warp_of_pixel():
    """csrc/blend_bwd.cu's map: warp w, lane l = lx + 8 ly hold pixel
    (16 (w & 1) + lx + 8 (j & 1), 8 (w >> 1) + ly + 4 (j >> 1)) of the
    32 x 32 tile in slot j, one per 8 x 4 quadrant of the warp's block.
    Returns each pixel's warp and its slot."""
    owner, slot = np.full(1024, -1), np.full(1024, -1)
    for w in range(8):
        for lane in range(32):
            lx, ly = lane & 7, lane >> 3
            for j in range(4):
                p = ((w >> 1) * 8 + ly + 4 * (j >> 1)) * 32 + (
                    (w & 1) * 16 + lx + 8 * (j & 1))
                assert owner[p] == -1
                owner[p], slot[p] = w, j
    assert (owner >= 0).all()
    return owner, slot


def stop_index(alpha, ok, counts):
    """Per tile and pixel, the entry at which blend_fwd_plain's loop stops
    the pixel (the first contributing one whose T (1 - alpha) < 1e-4), or
    the count when it never stops, walking each pixel on its own: alpha, ok
    [B, K, P] numpy."""
    nb, _, npix = alpha.shape
    stop = np.array([[counts[b]] * npix for b in range(nb)])
    for b in range(nb):
        for p in range(npix):
            trans = np.float32(1.0)
            for k in range(counts[b]):
                if ok[b, k, p]:
                    test_t = trans * (np.float32(1.0) - alpha[b, k, p])
                    if test_t < blend_mod.T_EPS:
                        stop[b, p] = k
                        break
                    trans = test_t
    return stop


def test_k1_cull_counts_match_a_count_by_warp():
    tiles_x, nb, k = 2, 4, 96
    d, c = packed_tiles(nb, k, tiles_x, seed=12)
    # Small splats in tiles 0 and 2, so that the box misses most warps;
    # wide ones in tiles 1 and 3, so that whole warps stop.
    d[0::2, :, 2:5] *= 4.0
    d[1::2, :, 5] = np.maximum(d[1::2, :, 5], 0.9)
    data, counts = torch.from_numpy(d), torch.from_numpy(c)
    got = cs.k1_cull_counts(torch, blend_mod, data, counts, tiles_x)

    owner, _ = kernel_warp_of_pixel()
    px, py = cs.tile_pixels(torch, nb, tiles_x, 32, "cpu")
    terms = [blend_mod.pair_terms(data[:, j], px, py) for j in range(k)]
    alpha = torch.stack([t[5] for t in terms], 1).numpy()
    ok = torch.stack([t[6] for t in terms], 1).numpy()
    stop = stop_index(alpha, ok, c)
    px, py = px.numpy(), py.numpy()
    want = dict.fromkeys(got, 0)
    for j in range(int(c.max())):
        box = blend_mod.entry_cull_boxes(data[:, j]).numpy()
        for b in range(nb):
            if j >= c[b]:
                continue
            for w in range(8):
                mine = owner == w
                want["entry_warp_pairs"] += 1
                x, y = px[b, mine], py[b, mine]
                if (stop[b, mine] < j).all():
                    want["skipped_by_warp_stop"] += 1
                elif (box[b, 1] < x.min() or box[b, 0] > x.max()
                      or box[b, 3] < y.min() or box[b, 2] > y.max()):
                    want["skipped_by_box"] += 1
                else:
                    continue
                # Applied or stopping: contributing, at or before the stop.
                want["contributing_in_skipped"] += int(
                    (ok[b, j, mine] & (j <= stop[b, mine])).sum())
    assert got == want
    assert want["contributing_in_skipped"] == 0
    assert want["skipped_by_box"] > 0 and want["skipped_by_warp_stop"] > 0


def test_stop_shares_match_a_count_by_pixel():
    """tools/time_blend.py's share of stopping pixels and of K1's warp
    blocks whose pixels all stop, against stop_index's walk and the
    kernel's thread map."""
    tiles_x, nb, k = 2, 4, 96
    d, c = packed_tiles(nb, k, tiles_x, seed=12)
    d[1::2, :, 5] = np.maximum(d[1::2, :, 5], 0.9)
    data, counts = torch.from_numpy(d), torch.from_numpy(c)
    tiles = bench_room.Tiles32(binning=None, data=data, counts=counts,
                               tiles_x=tiles_x, tiles_y=nb // tiles_x)
    got = time_blend.stop_shares(tiles)

    owner, _ = kernel_warp_of_pixel()
    px, py = cs.tile_pixels(torch, nb, tiles_x, 32, "cpu")
    terms = [blend_mod.pair_terms(data[:, j], px, py) for j in range(k)]
    alpha = torch.stack([t[5] for t in terms], 1).numpy()
    ok = torch.stack([t[6] for t in terms], 1).numpy()
    stopped = stop_index(alpha, ok, c) < c[:, None]
    warps = [[stopped[b, owner == w].all() for w in range(8)]
             for b in range(nb)]
    assert got == pytest.approx((stopped.mean(), np.mean(warps)), abs=1e-7)
    assert 0 < got[1] < got[0] < 1


def test_k2_cull_counts_match_a_count_by_warp():
    tiles_x, nb, k = 2, 4, 64
    d, c = packed_tiles(nb, k, tiles_x, seed=11)
    # Small splats, so that the box misses most warps.
    d[..., 2:5] *= 4.0
    data, counts = torch.from_numpy(d), torch.from_numpy(c)
    n_contrib = blend_mod.blend_fwd_plain(data, counts, tiles_x,
                                          nb)[2].reshape(nb, -1)
    ce = torch.minimum(counts, n_contrib.amax(-1)).to(torch.int32)
    got = cs.k2_cull_counts(torch, blend_mod, data, ce, n_contrib, tiles_x)

    owner, slot = kernel_warp_of_pixel()
    px, py = (x.numpy() for x in cs.tile_pixels(torch, nb, tiles_x, 32,
                                                "cpu"))
    nc = n_contrib.numpy()
    want = dict.fromkeys(got, 0)
    for k in range(int(ce.max())):
        row = data[:, k]
        box = blend_mod.entry_cull_boxes(row).numpy()
        contrib = ((k < nc) & blend_mod.pair_terms(
            row, torch.from_numpy(px), torch.from_numpy(py))[-1].numpy())
        for b in range(nb):
            if k >= ce[b]:
                continue
            for w in range(8):
                mine = owner == w
                want["entry_warp_pairs"] += 1
                x, y = px[b, mine], py[b, mine]
                if k >= nc[b, mine].max():
                    want["skipped_by_n_contrib"] += 1
                elif (box[b, 1] < x.min() or box[b, 0] > x.max()
                      or box[b, 3] < y.min() or box[b, 2] > y.max()):
                    want["skipped_by_box"] += 1
                else:
                    want["contributing_path_runs"] += len(set(
                        slot[mine & contrib[b]]))
                    continue
                want["contributing_in_skipped"] += int(contrib[b,
                                                               mine].sum())
    assert got == want
    assert want["contributing_in_skipped"] == 0
    assert want["skipped_by_box"] > 0 and want["skipped_by_n_contrib"] > 0
    assert want["contributing_path_runs"] > 0


def group_death_index(alpha, ok, counts, group):
    """Per tile and pixel, the entry at which blend_vec_plain's groups kill
    the pixel (the first contributing one whose T s < 1e-4, s the running
    product of the group's contributing 1 - alpha, T the transmittance
    before the group), or the count when it never dies, walking each pixel
    on its own: alpha, ok [B, K, P] numpy."""
    nb, _, npix = alpha.shape
    death = np.array([[counts[b]] * npix for b in range(nb)])
    one = np.float32(1.0)
    for b in range(nb):
        for p in range(npix):
            trans = one
            for g0 in range(0, counts[b], group):
                s, applied = one, one
                for k in range(g0, min(g0 + group, counts[b])):
                    if not ok[b, k, p]:
                        continue
                    om = one - alpha[b, k, p]
                    s = s * om
                    if trans * s >= blend_mod.T_EPS:
                        applied = applied * om
                    else:
                        death[b, p] = k
                        break
                if death[b, p] < counts[b]:
                    break
                trans = trans * applied
    return death


def test_x3_cull_counts_match_a_count_by_warp():
    """chip_smoke.x3_cull_counts against a walk of each pixel through X3's
    groups and csrc/blend_vec_fwd.cu's warps (K1's map): small splats in
    tiles 0 and 2, so that the box misses most warps; opaque ones in tiles
    1 and 3, so that whole warps die, some within their first group."""
    tiles_x, nb, k, group = 2, 4, 160, 64
    d, c = packed_tiles(nb, k, tiles_x, seed=13)
    d[0::2, :, 2:5] *= 4.0
    d[1::2, :, 5] = np.maximum(d[1::2, :, 5], 0.9)
    data, counts = torch.from_numpy(d), torch.from_numpy(c)
    got = cs.x3_cull_counts(torch, blend_mod, group, data, counts, tiles_x)

    owner, _ = kernel_warp_of_pixel()
    px, py = cs.tile_pixels(torch, nb, tiles_x, 32, "cpu")
    terms = [blend_mod.pair_terms(data[:, j], px, py) for j in range(k)]
    alpha = torch.stack([t[5] for t in terms], 1).numpy()
    ok = torch.stack([t[6] for t in terms], 1).numpy()
    death = group_death_index(alpha, ok, c, group)
    px, py = px.numpy(), py.numpy()
    want = dict.fromkeys(got, 0)
    for j in range(int(c.max())):
        box = blend_mod.entry_cull_boxes(data[:, j]).numpy()
        for b in range(nb):
            if j >= c[b]:
                continue
            for w in range(8):
                mine = owner == w
                want["entry_warp_pairs"] += 1
                x, y = px[b, mine], py[b, mine]
                if (death[b, mine] < j).all():
                    want["skipped_by_warp_stop"] += 1
                elif (box[b, 1] < x.min() or box[b, 0] > x.max()
                      or box[b, 3] < y.min() or box[b, 2] > y.max()):
                    want["skipped_by_box"] += 1
                else:
                    continue
                # Applied or killing: contributing, at or before the death.
                want["contributing_in_skipped"] += int(
                    (ok[b, j, mine] & (j <= death[b, mine])).sum())
    assert got == want
    assert want["contributing_in_skipped"] == 0
    assert want["skipped_by_box"] > 0 and want["skipped_by_warp_stop"] > 0
    # Some warps die within the first group, at an entry past the first.
    assert 0 < death[1].min() < group


def quadrant_warp_of_pixel():
    """csrc/blend16_bwd.cu's map: warp w of a quadrant, lane l = lx + 8 ly
    hold quadrant-local pixel (lx + 8 (j & 1), 8 w + ly + 4 (j >> 1)) in
    slot j. Returns each of the 256 pixels' warp and slot."""
    owner, slot = np.full(256, -1), np.full(256, -1)
    for w in range(2):
        for lane in range(32):
            lx, ly = lane & 7, lane >> 3
            for j in range(4):
                p = (8 * w + ly + 4 * (j >> 1)) * 16 + lx + 8 * (j & 1)
                assert owner[p] == -1
                owner[p], slot[p] = w, j
    assert (owner >= 0).all()
    return owner, slot


def test_x4b_cull_counts_match_a_count_by_warp():
    """chip_smoke.x4b_cull_counts against a count made warp by warp with
    csrc/blend16_bwd.cu's map, on a quadrant table whose splats straddle
    the quadrants' borders: small ones, so that the box misses one of a
    quadrant's two warps, and some opaque ones, so that n_contrib cuts the
    walk of one warp before the other's."""
    rng = np.random.RandomState(21)
    nb, k = 2, 64
    tab = np.zeros((nb, k, 4, 16), np.float32)
    # Means in image pixels of each 32 px block, near the quadrants'
    # borders (16) and the blocks' edges, then shifted to each quadrant's
    # local pixels as exp_blend16.quadrant_table shifts them.
    img = rng.uniform(-4, 36, (nb, k, 2))
    img[:, ::3] = 16.0 + rng.uniform(-3, 3, (nb, (k + 2) // 3, 2))
    for q in range(4):
        tab[:, :, q, 0:2] = img - 16.0 * np.array([q % 2, q // 2])
    inv = 1.0 / rng.uniform(0.5, 6.0, (nb, k)) ** 2
    tab[..., 2] = inv[..., None]
    tab[..., 4] = (inv * rng.uniform(0.5, 2.0, (nb, k)))[..., None]
    tab[..., 3] = (0.2 * inv * rng.uniform(-1, 1, (nb, k)))[..., None]
    tab[..., 5] = rng.uniform(0.02, 0.4, (nb, k, 1))
    tab[:, 40:, :, 5] = 0.95     # opaque at the back: n_contrib stops short
    tab[..., 6:9] = rng.rand(nb, k, 1, 3)
    d16c = torch.from_numpy(tab)
    counts = torch.tensor([64, 50, 0, 31, 64, 64, 12, 45], dtype=torch.int32)
    nc = tx4._quadrant_pixels(tx4.blend16_fwd_plain(d16c, counts, nb)[2])
    rows = tx4._quadrant_rows(d16c)
    got = cs.x4b_cull_counts(torch, blend_mod, rows, counts, nc)

    owner, slot = quadrant_warp_of_pixel()
    lx, ly = tx4._local_pixels("cpu", torch.float32)
    x, y = lx[0].numpy(), ly[0].numpy()
    want = dict.fromkeys(got, 0)
    for j in range(int(counts.max())):
        row = rows[:, j]
        box = blend_mod.entry_cull_boxes(row).numpy()
        contrib = ((j < nc) & blend_mod.pair_terms(row, lx, ly)[-1]).numpy()
        for qi in range(4 * nb):
            if j >= counts[qi]:
                continue
            for w in range(2):
                mine = owner == w
                want["entry_warp_pairs"] += 1
                if j >= int(nc[qi, mine].max()):
                    want["skipped_by_n_contrib"] += 1
                elif (box[qi, 1] < x[mine].min() or box[qi, 0] > x[mine].max()
                      or box[qi, 3] < y[mine].min()
                      or box[qi, 2] > y[mine].max()):
                    want["skipped_by_box"] += 1
                else:
                    want["contributing_path_runs"] += len(set(
                        slot[mine & contrib[qi]]))
                    continue
                want["contributing_in_skipped"] += int(contrib[qi,
                                                               mine].sum())
    assert got == want
    assert want["contributing_in_skipped"] == 0
    assert want["skipped_by_box"] > 0 and want["skipped_by_n_contrib"] > 0
    assert want["contributing_path_runs"] > 0
    # The skip by n_contrib is the warp's own: some warp stops before the
    # other warp of its quadrant.
    nc_w = nc.reshape(4 * nb, 2, 128).amax(-1)
    assert (nc_w[:, 0] != nc_w[:, 1]).any()


def test_x1_cull_counts_match_a_count_by_warp():
    """chip_smoke.x1_cull_counts against a walk of each pixel through X1's
    bf16 chain and csrc/blend_bf16_fwd.cu's warps (K1's map), with its
    bf16 box in the tile-local frame: small splats in tiles 0 and 2, so
    that the box misses most warps; opaque ones in tiles 1 and 3, so that
    whole warps stop; and a few elongated ones, whose bf16 box is
    unbounded where K1's is not."""
    tiles_x, nb, k = 2, 4, 96
    d, c = packed_tiles(nb, k, tiles_x, seed=14)
    d[0::2, :, 2:5] *= 4.0
    d[1::2, :, 5] = np.maximum(d[1::2, :, 5], 0.9)
    # b^2 / (a c) = 0.95: det' > 0 at K1's slack, <= 0 at X1's.
    d[2, :8, 3] = np.sqrt(0.95 * d[2, :8, 2] * d[2, :8, 4])
    data, counts = torch.from_numpy(d), torch.from_numpy(c)
    got = cs.x1_cull_counts(torch, blend_mod, tx1, data, counts, tiles_x)

    owner, _ = kernel_warp_of_pixel()
    ox, oy, lx, ly = tx1.tile_frame(nb, tiles_x, "cpu")
    pa = [tx1.power_alpha_bf16(data[:, j], ox, oy, lx, ly) for j in range(k)]
    alpha = torch.stack([a.float() for _, a in pa], 1).numpy()
    ok = torch.stack([(p <= 0) & (a >= tx1.ALPHA_MIN_BF16) for p, a in pa],
                     1).numpy()
    stop = stop_index(alpha, ok, c)
    x, y = lx[0].float().numpy(), ly[0].float().numpy()
    want = dict.fromkeys(got, 0)
    for j in range(int(c.max())):
        box = blend_mod.entry_cull_boxes_bf16(data[:, j], ox[:, 0],
                                              oy[:, 0]).numpy()
        box32 = blend_mod.entry_cull_boxes(data[:, j]).numpy()
        for b in range(nb):
            if j >= c[b]:
                continue
            want["rows"] += 1
            want["unbounded_rows"] += int(box[b, 0] == -np.inf)
            want["unbounded_rows_f32_box"] += int(box32[b, 0] == -np.inf)
            for w in range(8):
                mine = owner == w
                want["entry_warp_pairs"] += 1
                if (stop[b, mine] < j).all():
                    want["skipped_by_warp_stop"] += 1
                elif (box[b, 1] < x[mine].min() or box[b, 0] > x[mine].max()
                      or box[b, 3] < y[mine].min()
                      or box[b, 2] > y[mine].max()):
                    want["skipped_by_box"] += 1
                else:
                    continue
                # Applied or stopping: taken, at or before the stop.
                want["contributing_in_skipped"] += int(
                    (ok[b, j, mine] & (j <= stop[b, mine])).sum())
    assert got == want
    assert want["contributing_in_skipped"] == 0
    assert want["skipped_by_box"] > 0 and want["skipped_by_warp_stop"] > 0
    assert want["unbounded_rows"] >= 8 > want["unbounded_rows_f32_box"]


def test_x4f_cull_counts_match_a_count_by_warp():
    """chip_smoke.x4f_cull_counts against a walk of each pixel through
    K1's loop at a quadrant's local pixels and csrc/blend16_fwd.cu's map
    (X4b's), on a quadrant table whose splats straddle the quadrants'
    borders: small ones, so that the box misses one of a quadrant's two
    warps, and in block 1 wide opaque ones, so that whole warps stop, one
    before the other of its quadrant."""
    rng = np.random.RandomState(22)
    nb, k = 2, 64
    tab = np.zeros((nb, k, 4, 16), np.float32)
    img = rng.uniform(-4, 36, (nb, k, 2))
    img[:, ::3] = 16.0 + rng.uniform(-3, 3, (nb, (k + 2) // 3, 2))
    for q in range(4):
        tab[:, :, q, 0:2] = img - 16.0 * np.array([q % 2, q // 2])
    inv = 1.0 / rng.uniform(0.5, 6.0, (nb, k)) ** 2
    inv[1, 20:] = 1.0 / rng.uniform(8.0, 30.0, k - 20) ** 2
    tab[..., 2] = inv[..., None]
    tab[..., 4] = (inv * rng.uniform(0.5, 2.0, (nb, k)))[..., None]
    tab[..., 3] = (0.2 * inv * rng.uniform(-1, 1, (nb, k)))[..., None]
    tab[..., 5] = rng.uniform(0.02, 0.4, (nb, k, 1))
    tab[1, 20:, :, 5] = 0.95
    tab[..., 6:9] = rng.rand(nb, k, 1, 3)
    d16c = torch.from_numpy(tab)
    counts = torch.tensor([64, 50, 0, 31, 64, 64, 23, 45], dtype=torch.int32)
    rows = tx4._quadrant_rows(d16c)
    got = cs.x4f_cull_counts(torch, blend_mod, rows, counts)

    owner, _ = quadrant_warp_of_pixel()
    lx, ly = tx4._local_pixels("cpu", torch.float32)
    terms = [blend_mod.pair_terms(rows[:, j], lx, ly) for j in range(k)]
    alpha = torch.stack([t[5] for t in terms], 1).numpy()
    ok = torch.stack([t[6] for t in terms], 1).numpy()
    stop = stop_index(alpha, ok, counts.numpy())
    x, y = lx[0].numpy(), ly[0].numpy()
    want = dict.fromkeys(got, 0)
    for j in range(int(counts.max())):
        box = blend_mod.entry_cull_boxes(rows[:, j]).numpy()
        for qi in range(4 * nb):
            if j >= counts[qi]:
                continue
            for w in range(2):
                mine = owner == w
                want["entry_warp_pairs"] += 1
                if (stop[qi, mine] < j).all():
                    want["skipped_by_warp_stop"] += 1
                elif (box[qi, 1] < x[mine].min() or box[qi, 0] > x[mine].max()
                      or box[qi, 3] < y[mine].min()
                      or box[qi, 2] > y[mine].max()):
                    want["skipped_by_box"] += 1
                else:
                    continue
                want["contributing_in_skipped"] += int(
                    (ok[qi, j, mine] & (j <= stop[qi, mine])).sum())
    assert got == want
    assert want["contributing_in_skipped"] == 0
    assert want["skipped_by_box"] > 0 and want["skipped_by_warp_stop"] > 0
    # The stop is the warp's own: some warp stops before the other warp of
    # its quadrant.
    warp_stop = np.stack([stop[:, owner == w].max(-1) for w in range(2)], 1)
    assert (warp_stop[:, 0] != warp_stop[:, 1]).any()


def test_issue_bound():
    """X2's issue-slot bound against hand-worked numbers: X2a's f32 chain
    (4 f32 instructions and a maximum per element and iteration) on
    [512, 64, 1024] x 256 iterations takes the issue slots,
    42.95 G / (132 x 128 x 1.98 GHz) = 1.2838 ms; a maximum at half rate
    does not bind; an exp chain of one MUFU.EX2 and 6 other instructions
    an element binds at the special-function rate, 16 per clock."""
    n = 512 * 64 * 1024
    clock = 1.98e9
    t, by = cs.issue_bound({"f32": 4, "minmax": 1}, n * 256, clock)
    assert by == "issue"
    assert t == pytest.approx(n * 256 * 5 / (132 * 128 * clock))
    assert round(t * 1e3, 4) == 1.2838
    # Two maximums (as if the compare took half the f32 rate): still the
    # issue slots, 6 of them.
    t2, _ = cs.issue_bound({"f32": 4, "minmax": 2}, n * 256, clock)
    assert t2 == pytest.approx(t * 6 / 5)
    # 1.074 G exps at 16 per clock: 0.2568 ms, above the issue slots'
    # 7 / 128 per element.
    t3, by3 = cs.issue_bound({"f32": 5, "int": 1, "mufu": 1}, n * 32, clock)
    assert by3 == "mufu"
    assert round(t3 * 1e3, 4) == 0.2568
    # An integer-heavy mix binds at the integer units' 64.
    t4, by4 = cs.issue_bound({"int": 3, "other": 1}, 1000, 1.0, sms=1)
    assert by4 == "int" and t4 == pytest.approx(1000 * 3 / 64)
    # Unlisted classes take issue slots only.
    t5, by5 = cs.issue_bound({"other": 256}, 1, 1.0, sms=1)
    assert by5 == "issue" and t5 == 2.0
    # X2's bounds price what the functions need: X2a f32 is the chain
    # above, and the built loops issue at least that in every class.
    assert cs.issue_bound(cs.X2_NEEDED[("chain", "float32")], n * 256,
                          clock) == (t, "issue")
    for key, need in cs.X2_NEEDED.items():
        assert all(cs.X2_SASS[key].get(c, 0) >= k for c, k in need.items())


# A SASS listing in cuobjdump's layout: a remainder loop (0x0040-0x0060)
# after a main loop unrolled twice (0x0000-0x0030), and a kernel's closing
# branch to itself.
SASS_LISTING = """
\t\tFunction : _ZN12_GLOBAL__N_116other_kernelEv
        /*0000*/                   FADD R1, R1, R1 ;          /* 0x0 */
        /*0010*/               @P0 BRA 0x0 ;                  /* 0x0 */
\t\tFunction : _ZN12_GLOBAL__N_116chain_f32_kernelEPKfPfxi
        /*0000*/                   FMUL R4, R7.reuse, R4 ;    /* 0x0 */
                                                              /* 0x0 */
        /*0010*/                   HFMA2.MMA R3, -RZ, RZ, 0, 0 ; /* 0x0 */
        /*0020*/                   FMNMX.NAN R7, R7, R6, !PT ; /* 0x0 */
        /*0030*/                   FFMA.SAT R4, R4, R4, 0.5 ; /* 0x0 */
        /*0040*/                   FMNMX.NAN R7, R7, R6, !PT ; /* 0x0 */
        /*0050*/                   ISETP.NE.AND P1, PT, R3, RZ, PT ; /* 0x0 */
        /*0060*/               @P1 BRA 0x0 ;                  /* 0x0 */
        /*0070*/                   HMUL2.BF16_V2 R6, R6, R3 ; /* 0x0 */
        /*0080*/               @P0 BRA 0x70 ;                 /* 0x0 */
        /*0090*/                   EXIT ;                     /* 0x0 */
        /*00a0*/                   BRA 0xa0;                  /* 0x0 */
"""


def test_sass_loop_counts():
    """sass_loop_counts takes the named function's longest backward-branch
    loop and divides it by its items, classing a move of a constant
    (HFMA2.MMA without .BF16_V2) as other."""
    got = cs.sass_loop_counts(SASS_LISTING, "chain_f32_kernel", "minmax", 1)
    assert got == {"f32": 1.0, "minmax": 1.0, "int": 0.5, "other": 1.0}
    assert cs.sass_class("HFMA2.MMA.BF16_V2") == "bf16x2"
    assert cs.sass_class("FMNMX.NAN") == "minmax"
    assert cs.sass_class("MUFU.EX2") == "mufu"
    assert cs.sass_class("F2FP.BF16.F32.PACK_AB") == "cvt"
    assert cs.sass_class("SHF.L.U32") == "int"
    assert cs.sass_class("MOV") == "other"


# ---------------------------------------------------------------------------
# The online phase's helpers: its in-memory sequence and the correction
# ops held against a CPU copy.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sequence():
    return synth_replica.SynthReplica(20, 64, 36, device="cpu",
                                      n_splats=3000)


def test_online_sequence(sequence):
    """The sequence's frames, camera and depth: the Replica camera scaled as
    ReplicaDataset scales it, and depth that back-projects onto the
    cylinder the frames show."""
    cam = sequence.camera
    assert len(sequence) == 20 and (cam.width, cam.height) == (64, 36)
    assert cam.fx == pytest.approx(600.0 * 64 / 1200)
    assert cam.cy == pytest.approx((339.5 + 0.5) * 36 / 680 - 0.5)
    # The chip's sequence: 120 frames, a keyframe every 10.
    assert len(range(0, cs.ONLINE_FRAMES, 10)) == cs.ONLINE_KEYFRAMES
    v, u = np.mgrid[0:36, 0:64]
    for i, fr in enumerate(sequence.frames()):
        assert fr.image.shape == (3, 36, 64) and fr.depth.shape == (36, 64)
        assert 0.0 <= fr.image.min() and fr.image.max() <= 1.0
        assert fr.filename == f"frame{i:06d}.jpg"
        np.testing.assert_allclose(
            cs_math.se3_inverse(cs_math.se3_matrix(fr.quat_wxyz, fr.trans)),
            sequence.c2w[i], atol=1e-9)
        x = (u - cam.cx) / cam.fx * fr.depth
        y = (v - cam.cy) / cam.fy * fr.depth
        pts = np.stack([x, y, fr.depth], -1).reshape(-1, 3)
        world = pts @ sequence.c2w[i][:3, :3].T + sequence.c2w[i][:3, 3]
        np.testing.assert_allclose(np.hypot(world[:, 0], world[:, 2]),
                                   synth_replica.CYL_R, atol=1e-3)
    assert sequence.c2w[0][:3, 3] == pytest.approx([0.0, 0.0, 0.0])


def online_mods():
    return dict(mapping_ops=mapping_ops, mapper=mapper_mod,
                Keyframe=Keyframe)


def test_correction_op_helpers(sequence):
    """loop_closing_op moves a keyframe past replica_rgbd's pose-delta
    test, scale_refinement_op scales and shifts the map, and the CPU twin
    that chip_smoke holds the card against gets the same map and moments
    from the same ops."""
    cfg = dataset_config("replica_rgbd")
    cfg.mapper.min_num_initial_map_kfs = 2
    mapper = mapper_mod.GaussianMapper(cfg, mapper_mod.SensorType.RGBD,
                                       device="cpu")
    mapper.add_camera(sequence.camera)
    tracker = GroundTruthTracker(sequence.camera, keyframe_every=10,
                                 num_keypoints=100)
    tracker.run(sequence.frames(), mapper.queue.push)
    mapper.combine_mapping_operations()
    mapper.initialize_mapping()
    mapper.trainer.opt_state = mapper.trainer.opt_state._replace(
        m=type(mapper.trainer.opt_state.m)(*(
            torch.ones_like(x) for x in mapper.trainer.opt_state.m)))
    m = online_mods()
    twin = cs.cpu_twin(torch, m, mapper)
    assert cs.map_rel_err(torch, mapper.trainer, twin.trainer) == 0.0
    assert twin.trainer.state.params.xyz is not mapper.trainer.state.params.xyz

    op = cs.loop_closing_op(m, mapper)
    kf = op.keyframes[0]
    assert kf.kfid == 0 and np.allclose(
        kf.trans - mapper.scene.keyframes[0].trans, cs.LOOP_SHIFT)
    assert max(cs.LOOP_SHIFT) > cfg.mapper.large_translation_threshold
    live = int(mapper.trainer.state.live.sum())
    moved = cs.apply_op(torch, mapper, op)
    assert 0 < moved <= live
    assert cs.apply_op(torch, twin, op) == moved
    assert cs.map_rel_err(torch, mapper.trainer, twin.trainer) == 0.0
    assert not mapper.trainer.opt_state.m.xyz.all()   # moments reset

    op = cs.scale_refinement_op(m)
    assert op.scale == cs.SCALE_OP[0]
    np.testing.assert_allclose(op.transform[:3, 3], cs.SCALE_OP[1], rtol=1e-7)
    assert cs.apply_op(torch, mapper, op) == live
    cs.apply_op(torch, twin, op)
    assert cs.map_rel_err(torch, mapper.trainer, twin.trainer) == 0.0
    np.testing.assert_allclose(mapper.scene.keyframes[1].trans,
                               twin.scene.keyframes[1].trans)


def test_rel_err():
    a = torch.tensor([1.0, -2.0, 4.0])
    assert cs.rel_err(torch, a, a) == 0.0
    assert cs.rel_err(torch, a + torch.tensor([0.0, 0.4, 0.0]),
                      a) == pytest.approx(0.1)
    assert cs.rel_err(torch, torch.tensor([0.5]),
                      torch.zeros(1)) == pytest.approx(0.5)


# ---------------------------------------------------------------------------
# The slam phase's helpers: the ATE it checks and ORB's keypoint agreement
# between two devices.
# ---------------------------------------------------------------------------

def test_trajectory_ate(sequence):
    gt = [cs_math.se3_matrix(f.quat_wxyz, f.trans)
          for f in sequence.frames()]
    assert cs.trajectory_ate(gt, gt) < 1e-12
    # A similarity of the whole trajectory aligns away.
    S = np.diag([2.0, 2.0, 2.0, 1.0])
    S[:3, 3] = [1.0, -2.0, 0.5]
    moved = [T @ np.linalg.inv(S) for T in gt]
    moved = [np.vstack([T[:3] / np.cbrt(np.linalg.det(T[:3, :3])),
                        [0, 0, 0, 1]]) for T in moved]
    assert cs.trajectory_ate(moved, gt) < 1e-9
    # A 1 cm offset of every other centre shows.
    noisy = [T.copy() for T in gt]
    for T in noisy[::2]:
        T[:3, 3] += T[:3, :3] @ np.array([0.01, 0.0, 0.0])
    assert 0.003 < cs.trajectory_ate(noisy, gt) < 0.01
    assert cs.SLAM_ATE_M == 0.05


def test_keypoint_agreement():
    from photo_slam_tpu_torch.tracking import vision

    rng = np.random.default_rng(0)
    gray = (rng.random((120, 160)) * 255).astype(np.uint8)
    a = vision.orb_detect_and_compute(gray, 300, torch.device("cpu"))
    assert len(a.px) > 50
    assert cs.keypoint_agreement(a, a) == (1.0, 1.0)
    # One keypoint moved by 1e-2 px and one descriptor bit flipped.
    px = a.px.copy()
    px[0, 0] += 1e-2
    desc = a.desc.copy()
    desc[1, 0] ^= 1
    b = a._replace(px=px, desc=desc)
    share, same = cs.keypoint_agreement(a, b)
    assert share == pytest.approx(1 - 1 / len(a.px))
    assert same == pytest.approx(1 - 1 / (len(a.px) - 1))
    # A level mismatch is no twin; a missing keypoint counts against.
    lvl = a.level.copy()
    lvl[2] = 7 - lvl[2]
    c = a._replace(level=lvl)
    assert cs.keypoint_agreement(a, c)[0] == pytest.approx(
        1 - 1 / len(a.px))
    d = a._replace(**{k: v[1:] for k, v in a._asdict().items()})
    assert cs.keypoint_agreement(a, d)[0] == pytest.approx(
        1 - 1 / len(a.px))
    assert cs.ms_stats([0.001, 0.002]).startswith("1.500 / ")


# ---------------------------------------------------------------------------
# The euroc phase's helpers: the gravity angle, the true-disparity share,
# the sgm kernel's bound and its row of the `kernels` line.
# ---------------------------------------------------------------------------

def test_gravity_error_deg():
    from photo_slam_tpu_torch.tracking.imu import so3_exp

    def op_rotation(axis_angle):
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = so3_exp(np.asarray(axis_angle, np.float64))
        return T

    # The first camera's frame is the truth's world: no rotation, no error.
    assert cs.gravity_error_deg([np.eye(4)], np.eye(3)) == pytest.approx(
        0.0, abs=1e-6)
    # An op that tilts the world by 5 degrees about x, against a truth
    # that needs none.
    assert cs.gravity_error_deg([op_rotation([np.radians(5), 0, 0])],
                                np.eye(3)) == pytest.approx(5.0, abs=1e-4)
    # Two ops compose; a first camera rotated by the same tilt is right.
    tilt = so3_exp(np.array([0.0, np.radians(3), 0.0]))
    ops = [op_rotation([0.0, np.radians(1), 0.0]),
           op_rotation([0.0, np.radians(2), 0.0])]
    assert cs.gravity_error_deg(ops, tilt.T) == pytest.approx(0.0,
                                                              abs=1e-4)
    assert cs.gravity_error_deg(ops, np.eye(3)) == pytest.approx(3.0,
                                                                 abs=1e-4)
    # A rotation about the gravity axis does not change the direction.
    assert cs.gravity_error_deg([op_rotation([0, 0, 0.7])],
                                np.eye(3)) == pytest.approx(0.0, abs=1e-4)


def test_true_disparity_share():
    depth = np.full((4, 5), 5.0)
    disp = np.full((4, 5), 458.0 * 0.11 / 5.0)
    disp[0] = -1.0                  # invalid: not counted
    disp[1, :2] += 1.5              # valid, beyond 1 px
    disp[2, 0] += 0.9               # valid, within
    share, valid = cs.true_disparity_share(disp, depth, 458.0, 0.11)
    assert valid == pytest.approx(15 / 20)
    assert share == pytest.approx(13 / 15)
    assert cs.true_disparity_share(np.full((2, 2), -1.0), depth[:2, :2],
                                   458.0, 0.11) == (0.0, 0.0)


def test_sgm_bound_and_row():
    """The bound prices EuRoC's volume by its bytes (int16 read, int16
    written, 0.0458 ms at 3.35 TB/s; 0.0687 ms with the first design's
    int32 sum); the row has every key of the contract."""
    ms, by = cs.sgm_bound(480, 752 - 128)
    n = 480 * 624 * 128
    assert by == "bytes" and ms == pytest.approx(1e3 * 4 * n / 3.35e12)
    assert round(ms, 4) == 0.0458
    earlier = cs.sgm_bound(480, 624, sum_bytes=4)[0]
    assert earlier == pytest.approx(1e3 * 6 * n / 3.35e12)
    assert round(earlier, 4) == 0.0687
    assert cs.SGM_PATHS * cs.SGM_OPS_PER_STEP * n / cs.PEAK_F32_FLOPS < \
        4 * n / cs.PEAK_BYTES
    paths = {"train": {"blend_fwd": 23}, "euroc": {"sgm": 120,
                                                   "blend_fwd": 1040}}
    row = cs.kernel_row(paths, "sgm", "photo_slam_tpu_torch/csrc/sgm.cu",
                        "photo_slam_tpu/mapper/mapper.py:342", 120, 0, 0.5,
                        900.0, (ms, by), None, replaces_what=cs.SGM_REPLACES,
                        design=cs.SGM_DESIGN, earlier_design=cs.SGM_EARLIER,
                        launches_per_frame=1.0)
    for key in ("name", "route", "source", "replaces", "launches",
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms"):
        assert key in row, key
    assert row["route"] == "cuda" and row["library_ms"] is None
    assert row["launches_by_path"] == {"train": 0, "euroc": 120}
    assert row["bound_ms"] == ms and row["bound_by"] == "bytes"
    assert "StereoSGBM" in row["replaces_what"]
    # Descriptions of the designs, with no times (PERF.md holds those).
    for key in ("design", "earlier_design"):
        assert row[key] and " ms" not in row[key]
    assert cs.EUROC_ATE_M == 0.05 and cs.EUROC_FRAMES == 120
    assert cs.EUROC_ITERS == cs.ONLINE_ITERS == 1000


# ---------------------------------------------------------------------------
# The viewer and batched phases' helpers: the split of a /render request
# into its stages, the served PNG against render_from_pose's image, and the
# launches of the batched step.
# ---------------------------------------------------------------------------

def test_request_stages():
    from photo_slam_tpu_torch.utils.profiling import Profiler

    prof = Profiler()
    for dt in (0.001, 0.003):
        for i, stage in enumerate(cs.VIEWER_STAGES):
            prof.record(stage, dt * (i + 1))
    got = cs.request_stages(prof.summary(), 2)
    assert list(got) == list(cs.VIEWER_STAGES)
    for i, stage in enumerate(cs.VIEWER_STAGES):
        assert got[stage] == pytest.approx(2.0 * (i + 1))
    # A request counted in one stage and not another, or a stage missing.
    with pytest.raises(AssertionError, match="lock_wait timed 2 times"):
        cs.request_stages(prof.summary(), 3)
    prof.record("viewer.d2h", 0.001)
    with pytest.raises(AssertionError, match="viewer.d2h timed 3"):
        cs.request_stages(prof.summary(), 2)
    del prof.spans["viewer.lock_wait"]
    with pytest.raises(AssertionError, match="lock_wait timed 0"):
        cs.request_stages(prof.summary(), 2)


def test_png_levels_apart():
    """The served PNG (the viewer's own encoder) against a render: 0 levels
    for the same image, 1 for a pixel one level off, None for another
    size."""
    from photo_slam_tpu_torch.io.images import decode_png
    from photo_slam_tpu_torch.viewer import server

    img = np.random.RandomState(5).rand(3, 20, 30).astype(np.float32)
    img[0, 0, 0], img[1, 2, 3] = -0.5, 1.5   # clipped as the viewer clips
    body = server._to_png(img)
    np.testing.assert_array_equal(decode_png(body), cs.viewer_pixels(img))
    assert cs.png_levels_apart(decode_png, body, img) == 0
    off = img.copy()
    off[2, 5, 7] = np.clip(off[2, 5, 7] + 1.0 / 255.0, 0, 1) if (
        off[2, 5, 7] < 0.99) else off[2, 5, 7] - 1.0 / 255.0
    assert cs.png_levels_apart(decode_png, body, off) == 1
    assert cs.png_levels_apart(decode_png, body, img[:, :, :29]) is None


def test_render_path_keeps_every_bit():
    import urllib.parse

    q = (0.9987654321012345, -0.01, 0.0493, 1e-17)
    t = (0.1 + 0.2, -3.0, 1 / 3)
    qs = urllib.parse.parse_qs(urllib.parse.urlparse(
        cs.render_path(q, t, 1000, 600)).query)
    assert [float(qs[k][0]) for k in ("qw", "qx", "qy", "qz")] == list(q)
    assert [float(qs[k][0]) for k in ("tx", "ty", "tz")] == list(t)
    assert (int(qs["w"][0]), int(qs["h"][0])) == (1000, 600)


def test_check_batched_launches():
    ok = {"blend_fwd": 92, "blend_bwd": 92, "window_gather": 92}
    cs.check_batched_launches(ok, 23, 4)
    with pytest.raises(AssertionError, match="blend_bwd launched 91"):
        cs.check_batched_launches({**ok, "blend_bwd": 91}, 23, 4)
    with pytest.raises(AssertionError, match="window_gather launched 23"):
        cs.check_batched_launches({**ok, "window_gather": 23}, 23, 4)
    with pytest.raises(AssertionError, match="blend_fwd launched None"):
        cs.check_batched_launches({"blend_bwd": 92, "window_gather": 92},
                                  23, 4)


def test_collective_path():
    assert cs.collective_path("nccl", "cuda:0") == "nccl, card to card"
    assert "staged through host memory by gloo" in cs.collective_path(
        "gloo", "cuda:0")
    assert cs.collective_path("gloo", "cpu") == "gloo on host tensors"


def test_sum_launches_over_the_ranks():
    ranks = [{"blend_fwd": 30, "blend_bwd": 12, "window_gather": 31},
             {"blend_fwd": 30, "blend_bwd": 12, "window_gather": 31},
             {"blend_fwd": 5, "blend_bwd": 2, "window_gather": 5}]
    assert cs.sum_launches(ranks) == {"blend_fwd": 65, "blend_bwd": 26,
                                      "window_gather": 67}


def test_sharded_bytes_by_hand():
    """The room over 2 ranks: 150,000 rows a rank, bands of 352 px."""
    b = cs.sharded_bytes(150_000, 2, 352, 1200)
    bands = 2 * 3 * 352 * 1200 * 4
    assert b["band_render"] == {"all_gather": bands}
    assert b["gp_step"] == {"all_gather": 7_200_000 + bands,
                            "reduce_scatter": 6_000_000, "all_reduce": 12}
    # 59 parameters + 2 view-space gradient values + the loss, then radii
    # and visibility.
    assert cs.sharded_bytes(300_000, 2, 352, 1200)["view_step"] == {
        "all_reduce": 4 * (1 + 300_000 * 61) + 8 * 300_000}


def test_check_twins():
    cs.check_twins("step", {"xyz": (1e-5, 0.0, 2.0),
                            "xyz_grad_accum": (5e-5,)}, 1e-4)
    with pytest.raises(AssertionError, match="xyz: update error"):
        cs.check_twins("step", {"xyz": (0.0, 2e-4, 1.0)}, 1e-4)
    with pytest.raises(AssertionError, match="xyz_grad_accum: error"):
        cs.check_twins("NCCL step", {"xyz_grad_accum": (1e-9,)}, 0.0)


def test_twin_errors():
    """bench_room.twin_errors on a fresh Adam step (the yardstick of
    chip_smoke's compare_steps and of sharded_room): zero against itself;
    a gradient off by d reads as d / max, and an update that the sign of a
    tiny gradient flips is not compared."""
    from photo_slam_tpu_torch.models import gaussian_model as tgm
    from photo_slam_tpu_torch.models import optimizer as toptim
    from photo_slam_tpu_torch.tools import sharded_room as sr

    cap = 8
    p0 = tgm.empty_state(cap, 0, device="cpu").params
    g = tgm.GaussianParams(*(torch.linspace(-1, 1, x.numel()).reshape(
        x.shape) for x in p0))
    lrs = toptim.LearningRates.create(*sr.LRS)
    acc = torch.arange(cap, dtype=torch.float32)

    def step(grads):
        params = tgm.GaussianParams(*(x.clone() for x in p0))
        p, o = toptim.adam_step(params, grads, toptim.init_adam(params), lrs,
                                torch.ones(cap, dtype=torch.bool))
        return bench_room.step_outcome(o, p, p0, acc)

    def errors(a, b):
        return bench_room.twin_errors(a, b, sr.TWIN_RTOL)

    ref = step(g)
    errs = errors(ref, ref)
    assert all(e[:2] == (0.0, 0.0) for k, e in errs.items()
               if k != "xyz_grad_accum")
    assert errs["xyz_grad_accum"] == (0.0,)
    assert bench_room.spread(errs) == 0.0
    off = g.xyz.clone()
    off[0, 0] += 0.01
    errs = errors(step(g._replace(xyz=off)), ref)
    assert errs["xyz"][0] == pytest.approx(0.01, rel=1e-4)
    assert bench_room.spread(errs) == pytest.approx(0.01, rel=1e-4)
    tiny = g.quats.clone()
    tiny[0, 0] = 1e-9   # the reference's gradient is -1e-9 there
    flipped = g._replace(quats=torch.where(tiny == 1e-9, -1e-9, tiny))
    assert errors(step(g._replace(quats=tiny)), step(flipped))["quats"][1] \
        == 0.0
    more = acc.clone()
    more[1] += 0.7   # of a max of 7
    assert errors((*ref[:2], more), ref)["xyz_grad_accum"][0] == \
        pytest.approx(0.1)


def test_caps_that_do_not_bind():
    """On the dry run's scene at 128x96: at the caps no Gaussian is
    clipped and no tile overflows; one tile fewer a Gaussian clips."""
    from photo_slam_tpu_torch.parallel import dryrun
    from photo_slam_tpu_torch.tools import sharded_room as sr

    state = dryrun.make_scene(n=3000, device="cpu")[0]
    view = bench_room.map_view(state, device="cpu", width=128, height=96)
    k, mpt = sr.caps_that_do_not_bind(view.prep, view.extents, 128, 96)
    assert mpt % 256 == 0

    def bins(k_dup, max_per_tile):
        return bench_room.bin_view(view, 32, k_dup, max_per_tile)

    b = bins(k, mpt)
    assert int(b.num_clipped) == 0 and int(b.num_overflow) == 0
    assert int(b.raw_counts.max()) > mpt - 256
    assert int(bins(k - 1, mpt).num_clipped) > 0
