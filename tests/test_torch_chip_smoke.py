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
and the correction ops it makes and its CPU twin; and the mono and tum
phases': the method log, the two-view calls' log and line, the mono
harvest's count of points, the scale of
the similarity alignment, the SE3-aligned ATE and the TUM tree read back;
and the euroc phase's:
the gravity angle, the share of disparities near the truth, the sgm
kernel's bound and its row of the `kernels` line; and the viewer and
batched phases': the stages of a /render request, the client run at a
request count and the render-lock waits, a served PNG against a render,
the /render query, the map sizes of the render graphs and the batched
step's launch check; and the
sharded phase's: the collective path, the ranks' launches summed, the
bytes of each collective, the twin checks and the caps that do not
bind; and the colmap and attr phases': the call counter they count
densify events and capacity growths with, the colmap run's checks and
line, and the numbers of an attribution they hold finite; and the graph
phase's: the swap that runs the graphed entry points op by op (their
eager twins, also inside plain_kernels) and the bit-equality check of two
results."""
import time

import numpy as np
import pytest
import torch

import chip_smoke as cs
from photo_slam_tpu_torch.config import dataset_config
from photo_slam_tpu_torch.mapper import mapper as mapper_mod
from photo_slam_tpu_torch.mapper import mapping_ops
from photo_slam_tpu_torch.models import gaussian_model as tgm
from photo_slam_tpu_torch.models import optimizer as toptim
from photo_slam_tpu_torch.models.keyframe import Keyframe
from photo_slam_tpu_torch.ops import blend as blend_mod
from photo_slam_tpu_torch.tools import bench_room, time_blend
from photo_slam_tpu_torch.tools import exp_blend16 as tx4
from photo_slam_tpu_torch.tools import exp_blend_bf16 as tx1
from photo_slam_tpu_torch.tools import synth_replica
from photo_slam_tpu_torch.tracking import vision
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
    twin = cs.twin_mapper(torch, m, mapper, "cpu")
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
    # The rigid alignment (a metric sensor's) does not align a scale away,
    # but does a rigid motion.
    assert cs.trajectory_ate(moved, gt, with_scale=False) > 0.1
    rigid = [T @ np.linalg.inv(np.vstack([S[:3] / 2.0, [0, 0, 0, 1]]))
             for T in gt]
    assert cs.trajectory_ate(rigid, gt, with_scale=False) < 1e-9


def test_keypoint_agreement():
    from photo_slam_tpu_torch.tracking import vision

    rng = np.random.default_rng(0)
    gray = (rng.random((120, 160)) * 255).astype(np.uint8)
    a = vision.orb_detect_and_compute(gray, 300, torch.device("cpu"))
    assert len(a.px) > 50
    assert cs.keypoint_agreement(a, a) == (1.0, 1.0)
    assert cs.ORB_AGREEMENT == 1.0 and cs.ORB_PX_TOL == 0.0
    # One keypoint moved by one float32 ulp, one descriptor bit flipped,
    # one response and one angle off by an ulp.
    px = a.px.copy()
    px[0, 0] = np.nextafter(px[0, 0], np.float32(np.inf))
    desc = a.desc.copy()
    desc[1, 0] ^= 1
    resp, angle = a.resp.copy(), a.angle.copy()
    resp[2] = np.nextafter(resp[2], np.float32(np.inf))
    angle[3] = np.nextafter(angle[3], np.float32(0))
    b = a._replace(px=px, desc=desc, resp=resp, angle=angle)
    share, same = cs.keypoint_agreement(a, b)
    assert share == pytest.approx(1 - 1 / len(a.px))
    assert same == pytest.approx(1 - 3 / (len(a.px) - 1))
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


def test_orb_digest():
    """orb_digest hashes the rows in the order returned: two rows swapped
    change it, as one bit of any field does; same_features holds two
    feature sets index for index."""
    from photo_slam_tpu_torch.tracking import vision

    rng = np.random.default_rng(1)
    gray = (rng.random((120, 160)) * 255).astype(np.uint8)
    a = vision.orb_detect_and_compute(gray, 300, torch.device("cpu"))
    digest = cs.orb_digest(a)
    assert len(digest) == 64 and cs.orb_digest(a._replace()) == digest
    assert cs.same_features(a, a._replace())
    perm = np.arange(len(a.px))
    perm[[3, 4]] = perm[[4, 3]]
    swapped = a._replace(**{k: v[perm] for k, v in a._asdict().items()})
    assert cs.orb_digest(swapped) != digest
    assert not cs.same_features(a, swapped)
    assert cs.keypoint_agreement(a, swapped) == (1.0, 1.0)
    for name in vision.OrbFeatures._fields:
        x = getattr(a, name).copy()
        x.view(np.uint8).reshape(-1)[-1] ^= 1
        assert cs.orb_digest(a._replace(**{name: x})) != digest, name
        assert not cs.same_features(a, a._replace(**{name: x})), name


def test_retain_best_agreement():
    """The retainBest line's helper passes the shim against its plain twin
    on every case and counts a case whose output has two indices swapped;
    the digests cover the order."""
    from photo_slam_tpu_torch.tracking import vision

    cases = cs.retain_best_cases(vision)
    assert len(cases) > 100 and {len(r) for r, _ in cases} == set(
        cs.RETAIN_SIZES) | set(cs.RETAIN_KILLERS)
    differ, got, want = cs.retain_best_agreement(
        vision.retain_best, vision.retain_best_plain, cases)
    assert differ == 0 and got == want and len(got) == 64
    target = next(i for i, (r, k) in enumerate(cases)
                  if len(r) == 1000 and 1 < k < len(r))

    def swapped(r, k):
        out = vision.retain_best_plain(r, k)
        if r is cases[target][0] and k == cases[target][1]:
            out[[0, 1]] = out[[1, 0]]
        return out

    differ, got, want = cs.retain_best_agreement(vision.retain_best,
                                                 swapped, cases)
    assert differ == 1 and got != want


def test_pnp_fixture_constants_are_opencvs():
    """chip_smoke.py holds the card host's solve_pnp_ransac to PNP_SHA256
    and PNP_POSES (no OpenCV on the card's machine): cv2.solvePnPRansac on
    pnp_fixture_problems gives them, and so does the port on the CPU; and
    the fixture's check passes here."""
    cv2 = pytest.importorskip("cv2")
    from photo_slam_tpu_torch.tracking import vision

    problems = cs.pnp_fixture_problems(vision)
    assert [len(p[0]) for p in problems] == [f[3] for f in cs.PNP_FIXTURE]
    want = []
    for X, px, K, guess, thr, iters in problems:
        r0, t0 = ((None, None) if guess is None else
                  (guess[0].reshape(3, 1).copy(), guess[1].reshape(3, 1).copy()))
        want.append(cv2.solvePnPRansac(X, px, K, None, r0, t0,
                                       guess is not None, iters, thr, 0.99,
                                       None, cv2.SOLVEPNP_ITERATIVE))
    assert cs.pnp_digest(want) == cs.PNP_SHA256
    got = [cs.solve_fixture(vision, p) for p in problems]
    assert cs.pnp_digest(got) == cs.PNP_SHA256
    for (_, r, t, _), (_, gr, gt, _), pose in zip(want, got, cs.PNP_POSES):
        np.testing.assert_allclose(np.concatenate([r.ravel(), t.ravel()]),
                                   pose, rtol=0, atol=cs.PNP_POSE_TOL)
        np.testing.assert_allclose(np.concatenate([gr.ravel(), gt.ravel()]),
                                   pose, rtol=0, atol=cs.PNP_POSE_TOL)
    cs.pnp_fixture(vision, "cpu")


def test_essential_fixture_constants_are_opencvs():
    """chip_smoke.py holds the card host's find_essential_mat, recover_pose
    and triangulate_points to ESSENTIAL_SHA256 and ESSENTIAL_POSES (no
    OpenCV on the card's machine): cv2.findEssentialMat(RANSAC),
    cv2.recoverPose and cv2.triangulatePoints on
    essential_fixture_problems give them, and so does the port on the
    CPU; and the fixture's check passes here."""
    cv2 = pytest.importorskip("cv2")
    from photo_slam_tpu_torch.tracking import vision

    problems = cs.essential_fixture_problems(vision)
    assert [len(p[0]) for p in problems] == [f[0] for f in
                                             cs.ESSENTIAL_FIXTURE]
    want = []
    for p0, p1, K in problems:
        E, mask = cv2.findEssentialMat(p0, p1, K, cv2.RANSAC, 0.999, 1.0)
        if E.shape != (3, 3):
            want.append((E, mask, None))
            continue
        n, R, t, pose_mask = cv2.recoverPose(E, p0, p1, K, mask=mask.copy())
        m = pose_mask.ravel() > 0
        pts = cv2.triangulatePoints(K @ np.eye(4)[:3],
                                    K @ np.concatenate([R, t], 1),
                                    p0[m].T, p1[m].T)
        want.append((E, mask, (n, R, t, pose_mask, pts)))
    assert cs.essential_digest(want) == cs.ESSENTIAL_SHA256
    assert [r[2] is None for r in want] == [False, False, False, True]
    got = [cs.solve_two_view(vision, p) for p in problems]
    assert cs.essential_digest(got) == cs.ESSENTIAL_SHA256
    poses = [r for r in zip(want, got) if r[0][2] is not None]
    assert len(poses) == len(cs.ESSENTIAL_POSES)
    for (a, b), pose in zip(poses, cs.ESSENTIAL_POSES):
        for r in (a, b):
            np.testing.assert_allclose(
                np.concatenate([r[2][1].ravel(), r[2][2].ravel()]), pose,
                rtol=0, atol=cs.ESSENTIAL_POSE_TOL)
    cs.essential_fixture(vision, "cpu")


def test_essential_digest():
    """essential_digest sees E, both masks, the count and the points, and
    takes OpenCV's None for no points as empty."""
    rng = np.random.default_rng(0)
    pose = (3, np.eye(3), np.zeros((3, 1)), np.ones((4, 1), np.uint8),
            rng.normal(size=(4, 3)))
    base = [(rng.normal(size=(3, 3)), np.ones((4, 1), np.uint8), pose)]
    digest = cs.essential_digest(base)
    E, mask, _ = base[0]
    for changed in ((np.nextafter(E, 2.0), mask, pose), (E, mask * 0, pose),
                    (E, mask, (4,) + pose[1:]),
                    (E, mask, pose[:3] + (pose[3] * 0, pose[4])),
                    (E, mask, pose[:4] + (pose[4] * 2,)), (E, mask, None)):
        assert cs.essential_digest([changed]) != digest
    empty = pose[:4] + (np.zeros((4, 0)),)
    assert cs.essential_digest([(E, mask, empty)]) == \
        cs.essential_digest([(E, mask, pose[:4] + (None,))])


def test_pnp_digest():
    """pnp_digest sees the ok flags, every inlier and a missing set."""
    ok = (True, None, None, np.arange(5, dtype=np.int32).reshape(-1, 1))
    digest = cs.pnp_digest([ok])
    assert len(digest) == 64
    assert cs.pnp_digest([(False,) + ok[1:]]) != digest
    assert cs.pnp_digest([ok[:3] + (ok[3][:4],)]) != digest
    assert cs.pnp_digest([ok[:3] + (None,)]) != digest


# ---------------------------------------------------------------------------
# The mono and tum phases' helpers: the method log, the harvest's count of
# points, the similarity's scale and the TUM tree read back.
# ---------------------------------------------------------------------------

def test_logged_calls():
    class Box:
        def __init__(self):
            self.n = 0

        def add(self, k):
            if k < 0:
                raise ValueError(k)
            self.n += k
            return self.n

    saved = Box.add
    box = Box()
    with cs.logged_calls(Box, "add", lambda obj, a, out, sec, n0: (
            a, out, obj.n - n0, sec >= 0), lambda obj: obj.n) as calls:
        box.add(2)
        box.add(k=3)
        with pytest.raises(ValueError):
            box.add(-1)
    assert calls == [((2,), 2, 2, True), ((), 5, 3, True)]
    assert Box.add is saved
    with pytest.raises(RuntimeError):
        with cs.logged_calls(Box, "add", lambda *a: None):
            raise RuntimeError
    assert Box.add is saved


def test_two_view_calls_and_summary():
    """two_view_calls logs each find_essential_mat call (seconds, inliers,
    matches) and each recover_pose's count, through the module attribute
    the frontend calls, and puts both functions back; two_view_summary
    prints them."""
    rng = np.random.default_rng(4)
    K = np.array([[300.0, 0.0, 160.0], [0.0, 300.0, 120.0], [0, 0, 1]])
    X = np.stack([rng.uniform(-2, 2, 120), rng.uniform(-1.5, 1.5, 120),
                  rng.uniform(4, 6, 120)], 1)
    R, t = vision.rodrigues([0.0, 0.05, 0.0]), np.array([0.3, 0.0, 0.05])
    p0 = X[:, :2] / X[:, 2:] * 300.0 + K[:2, 2]
    Xc = X @ R.T + t
    p1 = Xc[:, :2] / Xc[:, 2:] * 300.0 + K[:2, 2]
    p1[:20] = rng.uniform([0, 0], [320, 240], (20, 2))
    saved = vision.find_essential_mat, vision.recover_pose
    with cs.two_view_calls(vision) as (essential, poses):
        E, mask = vision.find_essential_mat(p0, p1, K, prob=0.999,
                                            threshold=1.0)
        n_ok = vision.recover_pose(E, p0, p1, K, mask=mask)[0]
        assert vision.find_essential_mat(p0[:4], p1[:4], K) == (None, None)
    assert (vision.find_essential_mat, vision.recover_pose) == saved
    assert [(n, m) for _, n, m in essential] == [
        (int(mask.sum()), 120), (0, 4)]
    assert all(sec > 0 for sec, _, _ in essential)
    assert poses == [n_ok] and 90 <= n_ok <= 100
    line = cs.two_view_summary(essential, poses)
    assert line.startswith("find_essential_mat 2 calls, ")
    assert f"inliers [{int(mask.sum())}, 0] of [120, 4] matches" in line
    assert line.endswith(f"recover_pose n_ok [{n_ok}]")
    assert cs.two_view_summary([], []) == "find_essential_mat not called"


@pytest.mark.parametrize("max_depth_cached", [10, 1])
def test_harvest_calls_count_the_mono_harvest(sequence, max_depth_cached):
    """harvest_calls counts the points each keyframe's harvest adds, also
    when the depth cache is flushed into the map's cached points: the GT
    tracker's mono drive with depth in stripes, so that half the keypoints
    borrow a neighbour's depth (mono_neighbor_densify)."""
    cfg = dataset_config("replica_mono")
    cfg.mapper.max_depth_cached = max_depth_cached
    mapper = mapper_mod.GaussianMapper(cfg, mapper_mod.SensorType.MONOCULAR,
                                       device="cpu")
    mapper.add_camera(sequence.camera)
    stripes = (np.arange(sequence.camera.width) // 8) % 2 == 1
    frames = [fr.__class__(**{**fr.__dict__,
                              "depth": np.where(stripes, fr.depth, 0.0)})
              for fr in sequence.frames()]
    ops = []
    GroundTruthTracker(sequence.camera, keyframe_every=5,
                       num_keypoints=400).run(iter(frames), ops.append)
    for op in ops:
        mapper.queue.push(op)
    with cs.harvest_calls(mapper_mod.GaussianMapper) as calls:
        mapper.combine_mapping_operations()
    assert [fid for fid, _, _ in calls] == [0, 1, 2, 3]
    rows = [n for _, n, _ in calls]
    assert all(n > 0 for n in rows) and all(s > 0 for _, _, s in calls)
    if max_depth_cached == 10:
        assert rows == [len(p) for p in mapper._depth_cache_pts]
    else:
        assert not mapper._depth_cache_pts
        cached = sum(len(p) for p in mapper._cached_points)
        assert sum(rows) == cached - sum(len(op.points) for op in ops)


def test_trajectory_scale(sequence):
    gt = [cs_math.se3_matrix(f.quat_wxyz, f.trans)
          for f in sequence.frames()]
    assert cs.trajectory_scale(gt, gt) == pytest.approx(1.0, abs=1e-12)
    # A map in units of 2.5 m: centres and translations divided by 2.5.
    small = [np.vstack([np.hstack([T[:3, :3], T[:3, 3:] / 2.5]),
                        [0, 0, 0, 1]]) for T in gt]
    assert cs.trajectory_scale(small, gt) == pytest.approx(2.5, rel=1e-9)
    assert cs.trajectory_ate(small, gt) < 1e-9


def test_tum_readback(sequence, tmp_path):
    """write_tum's tree reads back whole: every frame associated, the
    depth to the unit, the poses; a depth map one unit off shows."""
    from photo_slam_tpu_torch.io import datasets, images

    m = dict(synth_replica=synth_replica, datasets=datasets,
             se3_matrix=cs_math.se3_matrix)
    root = sequence.write_tum(tmp_path / "tum")
    pairs, units, pose = cs.tum_readback(m, sequence, root)
    assert (pairs, units) == (20, 0) and pose < 1e-9
    _, (name,) = datasets._read_tum_list(root / "depth.txt")[3]
    images.write_png(root / name, images.read_png(root / name) + 1)
    assert cs.tum_readback(m, sequence, root)[1] == 1


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


def test_viewer_client_run_and_lock_waits(monkeypatch):
    """viewer_client_run serves exactly `requests` /render requests while
    the mapper steps, and fails on a bad answer; lock_waits reads the
    viewer's and the mapper's render-lock spans."""
    from types import SimpleNamespace

    from photo_slam_tpu_torch.io import images
    from photo_slam_tpu_torch.utils.profiling import Profiler

    served, steps = [], []
    answer = [(200, images.PNG_SIGNATURE + b"x", "image/png")]

    def get(port, path, timeout=120):
        served.append(path)
        time.sleep(0.002)
        return answer[0]

    def step():
        steps.append(1)
        time.sleep(0.001)

    monkeypatch.setattr(cs, "http_get", get)
    mapper = SimpleNamespace(profiler=Profiler())
    server = SimpleNamespace(port=1, profiler=Profiler())
    host = SimpleNamespace(cuda=SimpleNamespace(synchronize=lambda: None))
    mapper.profiler.record("mapper.lock_wait", 1.0)   # cleared first
    times, it_s = cs.viewer_client_run(host, mapper, server, "/render?q",
                                       step, images, requests=5)
    assert len(times) == 5 and served == ["/render?q"] * 5
    assert steps and it_s > 0 and not mapper.profiler.spans
    answer[0] = (500, b"", "text/plain")
    with pytest.raises(AssertionError, match="failures"):
        cs.viewer_client_run(host, mapper, server, "/render?q", step,
                             images, requests=2)
    server.profiler.record("viewer.lock_wait", 0.002)
    server.profiler.record("viewer.lock_wait", 0.004)
    mapper.profiler.record("mapper.lock_wait", 0.001)
    assert cs.lock_waits(server, mapper) == (
        "viewer 3.0000 / 4.0000 ms over 2, mapper 1.0000 / 1.0000 ms "
        "over 1")


def test_render_graph_rows():
    """The map sizes of a render graph cache's entries, read from their
    keys."""
    from photo_slam_tpu_torch.utils import graphs

    cache = graphs.GraphCache()
    for rows in (8, 8, 16):
        fresh = (torch.zeros(rows, 3), torch.zeros(4, 4))
        cache.entry(cache.key_of(("render", rows, len(cache)), fresh),
                    lambda: None)
    assert cs.render_graph_rows(cache) == {8, 16}


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
    ok = {"blend_fwd": 92, "blend_bwd": 92, "window_gather": 92,
          "entry_sum": 92}
    cs.check_batched_launches(ok, 23, 4)
    with pytest.raises(AssertionError, match="blend_bwd launched 91"):
        cs.check_batched_launches({**ok, "blend_bwd": 91}, 23, 4)
    with pytest.raises(AssertionError, match="window_gather launched 23"):
        cs.check_batched_launches({**ok, "window_gather": 23}, 23, 4)
    with pytest.raises(AssertionError, match="entry_sum launched 0"):
        cs.check_batched_launches({**ok, "entry_sum": 0}, 23, 4)
    with pytest.raises(AssertionError, match="blend_fwd launched None"):
        cs.check_batched_launches({"blend_bwd": 92, "window_gather": 92,
                                   "entry_sum": 92}, 23, 4)


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


def test_check_twins_with_an_update_tolerance():
    """The sharded phase's form: gradients within rtol, updates within
    update_rtol."""
    errs = {"features_dc": (3e-7, 1.2e-5, 1.0), "xyz_grad_accum": (1e-7,)}
    cs.check_twins("two ranks", errs, 1e-6, 1e-4)
    with pytest.raises(AssertionError, match="features_dc: update error"):
        cs.check_twins("two ranks", errs, 1e-6)
    with pytest.raises(AssertionError, match="features_dc: gradient error"):
        cs.check_twins("two ranks", {"features_dc": (2e-6, 0.0, 1.0)}, 1e-6,
                       1e-4)


def test_state_tensors_and_check_bit_equal():
    """Every tensor of a map and its Adam state, compared bit for bit."""
    import torch

    from photo_slam_tpu_torch.models import gaussian_model as tgm
    from photo_slam_tpu_torch.models import optimizer as toptim

    pts = np.random.RandomState(0).rand(20, 3).astype(np.float32) + [0, 0, 4]
    st = tgm.create_from_pcd(pts, np.full((20, 3), 0.5, np.float32),
                             sh_degree=1, capacity=32, device="cpu")
    opt = toptim.init_adam(st.params)
    a = cs.state_tensors(st, opt)
    assert len(a) == 6 + 5 + 6 + 6 + 1
    cs.check_bit_equal(torch, "same", a, cs.state_tensors(
        tgm.clone_state(st), opt))
    moved = st._replace(denom=st.denom + 1.0)
    with pytest.raises(AssertionError, match=r"not bit-equal in \['denom'\]"):
        cs.check_bit_equal(torch, "moved", a, cs.state_tensors(moved, opt))


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


def test_entry_sum_bytes_and_planted_ids():
    """The entry transpose's bound counts the table's ids, two sectors a
    valid row and the output (~0.0153 ms on the room's pass-1 table); the
    planted table holds one repeat and one id past the last, each of which
    the plain version refuses on the CPU; check_repeats passes on zero
    counters and fails on any other."""
    from photo_slam_tpu_torch.ops import tiled

    nbytes, design = cs.entry_sum_bytes(836 * 1024, 446_476, 300_000, 6)
    assert nbytes == 51_198_720
    assert design == nbytes + 2 * 7_200_000 + 4 * 446_476
    assert cs.bound(0, nbytes) == (pytest.approx(0.015283, abs=1e-6),
                                   "bytes")
    n, k_dup = 8, 3
    ids = torch.tensor([5, -1, 0, 7, 23, -1, 2], dtype=torch.int32)
    bad = cs.plant_bad_ids(torch, ids, n * k_dup)
    assert bad.tolist() == [5, -1, 5, 24, 23, -1, 2]
    g = torch.zeros((7, 16))
    with pytest.raises(ValueError, match="repeated"):
        tiled.entry_sum_plain(g, torch.where(bad == 24, -1, bad), k_dup, n)
    with pytest.raises(ValueError, match="out of range"):
        tiled.entry_sum_plain(g, bad, k_dup, n)

    class Wrapper:
        repeats = {0: torch.zeros(1, dtype=torch.int32)}

    cs.check_repeats({"entry_sum": Wrapper, "blend_fwd": object()})
    Wrapper.repeats[0] += 1
    with pytest.raises(AssertionError, match="counted 1 repeated"):
        cs.check_repeats({"entry_sum": Wrapper})


def test_counting_calls_counts_and_puts_back():
    """counting_calls wraps each named function for the block (the colmap
    and trainer phases count densify events and capacity growths so) and
    puts the originals back, also when the block raises."""
    from photo_slam_tpu_torch.mapper import trainer as trainer_mod
    from photo_slam_tpu_torch.models import gaussian_model as gm

    densify, grow = trainer_mod.densify_step, gm.grow_capacity
    state = gm.create_from_pcd(np.zeros((3, 3), np.float32),
                               np.zeros((3, 3), np.float32), sh_degree=0,
                               capacity=4, device="cpu")
    with cs.counting_calls({"grow_capacity": (gm, "grow_capacity"),
                            "densify": (trainer_mod, "densify_step")}) as n:
        assert gm.grow_capacity(state, 8).capacity == 8
        gm.grow_capacity(state, 16)
    assert n == {"grow_capacity": 2, "densify": 0}
    assert (trainer_mod.densify_step, gm.grow_capacity) == (densify, grow)
    with pytest.raises(ValueError):
        with cs.counting_calls({"grow_capacity": (gm, "grow_capacity")}):
            gm.grow_capacity(state, 2)
    assert gm.grow_capacity is grow


def test_traced_calls_split_by_capture_and_check_only_traced():
    """traced_calls counts each call inside a graph's warm-up or capture
    (utils/graphs.tracing) apart from the calls outside, and puts the
    functions back; check_only_traced refuses a call outside and a name
    never traced."""
    from photo_slam_tpu_torch.mapper import trainer as trainer_mod
    from photo_slam_tpu_torch.models import transforms as xf
    from photo_slam_tpu_torch.utils import graphs

    m = {"trainer": trainer_mod, "xf": xf}
    targets = cs.eager_targets(m)
    saved = {k: getattr(mod, a) for k, (mod, a) in targets.items()}
    assert all(callable(f) for f in saved.values())
    events = cs.event_targets(m)
    assert events == {
        "densify": (trainer_mod.StepGraphs, "densify_step"),
        "opacity_reset": (trainer_mod.StepGraphs, "opacity_reset_step")}
    state = tgm.create_from_pcd(np.zeros((3, 3), np.float32),
                                np.zeros((3, 3), np.float32), sh_degree=0,
                                capacity=4, device="cpu")
    opt = toptim.init_adam(state.params)
    with cs.traced_calls(graphs, targets) as n:
        trainer_mod.opacity_reset_step(state, opt)
        assert not graphs.tracing()
        graphs._tracing.depth = 1
        try:
            assert graphs.tracing()
            trainer_mod.opacity_reset_step(state, opt)
            trainer_mod.opacity_reset_step(state, opt)
        finally:
            graphs._tracing.depth = 0
    assert n["opacity_reset_step"] == [2, 1]
    assert n["densify_step"] == [0, 0]
    assert {k: getattr(mod, a) for k, (mod, a) in targets.items()} == saved
    with pytest.raises(AssertionError, match="outside"):
        cs.check_only_traced("x", n)
    n["opacity_reset_step"][1] = 0
    cs.check_only_traced("x", n, need=("opacity_reset_step",))
    with pytest.raises(AssertionError, match="never captured"):
        cs.check_only_traced("x", n, need=("densify_step",))


def test_densify_sizes_and_grown_map():
    """densify_sizes reads max_screen_size off the densify graphs' keys;
    grown_map pads the map and its moments to a larger capacity."""
    from photo_slam_tpu_torch.models import gaussian_model as gm
    from photo_slam_tpu_torch.utils.graphs import GraphCache

    cache = GraphCache()
    for screen in (20, 0):
        key = ("densify_step", ("grad_threshold", 2e-4),
               ("min_opacity", 0.005), ("max_screen_size", screen),
               ("percent_dense", 0.01))
        cache.entry((key, "cuda:0"), lambda: None)
    cache.entry((("opacity_reset_step",), "cuda:0"), lambda: None)
    assert cs.densify_sizes(cache) == [0, 20]
    state = gm.create_from_pcd(np.random.RandomState(0).rand(5, 3).astype(
        np.float32), np.zeros((5, 3), np.float32), sh_degree=1, capacity=8,
        device="cpu")
    opt = toptim.init_adam(state.params)
    opt.m.xyz.fill_(2.0)
    grown, gopt = cs.grown_map({"gm": gm, "optim": toptim}, state, opt, 32)
    assert grown.capacity == 32 and int(grown.live.sum()) == 5
    assert all(x.shape[0] == 32 for g in (gopt.m, gopt.v) for x in g)
    assert float(gopt.m.xyz[:8].min()) == 2.0
    assert not gopt.m.xyz[8:].any()
    assert torch.equal(grown.params.xyz[:8], state.params.xyz)


def test_second_scale_refinement_op():
    """SCALE_OP2 is another scale, shift and a turn about y."""
    op = cs.scale_refinement_op(online_mods(), cs.SCALE_OP2)
    s, t, yaw = cs.SCALE_OP2
    assert op.scale == s != cs.SCALE_OP[0]
    T = op.transform
    np.testing.assert_allclose(T[:3, 3], t, rtol=1e-6)
    np.testing.assert_allclose(T[:3, :3] @ T[:3, :3].T, np.eye(3),
                               atol=1e-6)
    assert T[0, 2] == pytest.approx(np.sin(yaw), rel=1e-6)
    assert np.allclose(cs.scale_refinement_op(online_mods()).transform[:3, :3],
                       np.eye(3))


def test_eager_graphs_calls_directly_and_puts_back():
    """eager_graphs puts a direct call in GraphCache.run's place for the
    block (`replays` calls, clones when asked) and the method back after,
    also when the block raises; plain_kernels holds it too."""
    from photo_slam_tpu_torch.ops import binning, blend, tiled
    from photo_slam_tpu_torch.utils import graphs

    run = graphs.GraphCache.run
    cache = graphs.GraphCache()
    x = torch.zeros(2)
    with cs.eager_graphs():
        assert graphs.GraphCache.run is not run
        out = cache.run("k", lambda a: (a.add_(1),), (x,), replays=3,
                        clone=True)
    assert graphs.GraphCache.run is run
    assert torch.equal(x, torch.full((2,), 3.0))
    assert out[0] is not x and torch.equal(out[0], x)
    with pytest.raises(ValueError):
        with cs.eager_graphs():
            raise ValueError("inside")
    assert graphs.GraphCache.run is run
    with cs.plain_kernels(binning, blend, tiled):
        assert graphs.GraphCache.run is not run
        assert blend.blend_fwd is blend.blend_fwd_plain
    assert graphs.GraphCache.run is run
    assert cache.captures == 0


def test_check_results_equal():
    """check_results_equal passes bit-equal tuples of tensors and names the
    fields that differ."""
    a = (torch.arange(3.0), torch.tensor(2, dtype=torch.int32))
    cs.check_results_equal(torch, "same", a, tuple(x.clone() for x in a))
    b = (torch.arange(3.0) + 1e-7, a[1])
    with pytest.raises(AssertionError, match=r"fields \[0\]"):
        cs.check_results_equal(torch, "moved", a, b)
    with pytest.raises(AssertionError):
        cs.check_results_equal(torch, "short", a, a[:1])


def colmap_summary(**kw):
    """A train_colmap summary.json of a run that passes the colmap checks."""
    rows = [{"iter": 100 * i, "live": 20_000 + 30_000 * i,
             "capacity": 65_536 if i < 5 else 131_072, "psnr": 15.0 + i,
             "clipped": 10 * i, "overflow": 1000 * i, "dropped": 0,
             "iters_per_sec": 30.0} for i in range(1, 17)]
    return {"iterations": 1600, "wall_seconds": 53.3, "iters_per_sec": 30.0,
            "first_psnr": 12.0, "last_psnr": 24.5, "num_gaussians": 470_000,
            "capacity": 1 << 20, "max_capacity": 1 << 21,
            "ceiling_reached_at": None, "num_dropped": 0,
            "peak_memory_gib": 3.25, "trace": rows, **kw}


def test_check_colmap_run():
    """The colmap phase's checks pass on a run that densified 11 times,
    grew, raised its PSNR and launched every train kernel, and fail on a
    run short of any of them."""
    launches = dict.fromkeys(cs.TRAIN_KERNELS, 1600)
    events = {"densify": 11, "grow_capacity": 2}
    cs.check_colmap_run(colmap_summary(), events, launches, 1600, 20_000)
    bad = [(colmap_summary(iterations=1599), events, launches),
           (colmap_summary(last_psnr=11.0), events, launches),
           (colmap_summary(num_gaussians=20_000), events, launches),
           (colmap_summary(), {"densify": 9, "grow_capacity": 2}, launches),
           (colmap_summary(), {"densify": 11, "grow_capacity": 0}, launches),
           (colmap_summary(capacity=65_536), events, launches),
           (colmap_summary(), events, {**launches, "entry_sum": 0})]
    for summary, ev, la in bad:
        with pytest.raises(AssertionError, match="colmap"):
            cs.check_colmap_run(summary, ev, la, 1600, 20_000)
    line = cs.colmap_line(colmap_summary(), events, 4.5)
    for part in ("1600 iterations", "30.00 it/s", "PSNR 12.00 -> 24.50",
                 "live 470000", "capacity 1048576", "peak memory 3.25 GiB",
                 "clipped 160 overflow 16000", "dropped 0"):
        assert part in line, part


def test_attr_numbers():
    """attr_numbers gives the phase every number of the four items, each
    view's too, for its finite check."""
    report = {"held_out_psnr_db": 20.0, "train_view_psnr_db": 21.0,
              "generalization_gap_db": 1.0,
              "held_out_psnr_kdup16_db": 20.1,
              "held_out_psnr_tf32_db": float("nan"),
              "gt_render_1pass_vs_exact_db": 35.0,
              "per_view": {"held_out": [19.0, 21.0], "train": [21.0] * 5}}
    nums = cs.attr_numbers(report)
    assert len(nums) == 6 + 7 and not all(np.isfinite(nums))
    report["held_out_psnr_tf32_db"] = 19.9
    assert all(np.isfinite(cs.attr_numbers(report)))


def test_blas_calls():
    """blas_calls finds the matrix products of one call from a trace (the
    attr phase prints those of the scoring render under TF32) and none in
    a call that has none."""
    a = torch.ones((8, 8))
    ops, kernels = cs.blas_calls(torch, lambda: a @ a @ a)
    assert ops == {"aten::mm": 2} and kernels == []
    assert cs.blas_calls(torch, lambda: (a * a).sum()) == ({}, [])


@pytest.fixture(scope="module")
def colmap_run(tmp_path_factory):
    """train_colmap's main on the CPU for 3 iterations on synth_colmap's
    dataset at 3 views of 64x48: (summary, trainer, dataset, out)."""
    from photo_slam_tpu_torch.apps import train_colmap
    from photo_slam_tpu_torch.tools import synth_colmap

    root = tmp_path_factory.mktemp("colmap_run")
    data = synth_colmap.write(root / "data", 3, 64, 48, device="cpu")
    summary, trainer = train_colmap.main([
        "--data", str(data), "--out", str(root / "out"), "--iters", "3",
        "--log-every", "0", "--device", "cpu"])
    return summary, trainer, data, root / "out"


def colmap_mods():
    from photo_slam_tpu_torch.apps import view_result
    from photo_slam_tpu_torch.config import Config
    from photo_slam_tpu_torch.models import gaussian_model as gm
    from photo_slam_tpu_torch.ops import losses
    from photo_slam_tpu_torch.ops.render import RenderSettings, render

    return dict(view_result=view_result, Config=Config, gm=gm,
                psnr=losses.psnr, render=render,
                RenderSettings=RenderSettings)


def test_ply_round_trip(colmap_run):
    """The colmap phase's PLY check: the saved map loaded back renders
    view 0 within PLY_ROUND_TRIP_ATOL of the map in memory through the
    same view_result render; a map whose saved opacities were changed does
    not."""
    from photo_slam_tpu_torch.tools import synth_colmap

    summary, trainer, _, out = colmap_run
    (path,) = (out / "point_cloud").rglob("point_cloud.ply")
    R, c_w = synth_colmap.view_pose(0, 3, np.random.RandomState(0))
    view = ("view 0", R, -R @ c_w)
    m = colmap_mods()
    loaded, img, err = cs.ply_round_trip(m, trainer.state, path, view, 64,
                                         48, 0.55 * 64)
    assert err <= cs.PLY_ROUND_TRIP_ATOL
    assert int(m["gm"].num_live(loaded)) == summary["num_gaussians"]
    assert img.shape == (3, 48, 64) and bool(torch.isfinite(img).all())
    p = trainer.state.params
    fainter = trainer.state._replace(params=p._replace(
        opacity_logit=p.opacity_logit - 1.0))
    assert cs.ply_round_trip(m, fainter, path, view, 64, 48,
                             0.55 * 64)[2] > 1e-3


def test_settings_psnrs(colmap_run):
    """settings_psnrs scores view 0 under the trainer's settings and with
    each of view_result's in turn: four finite PSNRs, the centred principal
    point (synth_colmap's is half a pixel off the centre) a different
    one."""
    _, trainer, data, _ = colmap_run
    (kf0,) = [kf for kf in trainer.scene.keyframes.values()
              if kf.img_filename == "frame_0000.png"]
    target = torch.as_tensor(kf0.image)
    by = cs.settings_psnrs(torch, colmap_mods(), trainer, kf0, target)
    assert list(by) == ["trainer", "centred principal", "view_result caps",
                        "SH 3"]
    assert all(np.isfinite(list(by.values())))
    assert by["centred principal"] != by["trainer"]
