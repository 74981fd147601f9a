"""chip_smoke.py's pricing of the blend kernels' bounds on the CPU:
blend_pair_counts, which counts the entry-pixel pairs of each kind a
forward (K1's loop) and a backward (K2's) evaluate, against a count made
pixel by pixel, for K1's 32 px tiles, X4's 16 px quadrants and X1's bf16
chain; and k1_cull_counts and k2_cull_counts, K1's and K2's warp skips,
against a count made warp by warp with the kernels' own thread-to-pixel
map, as is tools/time_blend.py's share of stopping pixels and warps; and
the online phase's helpers: its in-memory sequence (tools/synth_replica.py)
and the correction ops it makes and its CPU twin; and the euroc phase's:
the gravity angle, the share of disparities near the truth, the sgm
kernel's bound and its row of the `kernels` line."""
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
