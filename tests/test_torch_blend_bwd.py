"""K2's plain version (photo_slam_tpu_torch/ops/blend.py::blend_bwd_plain)
and the differentiable pallas_blend against the JAX package's blend
backward, run interpreted on the CPU, on identical packed tiles; the box
that K1, K2, X3, X4f and X4b skip their warps by (entry_cull_boxes, also in
X4's 16 px quadrant frame), the knockouts of tools/time_blend.py, and the
hash that names the kernels' libraries."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from photo_slam_tpu.ops.pallas.blend import _blend_bwd_call
from photo_slam_tpu.ops.pallas.blend import pallas_blend as jblend
from photo_slam_tpu_torch import kernels
from photo_slam_tpu_torch.ops import blend as tblend
from photo_slam_tpu_torch.tools import exp_blend16 as tx4
from photo_slam_tpu_torch.tools import time_blend
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


AMIN_F32 = float(np.float32(tblend.ALPHA_MIN))
ROW_KINDS = ("plain", "near_threshold", "near_singular", "negative_det",
             "tiny", "huge", "nan")


def cull_rows(kinds, seed):
    """Packed rows [N, 16], one per kind: the splat's mean anywhere in a
    few thousand px, its conic the inverse of a rotated covariance (or a
    near-singular, indefinite or NaN one) and its opacity near 1/255."""
    rng = np.random.RandomState(seed)
    n = len(kinds)
    rows = np.zeros((n, 16), np.float32)
    rows[:, 0:2] = rng.uniform(-2000, 2000, (n, 2))
    rows[:, 6:9] = rng.rand(n, 3)
    for i, kind in enumerate(kinds):
        lo, hi = {"tiny": (-3, -1), "huge": (2, 5)}.get(kind, (-1, 2))
        sx, sy = 10.0 ** rng.uniform(lo, hi, 2)
        th = rng.uniform(0, np.pi)
        rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        conic = np.linalg.inv(rot @ np.diag([sx * sx, sy * sy]) @ rot.T)
        a, b, c = conic[0, 0], conic[0, 1], conic[1, 1]
        if kind == "near_singular":
            b = np.sign(b or 1.0) * np.sqrt(a * c * (1 - 10.0 ** rng.uniform(
                -9, -3)))
        elif kind == "negative_det":
            b = np.sqrt(a * c) * rng.uniform(1.0, 3.0)
        rows[i, 2:5] = a, b, c
        near = kind in ("near_threshold", "huge", "near_singular")
        rows[i, 5] = (AMIN_F32 * (1 + 10.0 ** rng.uniform(-8, -3)
                                  * rng.choice([-1, 1]))
                      if near or rng.rand() < 0.3 else rng.uniform(0.01, 1))
        if kind == "nan":
            rows[i, rng.randint(0, 6)] = np.nan
    return rows


def probe_pixels(row, rng):
    """Integer pixels where a splat is hardest to bound: around its mean,
    at and just past the exact ellipse's extreme points in x and in y, and
    a spread over 1.5x its extents."""
    mx, my, a, b, c, o = (float(x) for x in row[:6])
    if not np.isfinite([mx, my, a, b, c, o]).all():
        return np.stack(np.meshgrid(np.arange(-3, 4), np.arange(-3, 4)),
                        -1).reshape(-1, 2).astype(np.float64)
    det = a * c - b * b
    el = np.log(max(o, 1e-30) / AMIN_F32)
    pts = [np.stack(np.meshgrid(np.arange(-3, 4), np.arange(-3, 4)),
                    -1).reshape(-1, 2) + np.floor([mx, my])]
    if det > 0 and a > 0 and el > 0:
        ex, ey = np.sqrt(2 * el * c / det), np.sqrt(2 * el * a / det)
        ext = np.minimum([ex, ey], 1e6)
        for s in (0.9, 0.99, 1.0, 1.01, 1.1, 1.5):
            for sign in (-1, 1):
                for d in (np.array([ext[0], -b / c * ext[0]]),
                          np.array([-b / a * ext[1], ext[1]])):
                    base = np.floor(np.array([mx, my]) + sign * s * d)
                    pts.append(base[None] + np.stack(np.meshgrid(
                        np.arange(-1, 3), np.arange(-1, 3)), -1).reshape(-1,
                                                                         2))
        pts.append(np.floor(np.array([mx, my]) + rng.uniform(
            -1.5, 1.5, (64, 2)) * ext))
    return np.concatenate(pts).astype(np.float64)


@settings(max_examples=60, deadline=None, database=None)
@given(kinds=st.lists(st.sampled_from(ROW_KINDS), min_size=1, max_size=12),
       seed=st.integers(0, 2 ** 31 - 1))
def test_cull_boxes_hold_every_contributing_pair(kinds, seed):
    """Every (entry, pixel) pair that blend_bwd_plain's own f32 arithmetic
    counts as contributing (power <= 0, alpha >= 1/255) lies inside the
    entry's box from entry_cull_boxes, K2's warp skip test."""
    rows = cull_rows(kinds, seed)
    boxes = tblend.entry_cull_boxes(torch.from_numpy(rows)).numpy()
    assert boxes.dtype == np.float32 and boxes.shape == (len(kinds), 4)
    rng = np.random.RandomState(seed % 1000)
    for row, box, kind in zip(rows, boxes, kinds):
        pix = probe_pixels(row, rng).astype(np.float32)
        px, py = (torch.from_numpy(np.ascontiguousarray(pix[None, :, i]))
                  for i in (0, 1))
        contrib = tblend.pair_terms(torch.from_numpy(row[None]), px, py)[-1]
        contrib = contrib[0].numpy()
        inside = ((box[0] <= pix[:, 0]) & (pix[:, 0] <= box[1])
                  & (box[2] <= pix[:, 1]) & (pix[:, 1] <= box[3]))
        assert not (contrib & ~inside).any(), (kind, row[:6], box)
        if row[5] < AMIN_F32 and np.isfinite(row[:6]).all():
            assert box[0] > box[1] and not contrib.any()
        if kind == "nan" or (kind == "negative_det" and row[5] >= AMIN_F32):
            assert np.isinf(box).all() and box[0] < box[1]


@settings(max_examples=40, deadline=None, database=None)
@given(kinds=st.lists(st.sampled_from(ROW_KINDS), min_size=1, max_size=8),
       seed=st.integers(0, 2 ** 31 - 1))
def test_cull_boxes_hold_every_contributing_pair_in_quadrant_frame(kinds,
                                                                   seed):
    """X4b's box in the 16 px quadrant frame: splats whose means straddle
    the borders between a 32 px block's four quadrants (and the block's
    edges), each quadrant's row holding the mean in that quadrant's local
    pixels as exp_blend16.quadrant_table shifts it. Every pair that
    blend16_bwd_plain's own f32 arithmetic counts as contributing, at the
    quadrant's 256 local pixels, lies inside the local row's box, so no
    warp block of the quadrant (rows 0-7, rows 8-15) whose rect the box
    misses holds one."""
    rows = cull_rows(kinds, seed)
    rng = np.random.RandomState(seed % 1000)
    origin = 32.0 * rng.randint(0, 40, 2)
    rows[:, 0:2] = (origin + 16.0 * rng.randint(0, 3, (len(kinds), 2))
                    + rng.uniform(-3, 3, (len(kinds), 2))).astype(np.float32)
    lx, ly = tx4._local_pixels("cpu", torch.float32)
    x, y = lx[0].numpy(), ly[0].numpy()
    for q in range(4):
        local = rows.copy()
        local[:, 0:2] -= (origin + 16.0 * np.array([q % 2, q // 2])).astype(
            np.float32)
        t = torch.from_numpy(local)
        boxes = tblend.entry_cull_boxes(t).numpy()
        contrib = tblend.pair_terms(t, lx, ly)[-1].numpy()   # [N, 256]
        inside = ((boxes[:, 0:1] <= x) & (x <= boxes[:, 1:2])
                  & (boxes[:, 2:3] <= y) & (y <= boxes[:, 3:4]))
        assert not (contrib & ~inside).any(), (q, local[:, :6], boxes)
        for w in range(2):
            rect_y0 = 8.0 * w
            misses = ~((boxes[:, 1] >= 0.0) & (boxes[:, 0] <= 15.0)
                       & (boxes[:, 3] >= rect_y0)
                       & (boxes[:, 2] <= rect_y0 + 7.0))
            mine = (y >= rect_y0) & (y <= rect_y0 + 7.0)
            assert not (contrib[misses][:, mine]).any(), (q, w)


@pytest.mark.parametrize("kernel,name", [
    (kernel, name) for kernel, names in sorted(time_blend.KNOCKOUTS.items())
    for name in sorted(names)])
def test_knockouts_apply_to_the_kernel_source(kernel, name):
    """Each knockout that tools/time_blend.py times K1, K2, X1, X3, X4f or
    X4b against edits its source (csrc/<KERNELS[kernel]>.cu) exactly where
    it says: without-box leaves the shared box included but never computed
    (X1's bf16 box, the others' f32 one), and every warp's box unbounded
    (K1's and K2's box test, X1's, X3's, X4f's and X4b's bit per warp);
    block-stop makes the warp stop never fire, at all three of its tests
    (after staging, after each live entry, and its definition), and leaves
    the block's exit (X4f: the quadrant's vote); whole-tile launches one
    256-thread block per tile in place of two 128-thread blocks;
    shuffle-trees sums X4b's nine lanes with nine 5-step xor trees in place
    of the butterfly; quadrant-blocks puts one quadrant in a block in place
    of four."""
    source = (kernels.CSRC_DIR / f"{time_blend.KERNELS[kernel]}.cu"
              ).read_text()
    edited = time_blend.knockout_source(source, kernel, name)
    assert edited != source
    assert '#include "cull_box.cuh"' in edited
    if name == "without-box":
        box = "cull_box_bf16(" if kernel == "x1" else "cull_box("
        assert source.count(box) == 1 and box not in edited
        assert "s_box[i]" not in edited
        assert ("make_float4(-CUDART_INF_F, CUDART_INF_F, -CUDART_INF_F, "
                "CUDART_INF_F)") in edited
    elif name == "block-stop":
        stop = "return __all_sync(0xffffffffu, mine_"
        assert stop in source and stop not in edited
        assert edited.count("warp_stopped(") == 3
        assert ("quad_done(mine_done" if kernel == "x4f"
                else "__syncthreads_count(mine_") in edited
    elif name == "whole-tile":
        assert "kThreads = 128" in source and "kHalves = 2" in source
        assert "kThreads = 256" in edited and "kHalves = 1" in edited
        assert "<<<kHalves * num_blocks, kThreads" in edited
        assert "__launch_bounds__(kThreads, kMinBlocks)" in edited
    elif name == "shuffle-trees":
        assert "butterfly9(acc, lane)" in source
        assert "butterfly9(acc, lane)" not in edited
        assert edited.count("__shfl_xor_sync(0xffffffffu, v, off)") == 1
        assert "if (g == my_sum) total = v;" in edited
    else:
        assert name == "quadrant-blocks"
        assert "kQuadsPerBlock = 4;" in source
        assert "kQuadsPerBlock = 1;" in edited
        assert "kThreads = kQuadThreads * kQuadsPerBlock" in edited
        assert "quad_sync(slot)" in edited


def test_library_path_hashes_the_headers(tmp_path, monkeypatch):
    """A kernel's library is named by its source, every csrc/*.cuh header
    and the flags: an edit to a shared header builds a new library, and an
    unchanged tree finds the same one."""
    for f in kernels.CSRC_DIR.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(kernels, "CSRC_DIR", tmp_path)
    first = {n: kernels.library_path(n) for n in ("blend_fwd", "blend_bwd")}
    assert kernels.library_path("blend_fwd") == first["blend_fwd"]
    header = tmp_path / "cull_box.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    edited = {n: kernels.library_path(n) for n in first}
    assert all(edited[n] != first[n] for n in first)
    (tmp_path / "another.cuh").write_text("#pragma once\n")
    assert kernels.library_path("blend_fwd") not in (first["blend_fwd"],
                                                     edited["blend_fwd"])
    # Every build finds the headers, wherever its source was written.
    monkeypatch.setattr(kernels, "_nvcc", lambda: "nvcc")
    assert kernels.nvcc_command(tmp_path / "v.cu", tmp_path / "v.so") == [
        "nvcc", *kernels.NVCC_FLAGS, "-I", str(tmp_path), "-o",
        str(tmp_path / "v.so"), str(tmp_path / "v.cu")]
