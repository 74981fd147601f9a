"""X4: the blend binned at 16x16 px, four quadrant tiles per 32x32 block.

Counterpart of tools/exp_blend16.py. The production blend bins at 32 px,
so a Gaussian touching any part of a tile pays for all of its 1024 pixels;
binning at 16 px cuts the entry-pixel pairs. The experiment keeps the
production kernels' output layout: block b is a 32x32 px block whose four
16x16 quadrants q (row-major: q = 2 qy + qx) are 16 px tiles, and each
[8, 128] output plane holds quadrant q's 256 pixels at flat offsets
256 q + p, p = ly * 16 + lx (on the TPU, sublane band 2q..2q+1).

The kernels read the quadrant table d16c [B, K, 4, 16]: entry k of
quadrant q of block b is d16c[b, k, q], with its mean shifted to
quadrant-local pixels when the table is built, so the kernels carry no tile
origin. (The TPU tool feeds its kernels a slab [B, K, 8, 16] that repeats
each row on sublanes 2q and 2q + 1 for its vreg layout; no kernel here
reads a copy, so the port has no slab.) `blend16_fwd` (csrc/blend16_fwd.cu,
the TPU's blend16_call) and `blend16_bwd` (csrc/blend16_bwd.cu,
blend16_bwd_call) are the kernels, `blend16_fwd_plain` and
`blend16_bwd_plain` their plain versions, and `Blend16` the differentiable
blend over d16c (the tool's blend16_t custom_vjp).

main() runs the experiment at full width: the 300k-Gaussian room at
1200x680, the production 32 px path (k_dup 6, K 1024) against the 16 px
path (k_dup 8, K 768, 38x22 blocks): PSNR between the two images, both
paths' forward and backward kernel times, and the feat gradient of one
loss through both paths.

    python -m photo_slam_tpu_torch.tools.exp_blend16 [--device cpu]
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from photo_slam_tpu_torch import kernels
from photo_slam_tpu_torch.ops.binning import TileBinning, tile_grid
from photo_slam_tpu_torch.ops.blend import (ALPHA_MAX, ALPHA_MIN, FEAT, T_EPS,
                                            _check_tensor, blend_bwd,
                                            blend_fwd, pallas_blend)
from photo_slam_tpu_torch.ops.tiled import entry_gather
from photo_slam_tpu_torch.tools.bench_room import (K_DUP32, RoomView, Tiles32,
                                                   bin_view, parse_device,
                                                   psnr_max_diff, room_view,
                                                   tiles32, tiles_to_image,
                                                   time_ms)

QUAD = 16          # quadrant edge in pixels
QPIX = QUAD * QUAD  # 256 pixels per quadrant
K16 = 768          # max_per_tile of the 16 px binning
K_DUP16 = 8        # its max_tiles_per_gaussian


# ---- the kernels and their plain versions ---------------------------------

def _quadrant_rows(x: torch.Tensor) -> torch.Tensor:
    """[B, K, 4, F] per-quadrant rows -> [4B, K, F], quadrant 4b + q."""
    nb, k, _, f = x.shape
    return x.permute(0, 2, 1, 3).reshape(nb * 4, k, f)


def _quadrant_pixels(x: torch.Tensor) -> torch.Tensor:
    """[B, ..., 8, 128] -> [4B, ..., 256]: quadrant 4b + q's pixels."""
    nb, extra = x.shape[0], tuple(x.shape[1:-2])
    y = x.reshape((nb,) + extra + (4, QPIX))
    y = y.movedim(len(extra) + 1, 1)
    return y.reshape((nb * 4,) + extra + (QPIX,))


def _block_pixels(x: torch.Tensor, nb: int) -> torch.Tensor:
    """Inverse of _quadrant_pixels: [4B, ..., 256] -> [B, ..., 8, 128]."""
    extra = tuple(x.shape[1:-1])
    y = x.reshape((nb, 4) + extra + (QPIX,)).movedim(1, len(extra) + 1)
    return y.reshape((nb,) + extra + (8, 128)).contiguous()


def _local_pixels(dev, dtype):
    p = torch.arange(QPIX, device=dev)
    return ((p % QUAD).to(dtype)[None, :], (p // QUAD).to(dtype)[None, :])


def _power_alpha(row, lx, ly):
    """K1's power and alpha for entry rows [Q, 16] at pixels [1, P]."""
    dx = row[:, 0:1] - lx
    dy = row[:, 1:2] - ly
    power = (-0.5 * (row[:, 2:3] * dx * dx + row[:, 4:5] * dy * dy)
             - row[:, 3:4] * dx * dy)
    return dx, dy, power


def blend16_fwd_plain(d16c: torch.Tensor, counts_q: torch.Tensor,
                      num_blocks: int):
    """Plain PyTorch version of the quadrant blend forward: K1's sequential
    front-to-back loop (ops/blend.py::blend_fwd_plain) for every quadrant at
    once, each quadrant over its own entries d16c[b, :, q] and count
    counts_q[4b + q], at quadrant-local pixels. Works in d16c's float type.
    Returns (color [B, 3, 8, 128], final_T [B, 8, 128], n_contrib
    [B, 8, 128] int32)."""
    dev, dtype = d16c.device, d16c.dtype
    nq, k_max = 4 * num_blocks, d16c.shape[1]
    rows = _quadrant_rows(d16c)                            # [4B, K, 16]
    lx, ly = _local_pixels(dev, dtype)
    counts = counts_q.reshape(nq)
    color = torch.zeros((nq, 3, QPIX), dtype=dtype, device=dev)
    trans = torch.ones((nq, QPIX), dtype=dtype, device=dev)
    n_contrib = torch.zeros((nq, QPIX), dtype=torch.int32, device=dev)
    done = torch.zeros((nq, QPIX), dtype=torch.bool, device=dev)
    n_iter = min(k_max, int(counts.max())) if nq else 0
    for k in range(n_iter):
        row = rows[:, k, :]
        live = (k < counts)[:, None] & ~done
        _, _, power = _power_alpha(row, lx, ly)
        alpha = torch.clamp_max(row[:, 5:6] * torch.exp(power), ALPHA_MAX)
        contrib = live & (power <= 0.0) & (alpha >= ALPHA_MIN)
        test_t = trans * (1.0 - alpha)
        stop = contrib & (test_t < T_EPS)
        ok = contrib & ~stop
        done = done | stop
        w = alpha * trans
        color = torch.where(ok[:, None, :],
                            color + w[:, None, :] * row[:, 6:9, None], color)
        trans = torch.where(ok, test_t, trans)
        n_contrib = torch.where(ok, k + 1, n_contrib)
    return (_block_pixels(color, num_blocks),
            _block_pixels(trans, num_blocks),
            _block_pixels(n_contrib, num_blocks))


def _check_d16c(who, d16c, num_blocks):
    if d16c.device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {d16c.device}")
    if (d16c.dtype != torch.float32 or d16c.dim() != 4
            or d16c.shape[0] != num_blocks or d16c.shape[2] != 4
            or d16c.shape[3] != FEAT or not d16c.is_contiguous()
            or d16c.data_ptr() % 16):
        raise ValueError(
            f"{who}: expected a contiguous, 16-byte aligned float32 "
            f"[{num_blocks}, K, 4, {FEAT}] tensor, got {d16c.dtype} "
            f"{tuple(d16c.shape)}")


def blend16_fwd(d16c: torch.Tensor, counts_q: torch.Tensor, num_blocks: int):
    """The quadrant blend forward (the TPU's blend16_call): d16c [B, K, 4,
    16] float32, counts_q [4B] int32. Returns (color [B, 3, 8, 128],
    final_T [B, 8, 128], n_contrib [B, 8, 128]).

    On a CUDA tensor it launches csrc/blend16_fwd.cu (or raises); on a CPU
    tensor it runs blend16_fwd_plain. `blend16_fwd.launches` counts kernel
    launches."""
    if d16c.device.type == "cpu":
        return blend16_fwd_plain(d16c, counts_q, num_blocks)
    _check_d16c("blend16_fwd", d16c, num_blocks)
    dev = d16c.device
    _check_tensor("blend16_fwd", "counts_q", counts_q, dev, torch.int32,
                  (4 * num_blocks,))
    color = torch.empty((num_blocks, 3, 8, 128), dtype=torch.float32,
                        device=dev)
    final_t = torch.empty((num_blocks, 8, 128), dtype=torch.float32,
                          device=dev)
    n_contrib = torch.empty((num_blocks, 8, 128), dtype=torch.int32,
                            device=dev)
    fn = kernels.launcher("blend16_fwd")
    with torch.cuda.device(dev):
        err = fn(d16c.data_ptr(), counts_q.data_ptr(), num_blocks,
                 d16c.shape[1], color.data_ptr(), final_t.data_ptr(),
                 n_contrib.data_ptr(), torch.cuda.current_stream().cuda_stream)
    kernels.check_launch("blend16_fwd", err)
    blend16_fwd.launches += 1
    return color, final_t, n_contrib


blend16_fwd.launches = 0


def blend16_bwd_plain(d16c: torch.Tensor, counts_q: torch.Tensor,
                      final_t: torch.Tensor, n_contrib: torch.Tensor,
                      g_color: torch.Tensor, g_t: torch.Tensor,
                      num_blocks: int) -> torch.Tensor:
    """Plain PyTorch version of the quadrant blend backward: K2's
    back-to-front loop (ops/blend.py::blend_bwd_plain) for every quadrant
    at once, at quadrant-local pixels. Rows >= counts_q and lanes 9-15 stay
    exact zeros. Works in d16c's float type. Returns d_data [B, K, 4, 16]."""
    dev, dtype = d16c.device, d16c.dtype
    nq, k_max = 4 * num_blocks, d16c.shape[1]
    rows = _quadrant_rows(d16c)
    lx, ly = _local_pixels(dev, dtype)
    nc = _quadrant_pixels(n_contrib)
    trans = _quadrant_pixels(final_t)
    gcol = _quadrant_pixels(g_color)                      # [4B, 3, 256]
    gtt = _quadrant_pixels(g_t) * trans
    bc = torch.zeros((nq, QPIX), dtype=dtype, device=dev)
    d_data = torch.zeros((nq, k_max, FEAT), dtype=dtype, device=dev)
    cnt = counts_q.reshape(nq)[:, None]
    n_iter = min(k_max, int(counts_q.max())) if nq else 0
    for k in range(n_iter - 1, -1, -1):
        row = rows[:, k, :]
        dx, dy, power = _power_alpha(row, lx, ly)
        ex = torch.exp(power)
        raw = row[:, 5:6] * ex
        alpha = torch.clamp_max(raw, ALPHA_MAX)
        valid = ((k < nc) & (k < cnt) & (power <= 0.0)
                 & (alpha >= ALPHA_MIN))
        om = torch.where(valid, torch.clamp_min(1.0 - alpha, 0.01), 1.0)
        trans = torch.where(valid, trans / om, trans)      # T before entry k
        a_t = torch.where(valid, alpha * trans, 0.0)
        gc = (gcol[:, 0] * row[:, 6:7] + gcol[:, 1] * row[:, 7:8]
              + gcol[:, 2] * row[:, 8:9])
        dl_dalpha = torch.where(valid & (raw < ALPHA_MAX),
                                gc * trans - (bc + gtt) / om, 0.0)
        bc = bc + torch.where(valid, a_t * gc, 0.0)
        dl_do = dl_dalpha * ex
        dl_dp = dl_do * row[:, 5:6]
        s_x = (dl_dp * dx).sum(-1)
        s_y = (dl_dp * dy).sum(-1)
        sums = torch.stack([
            -(row[:, 2] * s_x + row[:, 3] * s_y),
            -(row[:, 4] * s_y + row[:, 3] * s_x),
            -0.5 * (dl_dp * dx * dx).sum(-1),
            -(dl_dp * dx * dy).sum(-1),
            -0.5 * (dl_dp * dy * dy).sum(-1),
            dl_do.sum(-1),
            (a_t * gcol[:, 0]).sum(-1),
            (a_t * gcol[:, 1]).sum(-1),
            (a_t * gcol[:, 2]).sum(-1),
        ], dim=-1)
        d_data[:, k, :9] = torch.where(k < cnt, sums, 0.0)
    return d_data.reshape(num_blocks, 4, k_max, FEAT).permute(
        0, 2, 1, 3).contiguous()


def blend16_bwd(d16c: torch.Tensor, counts_q: torch.Tensor,
                final_t: torch.Tensor, n_contrib: torch.Tensor,
                g_color: torch.Tensor, g_t: torch.Tensor,
                num_blocks: int) -> torch.Tensor:
    """The quadrant blend backward (the TPU's blend16_bwd_call): arguments
    as blend16_bwd_plain; returns d_data [B, K, 4, 16].

    On a CUDA tensor it launches csrc/blend16_bwd.cu (or raises); on a CPU
    tensor it runs blend16_bwd_plain. `blend16_bwd.launches` counts kernel
    launches."""
    if d16c.device.type == "cpu":
        return blend16_bwd_plain(d16c, counts_q, final_t, n_contrib,
                                 g_color, g_t, num_blocks)
    _check_d16c("blend16_bwd", d16c, num_blocks)
    dev, k_max = d16c.device, d16c.shape[1]
    pix = (num_blocks, 8, 128)
    for name, x, dtype, shape in (
            ("counts_q", counts_q, torch.int32, (4 * num_blocks,)),
            ("final_t", final_t, torch.float32, pix),
            ("n_contrib", n_contrib, torch.int32, pix),
            ("g_color", g_color, torch.float32, (num_blocks, 3, 8, 128)),
            ("g_t", g_t, torch.float32, pix)):
        _check_tensor("blend16_bwd", name, x, dev, dtype, shape)
    d_data = torch.empty((num_blocks, k_max, 4, FEAT), dtype=torch.float32,
                         device=dev)
    fn = kernels.launcher("blend16_bwd")
    with torch.cuda.device(dev):
        err = fn(d16c.data_ptr(), counts_q.data_ptr(), final_t.data_ptr(),
                 n_contrib.data_ptr(), g_color.data_ptr(), g_t.data_ptr(),
                 num_blocks, k_max, d_data.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    kernels.check_launch("blend16_bwd", err)
    blend16_bwd.launches += 1
    return d_data


blend16_bwd.launches = 0


class Blend16(torch.autograd.Function):
    """The quadrant blend over the quadrant table d16c [B, K, 4, 16],
    differentiable in d16c: forward blend16_fwd, backward blend16_bwd (the
    tool's blend16_t custom_vjp, tools/exp_blend16.py:439-457). The kernels
    are looked up by module name at each call, so a caller may put the
    plain versions in their place. n_contrib carries no gradient."""

    @staticmethod
    def forward(ctx, d16c, counts_q):
        d16c = d16c.contiguous()
        color, final_t, n_contrib = blend16_fwd(d16c, counts_q, d16c.shape[0])
        ctx.save_for_backward(d16c, counts_q, final_t, n_contrib)
        ctx.mark_non_differentiable(n_contrib)
        return color, final_t, n_contrib

    @staticmethod
    def backward(ctx, g_color, g_t, _g_n):
        d16c, counts_q, final_t, n_contrib = ctx.saved_tensors
        d = blend16_bwd(d16c, counts_q, final_t, n_contrib,
                        g_color.contiguous(), g_t.contiguous(), d16c.shape[0])
        return d, None


# ---- the 16 px path around the kernels --------------------------------------

def quadrant_perm(gx16: int, gy16: int):
    """Row-major 16 px tile grid -> block-quadrant order (tool :357-368):
    (perm [4B] int64, valid [4B] bool, bx, by); row 4b + q of block
    b = by_i * bx + bx_i is tile (2 by_i + q // 2, 2 bx_i + q % 2), and rows
    past the grid's edge are invalid (perm 0)."""
    bx, by = -(-gx16 // 2), -(-gy16 // 2)
    b = np.arange(bx * by)
    q = np.arange(4)
    sy = (2 * (b // bx))[:, None] + (q // 2)[None, :]
    sx = (2 * (b % bx))[:, None] + (q % 2)[None, :]
    valid = (sy < gy16) & (sx < gx16)
    perm = np.where(valid, sy * gx16 + sx, 0)
    return perm.reshape(-1), valid.reshape(-1), bx, by


class Path16(NamedTuple):
    """The 16 px binning in block-quadrant order."""

    binning: TileBinning
    lists: torch.Tensor      # [4B, K] entry ids, -1 past each count
    counts_q: torch.Tensor   # [4B] int32
    shift: torch.Tensor      # [4B, 16] the quadrants' pixel origins, lanes 0-1
    num_blocks: int
    bx: int
    by: int
    k_dup: int


def bin16(view: RoomView, k_dup: int = K_DUP16,
          max_per_tile: int = K16) -> Path16:
    """Bin the view at 16 px and reorder the tiles into quadrants
    (tool :349-370, 379-381)."""
    dev = view.feat.device
    binning = bin_view(view, 16, k_dup, max_per_tile)
    gx16, gy16 = tile_grid(view.width, view.height, 16)
    perm, valid, bx, by = quadrant_perm(gx16, gy16)
    perm_t = torch.as_tensor(perm, device=dev)
    valid_t = torch.as_tensor(valid, device=dev)
    lists = torch.where(valid_t[:, None], binning.tile_lists[perm_t], -1)
    counts_q = torch.where(valid_t, binning.tile_counts[perm_t], 0).to(
        torch.int32)
    shift = np.zeros((perm.size, FEAT), np.float32)
    shift[:, 0] = 16.0 * (perm % gx16)
    shift[:, 1] = 16.0 * (perm // gx16)
    return Path16(binning=binning, lists=lists, counts_q=counts_q,
                  shift=torch.as_tensor(shift, device=dev),
                  num_blocks=bx * by, bx=bx, by=by, k_dup=k_dup)


def quadrant_table(feat: torch.Tensor, path: Path16) -> torch.Tensor:
    """The quadrant table d16c [B, K, 4, 16]: each quadrant's entry rows
    with their means shifted to quadrant-local pixels (tool :371-384),
    differentiable in feat."""
    d = entry_gather(feat, path.lists, path.k_dup) - path.shift[:, None, :]
    nb, k = path.num_blocks, path.lists.shape[1]
    return d.reshape(nb, 4, k, FEAT).permute(0, 2, 1, 3)


def img16(x: torch.Tensor, bx: int, by: int, width: int,
          height: int) -> torch.Tensor:
    """[B, ..., 8, 128] block-quadrant pixels -> [..., H, W] (tool
    :399-404, 459-463)."""
    extra = tuple(x.shape[1:-2])
    nex = len(extra)
    y = x.reshape((by, bx) + extra + (2, 2, QUAD, QUAD))
    # [by, bx, ..., qy, qx, ly, lx] -> [..., by, qy, ly, bx, qx, lx]
    perm = (tuple(range(2, 2 + nex))
            + (0, 2 + nex, 4 + nex, 1, 3 + nex, 5 + nex))
    y = y.permute(perm).reshape(extra + (by * 32, bx * 32))
    return y[..., :height, :width]


def loss_weights(width: int, height: int, device) -> torch.Tensor:
    """The tool's image weights for the gradient comparison (:431-432)."""
    return torch.as_tensor(np.random.RandomState(11).rand(3, height, width)
                           .astype(np.float32), device=device)


def loss16(feat: torch.Tensor, path: Path16, weights: torch.Tensor,
           width: int, height: int) -> torch.Tensor:
    """sum(image * W) + 0.3 sum(final_T) through the 16 px path (:477-483)."""
    c, t, _ = Blend16.apply(quadrant_table(feat, path), path.counts_q)
    return ((img16(c, path.bx, path.by, width, height) * weights).sum()
            + 0.3 * t.sum())


def loss32(feat: torch.Tensor, t32: Tiles32, weights: torch.Tensor, width: int,
           height: int) -> torch.Tensor:
    """The same loss through the production 32 px path (:470-475)."""
    d = entry_gather(feat, t32.binning.tile_lists, K_DUP32)
    c, t, _ = pallas_blend(d, t32.counts, t32.tiles_x, t32.num_tiles)
    img = tiles_to_image(c, t32.tiles_x, t32.tiles_y, width, height)
    return (img * weights).sum() + 0.3 * t.sum()


def run(view: RoomView, reps: int = 20, log=print) -> dict:
    """The experiment (tool main() :302-490) on a preprocessed view: the
    32 px path, the 16 px path, PSNR between them, the four kernels' times
    and the feat gradient through both paths. Returns what it measured and
    the 16 px path's inputs and outputs."""
    dev, w, h = view.feat.device, view.width, view.height
    feat = view.feat.detach()

    t32 = tiles32(view)
    log(f"32-path: entries={int(t32.counts.sum())} "
        f"overflow={int(t32.binning.num_overflow)}")
    o32 = blend_fwd(t32.data, t32.counts, t32.tiles_x, t32.num_tiles)
    fwd32_ms = time_ms(lambda: blend_fwd(t32.data, t32.counts, t32.tiles_x,
                                         t32.num_tiles), reps, dev)

    path = bin16(view)
    nb = path.num_blocks
    log(f"16-path: entries={int(path.binning.tile_counts.sum())} "
        f"overflow={int(path.binning.num_overflow)} "
        f"clipped={int(path.binning.num_clipped)}")
    d16c = quadrant_table(feat, path).contiguous()
    o16 = blend16_fwd(d16c, path.counts_q, nb)
    fwd16_ms = time_ms(lambda: blend16_fwd(d16c, path.counts_q, nb), reps,
                       dev)
    psnr, max_d = psnr_max_diff(
        tiles_to_image(o32[0], t32.tiles_x, t32.tiles_y, w, h),
        img16(o16[0], path.bx, path.by, w, h))
    log(f"PSNR 16-vs-32 path: {psnr:.2f} dB  (max |d| {max_d:.2e})")

    # Backward kernels on random cotangents, the raw counts on both sides.
    rng = np.random.RandomState(3)
    g32 = [torch.as_tensor(rng.rand(*s).astype(np.float32), device=dev)
           for s in ((t32.num_tiles, 3, 8, 128), (t32.num_tiles, 8, 128))]
    g16 = [torch.as_tensor(rng.rand(*s).astype(np.float32), device=dev)
           for s in ((nb, 3, 8, 128), (nb, 8, 128))]
    bwd32_ms = time_ms(lambda: blend_bwd(
        t32.data, t32.counts, o32[1], o32[2], *g32, t32.tiles_x,
        t32.num_tiles), reps, dev)
    bwd16_args = (d16c, path.counts_q, o16[1], o16[2], *g16, nb)
    d16 = blend16_bwd(*bwd16_args)
    bwd16_ms = time_ms(lambda: blend16_bwd(*bwd16_args), reps, dev)
    log(f"fwd ms: 32-tile K1 {fwd32_ms:.4f}, 16-tile quadrant "
        f"{fwd16_ms:.4f}; bwd ms: 32-tile K2 {bwd32_ms:.4f}, 16-tile "
        f"quadrant {bwd16_ms:.4f}")

    # The feat gradient of one loss through both paths.
    weights = loss_weights(w, h, dev)
    f32 = feat.clone().requires_grad_(True)
    (gf32,) = torch.autograd.grad(loss32(f32, t32, weights, w, h), f32)
    f16 = feat.clone().requires_grad_(True)
    (gf16,) = torch.autograd.grad(loss16(f16, path, weights, w, h), f16)
    scale = gf32.abs().amax(dim=0) + 1e-9
    rel = ((gf32 - gf16).abs().amax(dim=0) / scale)[:9]
    log("feat-grad rel diff per lane: "
        + str([round(float(x), 4) for x in rel]))
    return dict(path=path, d16c=d16c, out16=o16, d_data=d16,
                bwd16_args=bwd16_args, t32=t32, out32=o32, psnr=psnr,
                max_diff=max_d, fwd32_ms=fwd32_ms, fwd16_ms=fwd16_ms,
                bwd32_ms=bwd32_ms, bwd16_ms=bwd16_ms,
                grad_rel=[float(x) for x in rel])


def main(argv=None):
    device = parse_device(argv, "X4: the 16 px quadrant blend against the "
                          "production 32 px blend")
    run(room_view(device=device), reps=50 if device.type == "cuda" else 1)


if __name__ == "__main__":
    main()
