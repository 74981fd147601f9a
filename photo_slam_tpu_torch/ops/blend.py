"""Tile blend forward: the renderer's hot loop.

Counterpart of photo_slam_tpu/ops/pallas/blend.py::pallas_blend, forward
only (the backward comes with the training slice). `pallas_blend` is the
wrapper of the kernel K1, csrc/blend_fwd.cu; `blend_fwd_plain` is its plain
PyTorch version.

Packed entry layout (16 f32 lanes per entry, as in the JAX package):
  0: mean2d.x   1: mean2d.y   2: conic.a   3: conic.b   4: conic.c
  5: opacity    6: r          7: g         8: b         9-15: unused
Outputs keep the JAX layouts: color [T, 3, 8, 128], final_T [T, 8, 128],
n_contrib [T, 8, 128], pixel p = r*32 + c of the 32x32 tile flattened as
8x128.
"""
from __future__ import annotations

import torch

from photo_slam_tpu_torch import kernels

TILE_PS = 32          # pixel tile edge: 32*32 = 1024 px
PIX_SUB = 8
PIX_LANE = 128
FEAT = 16

ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4


def _tile_ids_or_iota(tile_ids, num_tiles, device):
    if tile_ids is None:
        return torch.arange(num_tiles, dtype=torch.int32, device=device)
    return tile_ids.to(torch.int32)


def blend_fwd_plain(data_tiles: torch.Tensor, counts: torch.Tensor,
                    tiles_x: int, num_tiles: int,
                    tile_ids: torch.Tensor | None = None):
    """Plain PyTorch version of the blend kernel: a loop over the K entry
    rows, vectorized over tiles and pixels, with the sequential
    transmittance and early-stop semantics of the reference
    (cuda_rasterizer/forward.cu:325-373). Each product and sum is its own
    op, in the order the kernel evaluates it."""
    dev = data_tiles.device
    nb, k_max, _ = data_tiles.shape
    p = TILE_PS * TILE_PS
    ids = _tile_ids_or_iota(tile_ids, num_tiles, dev)
    pix = torch.arange(p, device=dev)
    px = ((ids % tiles_x) * TILE_PS)[:, None].to(torch.float32) \
        + (pix % TILE_PS).to(torch.float32)[None, :]
    py = ((ids // tiles_x) * TILE_PS)[:, None].to(torch.float32) \
        + (pix // TILE_PS).to(torch.float32)[None, :]

    color = torch.zeros((nb, 3, p), dtype=torch.float32, device=dev)
    trans = torch.ones((nb, p), dtype=torch.float32, device=dev)
    n_contrib = torch.zeros((nb, p), dtype=torch.int32, device=dev)
    done = torch.zeros((nb, p), dtype=torch.bool, device=dev)
    n_iter = min(k_max, int(counts.max())) if nb else 0
    for k in range(n_iter):
        row = data_tiles[:, k, :]                          # [T, 16]
        live = (k < counts)[:, None] & ~done
        dx = row[:, 0:1] - px
        dy = row[:, 1:2] - py
        power = (-0.5 * (row[:, 2:3] * dx * dx + row[:, 4:5] * dy * dy)
                 - row[:, 3:4] * dx * dy)
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
    return (color.view(nb, 3, PIX_SUB, PIX_LANE),
            trans.view(nb, PIX_SUB, PIX_LANE),
            n_contrib.view(nb, PIX_SUB, PIX_LANE))


def pallas_blend(data_tiles: torch.Tensor, counts: torch.Tensor,
                 tiles_x: int, num_tiles: int,
                 tile_ids: torch.Tensor | None = None):
    """Blend packed per-tile entries (forward of the JAX pallas_blend).

    data_tiles [T, K, 16] float32, counts [T] int32 valid entries per tile
    (depth-sorted prefixes), tiles_x tiles per image row, num_tiles = T; with
    `tile_ids` block i rasterizes image tile tile_ids[i] (the compact
    overflow continuation). Returns (color [T, 3, 8, 128], final_T
    [T, 8, 128], n_contrib [T, 8, 128]); the background is the caller's.

    On a CUDA tensor it launches csrc/blend_fwd.cu (or raises); on a CPU
    tensor it runs blend_fwd_plain. `pallas_blend.launches` counts kernel
    launches.
    """
    if data_tiles.device.type == "cpu":
        return blend_fwd_plain(data_tiles, counts, tiles_x, num_tiles,
                               tile_ids)
    dev = data_tiles.device
    if dev.type != "cuda":
        raise ValueError(f"pallas_blend: unsupported device {dev}")
    ids = _tile_ids_or_iota(tile_ids, num_tiles, dev).contiguous()
    nb, k_max = data_tiles.shape[0], data_tiles.shape[1]
    if (data_tiles.dtype != torch.float32 or data_tiles.dim() != 3
            or data_tiles.shape[2] != FEAT or nb != num_tiles
            or not data_tiles.is_contiguous() or data_tiles.data_ptr() % 16):
        raise ValueError(
            f"pallas_blend: data_tiles must be a contiguous, 16-byte aligned "
            f"float32 [{num_tiles}, K, {FEAT}] tensor, got {data_tiles.dtype} "
            f"{tuple(data_tiles.shape)}")
    for name, x in (("counts", counts), ("tile_ids", ids)):
        if (x.device != dev or x.dtype != torch.int32
                or tuple(x.shape) != (nb,) or not x.is_contiguous()):
            raise ValueError(f"pallas_blend: {name} must be a contiguous "
                             f"int32 [{nb}] tensor on {dev}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    color = torch.empty((nb, 3, PIX_SUB, PIX_LANE), dtype=torch.float32,
                        device=dev)
    final_t = torch.empty((nb, PIX_SUB, PIX_LANE), dtype=torch.float32,
                          device=dev)
    n_contrib = torch.empty((nb, PIX_SUB, PIX_LANE), dtype=torch.int32,
                            device=dev)
    fn = kernels.launcher("blend_fwd")
    with torch.cuda.device(dev):
        err = fn(data_tiles.data_ptr(), counts.data_ptr(), ids.data_ptr(),
                 nb, k_max, tiles_x, color.data_ptr(), final_t.data_ptr(),
                 n_contrib.data_ptr(), torch.cuda.current_stream().cuda_stream)
    kernels.check_launch("blend_fwd", err)
    pallas_blend.launches += 1
    return color, final_t, n_contrib


pallas_blend.launches = 0
