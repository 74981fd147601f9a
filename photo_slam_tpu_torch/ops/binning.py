"""Tile binning: depth-ordered per-tile Gaussian lists with static shapes.

Counterpart of photo_slam_tpu/ops/binning.py (the reference builds dynamic
lists with a scan + 64-bit radix sort, cuda_rasterizer/rasterizer_impl.cu:
70-336). The same static-shape algorithm as the JAX package:

  1. expand each Gaussian to at most `max_tiles_per_gaussian` (k_dup) tile
     slots of its screen rect (clipped rects are counted);
  2. pack (tile_id, depth) into ONE int32 key per slot: the top bits of a
     positive float's bit pattern order by depth;
  3. one sort of the N*k_dup keys, payload = entry id gaussian*k_dup+slot;
  4. per-tile ranges by binary search over the key boundaries, then the
     [T, K] window gather (window_gather, the kernel K3) of each tile's
     contiguous stream segment.

The TPU-only one-hot offset tables become integer % and //; the results are
identical (photo_slam_tpu/ops/binning.py:279-281).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from photo_slam_tpu_torch import kernels

TILE = 16  # tile edge in pixels (reference: cuda_rasterizer/config.h BLOCK_X/Y)


def window_gather_plain(sorted_entries: torch.Tensor, starts: torch.Tensor,
                        max_per_tile: int,
                        counts: torch.Tensor | None = None) -> torch.Tensor:
    """[T, K] windows sorted_entries[clamp(starts[t] + j, 0, E-1)], j < K,
    and -1 where j >= counts[t] when `counts` [T] is given: the plain
    version of the window-gather kernel (and, without counts, of the JAX
    package's _window_gather_xla)."""
    j = torch.arange(max_per_tile, device=starts.device)
    idx = (starts.to(torch.int64)[:, None] + j[None, :]).clamp(
        0, sorted_entries.shape[0] - 1)
    out = sorted_entries[idx]
    if counts is None:
        return out
    return torch.where(j[None, :] < counts[:, None], out, -1)


def window_gather(sorted_entries: torch.Tensor, starts: torch.Tensor,
                  max_per_tile: int,
                  counts: torch.Tensor | None = None) -> torch.Tensor:
    """[T, K] int32 windows of the sorted entry stream, one per tile:
    out[t, j] = sorted_entries[clamp(starts[t] + j, 0, E-1)], and -1 where
    j >= counts[t] when `counts` [T] int32 is given.

    Counterpart of photo_slam_tpu/ops/binning.py::_window_gather_pallas (K3).
    On a CUDA tensor it launches csrc/window_gather.cu (or raises); on a CPU
    tensor it runs window_gather_plain. `window_gather.launches` counts
    kernel launches.
    """
    dev = sorted_entries.device
    if dev.type == "cpu":
        return window_gather_plain(sorted_entries, starts, max_per_tile,
                                   counts)
    if dev.type != "cuda":
        raise ValueError(f"window_gather: unsupported device {dev}")
    num_tiles, e_total = starts.shape[0], sorted_entries.shape[0]
    # Only what the kernel cannot take: its device time is ~2 us, so the
    # host's work per call is most of its cost.
    names = ("sorted_entries", "starts", "counts")
    for i, x in enumerate((sorted_entries, starts) if counts is None
                          else (sorted_entries, starts, counts)):
        if (x.dtype != torch.int32 or x.dim() != 1 or not x.is_contiguous()
                or x.device != dev):
            raise ValueError(f"window_gather: {names[i]} must be a "
                             f"contiguous 1-D int32 tensor on {dev}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if counts is not None and counts.shape[0] != num_tiles:
        raise ValueError(f"window_gather: counts {tuple(counts.shape)} for "
                         f"{num_tiles} tiles")
    if not 1 <= e_total < 2 ** 31 - max_per_tile:
        raise ValueError(f"window_gather: need 1 <= E < 2^31 - K, got "
                         f"E={e_total} K={max_per_tile}")
    out = sorted_entries.new_empty((num_tiles, max_per_tile))
    kernels.launch("window_gather", dev, sorted_entries.data_ptr(), e_total,
                   starts.data_ptr(),
                   None if counts is None else counts.data_ptr(), num_tiles,
                   max_per_tile, out.data_ptr())
    window_gather.launches += 1
    return out


window_gather.launches = 0


class TileBinning(NamedTuple):
    """Static-shape binning result (see photo_slam_tpu/ops/binning.py).

    tile_lists:  [T, K_MAX] int32 entry ids (gaussian * k_dup + slot) per
                 tile in front-to-back depth order, -1 past the count
    tile_counts: [T] int32 valid entries per tile (<= K_MAX)
    num_clipped: [] int32 Gaussians whose rect was clipped to fit k_dup
    num_overflow:[] int32 per-tile entries dropped beyond K_MAX
    sorted_entries [N*k_dup] int32 all entry ids in (tile, depth) key order
    sorted_tiles [N*k_dup] int32 the tile id at each sorted position
    starts       [T] int32 per-tile offsets into the sorted stream
    raw_counts   [T] int32 unclipped per-tile entry counts
    entry_counts [N] int32 per-Gaussian emitted entries (<= k_dup)
    """

    tile_lists: torch.Tensor
    tile_counts: torch.Tensor
    num_clipped: torch.Tensor
    num_overflow: torch.Tensor
    sorted_entries: torch.Tensor
    sorted_tiles: torch.Tensor
    starts: torch.Tensor
    raw_counts: torch.Tensor
    entry_counts: torch.Tensor


def tile_grid(width: int, height: int, tile: int = TILE) -> tuple[int, int]:
    return (-(-width // tile), -(-height // tile))


def compute_rects(means2d: torch.Tensor, radii: torch.Tensor, width: int,
                  height: int, tile: int = TILE, extents=None):
    """Per-Gaussian tile rect [x0, y0, x1, y1) like getRect
    (reference: cuda_rasterizer/auxiliary.h:46-56); with `extents` [N, 2] the
    tight bounding box of the visible footprint instead of the radius
    square."""
    gx, gy = tile_grid(width, height, tile)
    if extents is None:
        rx = ry = radii.to(torch.float32)
    else:
        rx, ry = extents[:, 0], extents[:, 1]

    def cell(v, hi):
        return torch.clamp(torch.floor(v / tile), 0, hi).to(torch.int32)

    x0 = cell(means2d[:, 0] - rx, gx)
    y0 = cell(means2d[:, 1] - ry, gy)
    x1 = cell(means2d[:, 0] + rx + tile - 1, gx)
    y1 = cell(means2d[:, 1] + ry + tile - 1, gy)
    return x0, y0, x1, y1


def bin_gaussians(
    means2d: torch.Tensor,
    depths: torch.Tensor,
    radii: torch.Tensor,
    visible: torch.Tensor,
    width: int,
    height: int,
    tile: int = TILE,
    max_tiles_per_gaussian: int = 64,
    max_per_tile: int = 512,
    extents=None,
    key_tiles: int | None = None,
) -> TileBinning:
    """Build depth-ordered per-tile lists; all shapes static.

    Rects larger than `max_tiles_per_gaussian` tiles keep their tile of the
    projected mean and are trimmed symmetrically around it. `extents` [N, 2]
    switches to tight per-axis footprint rects. `key_tiles` sizes the
    packed keys' depth code for that many tiles instead of this grid's: a
    band of a larger frame passes the frame's tile count, so that its
    depths tie exactly where the frame's do (and then sort as the frame's
    wherever the sort keeps tied keys in entry order, as the card's radix
    sort does at the main path's sizes).
    """
    dev = means2d.device
    n = means2d.shape[0]
    gx, gy = tile_grid(width, height, tile)
    num_tiles = gx * gy
    k_dup = max_tiles_per_gaussian
    # Bits available for the in-key depth code (tile ids occupy the top).
    depth_bits = 31 - max(1, (max(num_tiles, key_tiles or 0) + 1)
                          ).bit_length()
    if depth_bits < 12:
        raise ValueError(f"too many tiles ({num_tiles}) for packed keys")

    vis_s = visible
    if extents is not None:
        vis_s = vis_s & (extents[:, 0] > 0.0)

    x0, y0, x1, y1 = compute_rects(means2d, radii, width, height, tile,
                                   extents=extents)
    rw = x1 - x0
    rh = y1 - y0
    area = rw * rh

    # Clip rects (centered) so rw*rh <= k_dup: width first, then height.
    needs_clip = (area > k_dup) & vis_s
    num_clipped = needs_clip.sum(dtype=torch.int32)

    def clip_side(lo, hi, center, max_len):
        """Trim [lo, hi) symmetrically around `center` to at most max_len."""
        excess = torch.clamp_min(hi - lo - max_len, 0)
        lo2 = torch.minimum(lo + excess // 2, center)
        hi2 = torch.maximum(hi - (excess - excess // 2), center + 1)
        return lo2, hi2

    cx = torch.clamp((means2d[:, 0] / tile).to(torch.int32), 0, gx - 1)
    cy = torch.clamp((means2d[:, 1] / tile).to(torch.int32), 0, gy - 1)
    side = int(max(1, int(k_dup**0.5)))
    max_w = torch.where(needs_clip, side, torch.clamp_min(rw, 1))
    x0c, x1c = clip_side(x0, x1, cx, max_w)
    rw_c = torch.clamp_min(x1c - x0c, 1)
    max_h = torch.where(needs_clip, k_dup // rw_c, torch.clamp_min(rh, 1))
    y0c, y1c = clip_side(y0, y1, cy, max_h)
    rw_f = x1c - x0c
    area_f = rw_f * (y1c - y0c)
    area_f = torch.where(vis_s & (area > 0), area_f, 0)

    # One packed key per (gaussian, slot): [tile_id | depth_code]. The
    # float32 bits of a non-negative depth, shifted right logically.
    depth_bits_all = torch.clamp_min(depths, 0.0).view(torch.int32)
    depth_code = ((depth_bits_all.to(torch.int64) & 0xFFFFFFFF)
                  >> (31 - depth_bits)).to(torch.int32)
    slots = torch.arange(k_dup, dtype=torch.int32, device=dev)
    # Rect widths > k_dup (clipped off-center rects) behave as k_dup: slots
    # < k_dup, so % is the identity and // is zero.
    rw_sel = torch.clamp(rw_f, 1, k_dup)[:, None]
    sx = x0c[:, None] + slots[None, :] % rw_sel
    sy = y0c[:, None] + torch.div(slots[None, :], rw_sel,
                                  rounding_mode="floor")
    valid = slots[None, :] < area_f[:, None]
    tile_ids = (sy * gx + sx).to(torch.int32)
    sentinel = num_tiles << depth_bits
    keys = torch.where(valid, (tile_ids << depth_bits) | depth_code[:, None],
                       sentinel).to(torch.int32)

    # One unstable sort; the payload is the flat entry id, which is the
    # sort permutation itself.
    sorted_keys, perm = torch.sort(keys.reshape(-1), stable=False)
    sorted_entries = perm.to(torch.int32)

    bounds = torch.searchsorted(
        sorted_keys,
        torch.arange(num_tiles + 1, dtype=torch.int32, device=dev)
        << depth_bits,
        side="left",
    ).to(torch.int32)
    starts = bounds[:-1]
    counts = bounds[1:] - starts
    num_overflow = torch.clamp_min(counts - max_per_tile, 0).sum(
        dtype=torch.int32)
    tile_counts = torch.clamp_max(counts, max_per_tile)

    tile_lists = window_gather(sorted_entries, starts.contiguous(),
                               max_per_tile, tile_counts.contiguous())

    return TileBinning(
        tile_lists=tile_lists,
        tile_counts=tile_counts,
        num_clipped=num_clipped,
        num_overflow=num_overflow,
        sorted_entries=sorted_entries,
        sorted_tiles=(sorted_keys >> depth_bits).to(torch.int32),
        starts=starts,
        raw_counts=counts,
        # Emission is slots < area_f over k_dup slots, so at most k_dup.
        entry_counts=torch.clamp_max(area_f, k_dup).to(torch.int32),
    )


def window_lists(binning: TileBinning, offset: int,
                 capacity: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tile entry lists for the window [offset, offset+capacity) of each
    tile's depth-ordered stream segment: the continuation windows of the
    multi-pass overflow renderer (ops/tiled.render_pallas).

    Returns (lists [T, capacity] with -1 padding, counts [T])."""
    counts = torch.clamp(binning.raw_counts - offset, 0, capacity)
    return window_gather(binning.sorted_entries,
                         (binning.starts + offset).contiguous(), capacity,
                         counts), counts
