"""Tiled kernel renderer: bin at 32px tiles, pack entries, blend per tile.

Counterpart of photo_slam_tpu/ops/tiled.py::render_pallas, differentiable
with respect to the preprocessed Gaussians (binning sees detached inputs,
as JAX's stop_gradient does). `entry_gather` is the row gather
feat[max(id, 0) // k_dup]; its transpose (`entry_gather_transpose`) adds
each [T, K, 16] gradient row back into its Gaussian with an f32
`index_add_`, where the JAX package routes bf16 rows through sorts
(photo_slam_tpu/ops/tiled.py:97-218, 245-286, a TPU workaround). Only the
lanes 0-8 carry gradient.
"""
from __future__ import annotations

import torch

from photo_slam_tpu_torch.ops.binning import (bin_gaussians, tile_grid,
                                              window_gather, window_lists)
from photo_slam_tpu_torch.ops.blend import FEAT, TILE_PS, pallas_blend
from photo_slam_tpu_torch.ops.dense import RenderOutput
from photo_slam_tpu_torch.ops.preprocess import Preprocessed, tight_extents


GRAD_LANES = 9  # packed lanes that carry gradient (ops/blend.py layout)


def entry_gather_transpose(g: torch.Tensor, entry_lists: torch.Tensor,
                           k_dup: int, n: int) -> torch.Tensor:
    """Transpose of entry_gather: [n, D] f32 sums of the gradient rows g
    [..., D] over each Gaussian's entries (invalid ids add nothing). Lanes
    >= GRAD_LANES are zero."""
    d = g.shape[-1]
    valid = entry_lists >= 0
    idx = torch.where(valid, entry_lists // k_dup, 0).reshape(-1)
    rows = torch.where(valid[..., None], g[..., :GRAD_LANES], 0.0)
    out = torch.zeros((n, GRAD_LANES), dtype=torch.float32, device=g.device)
    out.index_add_(0, idx, rows.reshape(-1, GRAD_LANES))
    return torch.nn.functional.pad(out, (0, d - GRAD_LANES))


class _EntryGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feat, entry_lists, k_dup):
        ctx.save_for_backward(entry_lists)
        ctx.k_dup, ctx.n = k_dup, feat.shape[0]
        return feat[torch.where(entry_lists >= 0, entry_lists // k_dup, 0)]

    @staticmethod
    def backward(ctx, g):
        (entry_lists,) = ctx.saved_tensors
        return (entry_gather_transpose(g, entry_lists, ctx.k_dup, ctx.n),
                None, None)


def entry_gather(feat: torch.Tensor, entry_lists: torch.Tensor,
                 k_dup: int) -> torch.Tensor:
    """Per-entry rows of `feat` [N, D] for entry ids (gaussian * k_dup +
    slot, -1 invalid): [..., D], invalid ids reading Gaussian 0.
    Differentiable in feat through entry_gather_transpose."""
    return _EntryGather.apply(feat, entry_lists, k_dup)


def pack_features(prep: Preprocessed, opacities: torch.Tensor) -> torch.Tensor:
    """Per-Gaussian [N, 16] rows in the packed entry layout
    (ops/blend.py): mean2d, conic, opacity, rgb, zero padding."""
    n = prep.means2d.shape[0]
    return torch.cat([
        prep.means2d, prep.conics, opacities[:, None], prep.rgb,
        torch.zeros((n, FEAT - 9), dtype=torch.float32,
                    device=prep.means2d.device),
    ], dim=-1)


def render_pallas(
    prep: Preprocessed,
    opacities: torch.Tensor,
    width: int,
    height: int,
    bg_color: torch.Tensor,
    max_tiles_per_gaussian: int = 16,
    max_per_tile: int = 1024,
    overflow_passes: int = 1,
    overflow_capacity: int = 512,
    overflow_compact: int = 128,
    key_tiles: int | None = None,
):
    """Bin at 32px tiles, pack the [N, 16] entries, run the blend kernel,
    assemble the image. Returns (RenderOutput, TileBinning). `key_tiles`
    goes to bin_gaussians (a band of a larger frame).

    overflow_passes > 1 runs continuation passes over the depth-tail entries
    of tiles deeper than max_per_tile. Compositing is homogeneous in the
    incoming transmittance, so C = C_1 + T_1 C_2' and T = T_1 T_2' (primed =
    blended from T = 1) is exact. With 0 < overflow_compact < T the
    continuation runs only over the `overflow_compact` overflowed tiles with
    the most residual light (sum of pass-1 final_T); the other tiles keep
    their 1-pass result and their residual stays in num_overflow.
    """
    tile = TILE_PS
    gx, gy = tile_grid(width, height, tile)
    num_tiles = gx * gy
    k_dup = max_tiles_per_gaussian

    binning = bin_gaussians(
        prep.means2d.detach(), prep.depths.detach(), prep.radii, prep.visible,
        width, height, tile=tile, max_tiles_per_gaussian=k_dup,
        max_per_tile=max_per_tile,
        extents=tight_extents(prep.conics.detach(), opacities.detach(),
                              prep.radii),
        key_tiles=key_tiles,
    )

    feat = pack_features(prep, opacities)
    data_tiles = entry_gather(feat, binning.tile_lists, k_dup)  # [T, K, 16]
    color, final_t, n_contrib = pallas_blend(
        data_tiles, binning.tile_counts, gx, num_tiles)

    t_sub = min(overflow_compact, num_tiles) if overflow_compact else 0
    if 0 < t_sub < num_tiles:
        t_res = final_t.detach().reshape(num_tiles, -1).sum(dim=-1)
        overflowed = binning.raw_counts > max_per_tile
        score = torch.where(overflowed, t_res, -1.0)
        order = torch.argsort(-score, stable=True)[:t_sub].to(torch.int32)
    else:
        order = None
    for p in range(1, overflow_passes):
        offset = max_per_tile + (p - 1) * overflow_capacity
        if order is not None:
            sel = order.long()
            starts_sub = (binning.starts[sel] + offset).contiguous()
            counts_sub = torch.clamp(binning.raw_counts[sel] - offset, 0,
                                     overflow_capacity)
            lists_p = window_gather(binning.sorted_entries, starts_sub,
                                    overflow_capacity, counts_sub)
            data_p = entry_gather(feat, lists_p, k_dup)
            c_p, t_p, n_p = pallas_blend(data_p, counts_sub, gx, t_sub, order)
            # Scatter the subset's results back to their tiles (the JAX
            # package does this with a one-hot matmul; the values are the
            # same).
            color = color.index_copy(0, sel, color[sel]
                                     + final_t[sel][:, None] * c_p)
            n_contrib = n_contrib.index_copy(0, sel, n_contrib[sel] + n_p)
            final_t = final_t.index_copy(0, sel, final_t[sel] * t_p)
        else:
            lists_p, counts_p = window_lists(binning, offset,
                                             overflow_capacity)
            data_p = entry_gather(feat, lists_p, k_dup)
            c_p, t_p, n_p = pallas_blend(data_p, counts_p, gx, num_tiles)
            color = color + final_t[:, None] * c_p
            n_contrib = n_contrib + n_p
            final_t = final_t * t_p

    # Residual-overflow accounting: credit each tile only with the
    # continuation capacity it actually received.
    if overflow_passes > 1:
        extra_cap = (overflow_passes - 1) * overflow_capacity
        per_tile_over = torch.clamp_min(binning.raw_counts - max_per_tile, 0)
        if order is not None:
            covered = torch.clamp_max(per_tile_over[order.long()],
                                      extra_cap).sum(dtype=torch.int32)
            residual = binning.num_overflow - covered
        else:
            residual = torch.clamp_min(per_tile_over - extra_cap, 0).sum(
                dtype=torch.int32)
        binning = binning._replace(num_overflow=residual)

    def tiles_to_image(x):
        """[T, ..., 8, 128] -> [..., H, W]; pixel p = r*32 + c of a tile."""
        extra = tuple(x.shape[1:-2])
        img = x.reshape((gy, gx) + extra + (tile, tile))
        nex = len(extra)
        # [gy, gx, ..., r, c] -> [..., gy, r, gx, c]
        perm = tuple(range(2, 2 + nex)) + (0, 2 + nex, 1, 3 + nex)
        img = img.permute(perm).reshape(extra + (gy * tile, gx * tile))
        return img[..., :height, :width]

    final_img = tiles_to_image(final_t)
    image = tiles_to_image(color) + final_img[None] * bg_color[:, None, None]
    out = RenderOutput(image=image, final_T=final_img,
                       n_contrib=tiles_to_image(n_contrib))
    return out, binning
