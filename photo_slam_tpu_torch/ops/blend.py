"""Tile blend: the renderer's hot loop, forward and backward.

Counterpart of photo_slam_tpu/ops/pallas/blend.py. `pallas_blend` is the
differentiable blend (a torch.autograd.Function, the JAX custom_vjp): its
forward is the kernel K1 (wrapper `blend_fwd`, csrc/blend_fwd.cu), its
backward the kernel K2 (wrapper `blend_bwd`, csrc/blend_bwd.cu).
`blend_fwd_plain` and `blend_bwd_plain` are their plain PyTorch versions.

Packed entry layout (16 f32 lanes per entry, as in the JAX package):
  0: mean2d.x   1: mean2d.y   2: conic.a   3: conic.b   4: conic.c
  5: opacity    6: r          7: g         8: b         9-15: unused
The gradient rows use the same layout (lanes 9-15 are always zero).
Outputs keep the JAX layouts: color [T, 3, 8, 128], final_T [T, 8, 128],
n_contrib [T, 8, 128], pixel p = r*32 + c of the 32x32 tile flattened as
8x128.
"""
from __future__ import annotations

import torch

from photo_slam_tpu_torch import kernels
from photo_slam_tpu_torch.utils import graphs

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


def pair_terms(row: torch.Tensor, px: torch.Tensor, py: torch.Tensor):
    """(dx, dy, power, e^power, o e^power, alpha, contributes) of entry
    rows [B, 16] at pixels px, py [B or 1, P]: each product and sum rounded
    on its own, as the kernels round them; alpha = min(0.99, o e^power),
    and a pair contributes where power <= 0 and alpha >= 1/255."""
    dx = row[:, 0:1] - px
    dy = row[:, 1:2] - py
    power = (-0.5 * (row[:, 2:3] * dx * dx + row[:, 4:5] * dy * dy)
             - row[:, 3:4] * dx * dy)
    ex = torch.exp(power)
    raw = row[:, 5:6] * ex
    alpha = torch.clamp_max(raw, ALPHA_MAX)
    return dx, dy, power, ex, raw, alpha, (power <= 0.0) & (alpha >= ALPHA_MIN)


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
        alpha, pair_ok = pair_terms(row, px, py)[5:]
        contrib = live & pair_ok
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


def _check_tensor(who, name, x, dev, dtype, shape):
    if (x.device != dev or x.dtype != dtype or tuple(x.shape) != shape
            or not x.is_contiguous()):
        raise ValueError(f"{who}: {name} must be a contiguous {dtype} "
                         f"{list(shape)} tensor on {dev}, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")


def _check_data(who, data_tiles, num_tiles):
    dev = data_tiles.device
    if dev.type != "cuda":
        raise ValueError(f"{who}: unsupported device {dev}")
    if (data_tiles.dtype != torch.float32 or data_tiles.dim() != 3
            or data_tiles.shape[2] != FEAT
            or data_tiles.shape[0] != num_tiles
            or not data_tiles.is_contiguous() or data_tiles.data_ptr() % 16):
        raise ValueError(
            f"{who}: data_tiles must be a contiguous, 16-byte aligned "
            f"float32 [{num_tiles}, K, {FEAT}] tensor, got {data_tiles.dtype} "
            f"{tuple(data_tiles.shape)}")


def _check_inputs(who, data_tiles, num_tiles, **tensors):
    """Raise on what the kernels cannot take: data_tiles (_check_data), or
    a tensor of `tensors` ({name: (tensor or None, dtype, shape)}) that is
    not a contiguous one of its dtype and shape on data_tiles' device.
    Returns (device, T, K)."""
    _check_data(who, data_tiles, num_tiles)
    dev = data_tiles.device
    for name, (x, dtype, shape) in tensors.items():
        if x is not None:
            _check_tensor(who, name, x, dev, dtype, shape)
    return dev, data_tiles.shape[0], data_tiles.shape[1]


def blend_fwd(data_tiles: torch.Tensor, counts: torch.Tensor,
              tiles_x: int, num_tiles: int,
              tile_ids: torch.Tensor | None = None):
    """Blend packed per-tile entries: the forward kernel K1 (the JAX
    _blend_fwd_call), not differentiable; `pallas_blend` is.

    data_tiles [T, K, 16] float32, counts [T] int32 valid entries per tile
    (depth-sorted prefixes), tiles_x tiles per image row, num_tiles = T; with
    `tile_ids` [T] int32 block i rasterizes image tile tile_ids[i] (the
    compact overflow continuation), without it tile i. Returns (color
    [T, 3, 8, 128], final_T [T, 8, 128], n_contrib [T, 8, 128]); the
    background is the caller's.

    On a CUDA tensor it launches csrc/blend_fwd.cu (or raises); on a CPU
    tensor it runs blend_fwd_plain. `blend_fwd.launches` counts kernel
    launches, a captured graph's at each replay (utils/graphs.py).
    """
    if data_tiles.device.type == "cpu":
        return blend_fwd_plain(data_tiles, counts, tiles_x, num_tiles,
                               tile_ids)
    dev, nb, k_max = _check_inputs(
        "blend_fwd", data_tiles, num_tiles,
        counts=(counts, torch.int32, (num_tiles,)),
        tile_ids=(tile_ids, torch.int32, (num_tiles,)))
    color = data_tiles.new_empty((nb, 3, PIX_SUB, PIX_LANE))
    final_t = data_tiles.new_empty((nb, PIX_SUB, PIX_LANE))
    n_contrib = counts.new_empty((nb, PIX_SUB, PIX_LANE))
    # No tile_ids: a null pointer, which the kernel reads as the identity.
    kernels.launch("blend_fwd", dev, data_tiles.data_ptr(), counts.data_ptr(),
                   None if tile_ids is None else tile_ids.data_ptr(), nb,
                   k_max, tiles_x, color.data_ptr(), final_t.data_ptr(),
                   n_contrib.data_ptr())
    graphs.count_launch(blend_fwd, dev)
    return color, final_t, n_contrib


blend_fwd.launches = 0


# The box of an entry that K1 and K2 skip their warps by (csrc/cull_box.cuh,
# whose comment derives it): relative and absolute slack for the
# kernel's rounding of the power and of alpha, the margins of
# ops/preprocess.py::tight_extents (L x 1.001, +1 px), and the smallest
# det' / (a c) that counts as bounded. X1's bf16 chain has its own slack
# and threshold, and an unbounded box from an opacity or mean of 2^64 up.
CULL_REL = 1e-6
CULL_ABS = 1e-6
CULL_SCALE = 1.001
CULL_PAD = 1.0
CULL_MIN_DET = 1e-9
BF16_CULL_REL = 0.025
BF16_CULL_ABS = 0.012
BF16_CULL_HUGE = 2.0 ** 64
BF16_ALPHA_MIN = 0.003936767578125   # bf16(1/255)


def _cull_boxes(f: torch.Tensor, amin: float, rel: float,
                abs_: float) -> torch.Tensor:
    """The boxes of entry_cull_boxes for f32 terms f [..., 6] (mx, my, a, b,
    c, o), a chain's threshold amin and its slack rel, abs_."""
    mx, my, a, b, c, o = f.unbind(-1)
    finite = torch.isfinite(f).all(-1)
    empty = finite & (o < amin)
    g_lo, g_hi = 1.0 - rel, 1.0 + rel
    ad, bd, cd = a.double(), b.double(), c.double()
    det = ad * cd * (g_lo * g_lo) - bd * bd * (g_hi * g_hi)
    bounded = finite & ~empty & (ad > 0.0) & (det > CULL_MIN_DET * ad * cd)
    l2 = 2.0 * (CULL_SCALE * (torch.log(o.double() / amin) + abs_))
    ex = torch.sqrt(l2 * cd * g_lo / det).float() + CULL_PAD
    ey = torch.sqrt(l2 * ad * g_lo / det).float() + CULL_PAD
    box = torch.stack([mx - ex, mx + ex, my - ey, my + ey], dim=-1)
    inf = float("inf")
    other = torch.where(empty[..., None],
                        box.new_tensor([inf, -inf, inf, -inf]),
                        box.new_tensor([-inf, inf, -inf, inf]))
    return torch.where(bounded[..., None], box, other)


def entry_cull_boxes(data: torch.Tensor) -> torch.Tensor:
    """[..., 4] float32 boxes (x_lo, x_hi, y_lo, y_hi) in image pixels of
    packed entry rows [..., 16]: every pixel at which the blend kernels'
    rounding can find power <= 0 and alpha >= 1/255 lies inside its entry's
    box. The plain version of the box K1 and K2 compute when they stage a
    row (csrc/cull_box.cuh), in the same steps: empty (+inf, -inf,
    +inf, -inf) where opacity < 1/255, unbounded (-inf, +inf, -inf, +inf)
    where a term is not finite, a <= 0 or the widened conic is (nearly)
    singular."""
    amin = float(torch.tensor(ALPHA_MIN, dtype=torch.float32))
    return _cull_boxes(data[..., :6].to(torch.float32), amin, CULL_REL,
                       CULL_ABS)


def entry_cull_boxes_bf16(data: torch.Tensor, ox: torch.Tensor,
                          oy: torch.Tensor) -> torch.Tensor:
    """X1's boxes (csrc/cull_box.cuh::cull_box_bf16): [..., 4] float32 in
    the tile-local frame of packed entry rows [..., 16] of tiles at origins
    ox, oy (f32, shaped as data[..., 0] or broadcast to it). Every tile-local
    pixel at which X1's bf16 chain (tools/exp_blend_bf16.py::
    power_alpha_bf16) finds power <= 0 and alpha >= bf16(1/255) lies inside
    its entry's box. Computed from the values that chain sees: mx' =
    bf16(x - ox), my', and a, b, c, o rounded to bf16. Empty and unbounded
    as entry_cull_boxes, and unbounded where o' or |mx'| or |my'| is 2^64 or
    more."""
    f = data[..., :6].to(torch.float32)
    mean = torch.stack([f[..., 0] - ox, f[..., 1] - oy], dim=-1)
    f = torch.cat([mean, f[..., 2:]], dim=-1).to(torch.bfloat16).float()
    box = _cull_boxes(f, BF16_ALPHA_MIN, BF16_CULL_REL, BF16_CULL_ABS)
    huge = ((f[..., 5] >= BF16_CULL_HUGE)
            | (f[..., 0:2].abs() >= BF16_CULL_HUGE).any(-1))
    inf = float("inf")
    return torch.where(huge[..., None], box.new_tensor([-inf, inf, -inf, inf]),
                       box)


def blend_bwd_plain(data_tiles: torch.Tensor, counts: torch.Tensor,
                    final_t: torch.Tensor, n_contrib: torch.Tensor,
                    g_color: torch.Tensor, g_t: torch.Tensor, tiles_x: int,
                    num_tiles: int,
                    tile_ids: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of the blend backward kernel: a loop over the
    entry rows from max(counts) - 1 down to 0, vectorized over tiles and
    pixels, rebuilding T from final_T as the reference does
    (cuda_rasterizer/backward.cu:398-557). Each step reduces its pixels into
    d_data[:, k, :9]; rows >= counts and lanes 9-15 stay exact zeros, and
    those rows are never used, so a NaN there changes nothing.

    counts are the tile's counts_eff (min(count, max n_contrib)); g_color
    [T, 3, 8, 128] and g_t [T, 8, 128] are the cotangents of color and
    final_T. Returns d_data [T, K, 16]."""
    dev = data_tiles.device
    nb, k_max, _ = data_tiles.shape
    p = TILE_PS * TILE_PS
    ids = _tile_ids_or_iota(tile_ids, num_tiles, dev)
    pix = torch.arange(p, device=dev)
    px = ((ids % tiles_x) * TILE_PS)[:, None].to(torch.float32) \
        + (pix % TILE_PS).to(torch.float32)[None, :]
    py = ((ids // tiles_x) * TILE_PS)[:, None].to(torch.float32) \
        + (pix // TILE_PS).to(torch.float32)[None, :]

    nc = n_contrib.reshape(nb, p)
    trans = final_t.reshape(nb, p)
    gcol = g_color.reshape(nb, 3, p)
    gtt = g_t.reshape(nb, p) * trans
    bc = torch.zeros((nb, p), dtype=torch.float32, device=dev)
    d_data = torch.zeros((nb, k_max, FEAT), dtype=torch.float32, device=dev)
    cnt = counts[:, None]
    n_iter = min(k_max, int(counts.max())) if nb else 0
    for k in range(n_iter - 1, -1, -1):
        row = data_tiles[:, k, :]                          # [T, 16]
        dx, dy, _, ex, raw, alpha, contrib = pair_terms(row, px, py)
        valid = (k < nc) & (k < cnt) & contrib
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
    return d_data


def blend_bwd(data_tiles: torch.Tensor, counts: torch.Tensor,
              final_t: torch.Tensor, n_contrib: torch.Tensor,
              g_color: torch.Tensor, g_t: torch.Tensor, tiles_x: int,
              num_tiles: int,
              tile_ids: torch.Tensor | None = None) -> torch.Tensor:
    """Gradient of the blend with respect to the packed entries: the
    backward kernel K2 (the JAX _blend_bwd_call). Arguments as
    blend_bwd_plain; returns d_data [T, K, 16].

    On a CUDA tensor it launches csrc/blend_bwd.cu (or raises); on a CPU
    tensor it runs blend_bwd_plain. `blend_bwd.launches` counts kernel
    launches, a captured graph's at each replay (utils/graphs.py).
    """
    if data_tiles.device.type == "cpu":
        return blend_bwd_plain(data_tiles, counts, final_t, n_contrib,
                               g_color, g_t, tiles_x, num_tiles, tile_ids)
    pix = (num_tiles, PIX_SUB, PIX_LANE)
    dev, nb, k_max = _check_inputs(
        "blend_bwd", data_tiles, num_tiles,
        counts=(counts, torch.int32, (num_tiles,)),
        tile_ids=(tile_ids, torch.int32, (num_tiles,)),
        final_t=(final_t, torch.float32, pix),
        n_contrib=(n_contrib, torch.int32, pix),
        g_color=(g_color, torch.float32, (num_tiles, 3, PIX_SUB, PIX_LANE)),
        g_t=(g_t, torch.float32, pix))
    d_data = torch.empty_like(data_tiles)
    kernels.launch("blend_bwd", dev, data_tiles.data_ptr(), counts.data_ptr(),
                   None if tile_ids is None else tile_ids.data_ptr(),
                   final_t.data_ptr(), n_contrib.data_ptr(),
                   g_color.data_ptr(), g_t.data_ptr(), nb, k_max, tiles_x,
                   d_data.data_ptr())
    graphs.count_launch(blend_bwd, dev)
    return d_data


blend_bwd.launches = 0


class _PallasBlend(torch.autograd.Function):
    """The blend with its gradient: forward K1, backward K2 (the JAX
    pallas_blend custom_vjp, blend.py:385-524). The kernels are looked up
    by module name at each call, so a caller may put the plain versions in
    their place."""

    @staticmethod
    def forward(ctx, data_tiles, counts, tiles_x, num_tiles, tile_ids):
        color, final_t, n_contrib = blend_fwd(data_tiles, counts, tiles_x,
                                              num_tiles, tile_ids)
        ctx.save_for_backward(data_tiles, counts, final_t, n_contrib,
                              tile_ids)
        ctx.tiles_x, ctx.num_tiles = tiles_x, num_tiles
        ctx.mark_non_differentiable(n_contrib)
        return color, final_t, n_contrib

    @staticmethod
    def backward(ctx, g_color, g_t, _g_n):
        data_tiles, counts, final_t, n_contrib, tile_ids = ctx.saved_tensors
        nb = data_tiles.shape[0]
        # Entries past the last contributor of every pixel of the tile have
        # zero gradient: bound the walk by the tile's max n_contrib
        # (blend.py:507-512).
        nc_max = n_contrib.reshape(nb, -1).amax(dim=-1)
        counts_eff = torch.minimum(counts, nc_max).to(torch.int32)
        d_data = blend_bwd(data_tiles, counts_eff, final_t, n_contrib,
                           g_color.contiguous(), g_t.contiguous(),
                           ctx.tiles_x, ctx.num_tiles, tile_ids)
        return d_data, None, None, None, None


def pallas_blend(data_tiles: torch.Tensor, counts: torch.Tensor,
                 tiles_x: int, num_tiles: int,
                 tile_ids: torch.Tensor | None = None):
    """Blend packed per-tile entries, differentiably with respect to
    data_tiles (the JAX pallas_blend). Arguments and outputs as blend_fwd;
    n_contrib carries no gradient. The forward launches K1 and the backward
    K2 on CUDA tensors; CPU tensors run their plain versions."""
    return _PallasBlend.apply(data_tiles, counts, tiles_x, num_tiles,
                              tile_ids)
