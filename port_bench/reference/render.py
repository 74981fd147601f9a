"""Preprocess, SH, tile binning with the caps, and the tile blend with its
gradient, in plain PyTorch: one render of activated Gaussians."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from port_bench.reference.camera import (Matrices, ndc_to_pixel,
                                         transform_43, transform_44)

NEAR_CULL_Z = 0.2
COV2D_LOWPASS = 0.3
TILE = 32            # pixel tile edge of the blend: 1024 pixels a tile
FEAT = 16            # lanes of a packed entry row
ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


class Settings(NamedTuple):
    width: int
    height: int
    tan_fovx: float
    tan_fovy: float
    sh_degree: int
    k_dup: int               # tile slots a Gaussian may take
    max_per_tile: int        # entries a tile blends
    principal: Optional[tuple] = None   # (cx, cy); None: the centre


class Frame(NamedTuple):
    image: torch.Tensor      # [3, H, W]
    data: torch.Tensor       # [T, K, 16] the blended entry rows
    counts: torch.Tensor     # [T] entries each tile blends
    n_contrib: torch.Tensor  # [T, 1024]
    tiles_x: int
    visible: torch.Tensor    # [N] bool
    keys: int                # sort keys (N * k_dup)


def activated(params: dict):
    """(scales, unit quats, opacities [N], shs [N, K, 3]) of raw params."""
    scales = torch.exp(params["log_scales"])
    quats = params["quats"] / torch.linalg.norm(params["quats"], dim=-1,
                                                keepdim=True)
    opac = torch.sigmoid(params["opacity_logit"][:, 0])
    shs = torch.cat([params["features_dc"], params["features_rest"]], dim=1)
    return scales, quats, opac, shs


def cov3d(scales, quats):
    w, x, y, z = quats[..., 0], quats[..., 1], quats[..., 2], quats[..., 3]
    r00 = 1.0 - 2.0 * (y * y + z * z)
    r01 = 2.0 * (x * y - w * z)
    r02 = 2.0 * (x * z + w * y)
    r10 = 2.0 * (x * y + w * z)
    r11 = 1.0 - 2.0 * (x * x + z * z)
    r12 = 2.0 * (y * z - w * x)
    r20 = 2.0 * (x * z - w * y)
    r21 = 2.0 * (y * z + w * x)
    r22 = 1.0 - 2.0 * (x * x + y * y)
    sx, sy, sz = scales[..., 0], scales[..., 1], scales[..., 2]
    m00, m01, m02 = r00 * sx, r01 * sy, r02 * sz
    m10, m11, m12 = r10 * sx, r11 * sy, r12 * sz
    m20, m21, m22 = r20 * sx, r21 * sy, r22 * sz
    return torch.stack([
        m00 * m00 + m01 * m01 + m02 * m02, m00 * m10 + m01 * m11 + m02 * m12,
        m00 * m20 + m01 * m21 + m02 * m22, m10 * m10 + m11 * m11 + m12 * m12,
        m10 * m20 + m11 * m21 + m12 * m22, m20 * m20 + m21 * m21 + m22 * m22,
    ], dim=-1)


def cov2d(means, c3, viewmatrix, fx, fy, tan_fovx, tan_fovy, prec):
    """EWA 2D covariance (a, b, c) plus the 0.3 low-pass on the diagonal,
    the Jacobian taken at the point clamped to 1.3x the field of view."""
    t = transform_43(means, viewmatrix, prec)
    tz = t[..., 2]
    tx = torch.clamp(t[..., 0] / tz, -1.3 * tan_fovx, 1.3 * tan_fovx) * tz
    ty = torch.clamp(t[..., 1] / tz, -1.3 * tan_fovy, 1.3 * tan_fovy) * tz
    inv_tz = 1.0 / tz
    inv_tz2 = inv_tz * inv_tz
    j00 = fx * inv_tz
    j02 = -fx * tx * inv_tz2
    j11 = fy * inv_tz
    j12 = -fy * ty * inv_tz2
    R = viewmatrix[:3, :3]
    u0 = j00[..., None] * R[0][None, :] + j02[..., None] * R[2][None, :]
    u1 = j11[..., None] * R[1][None, :] + j12[..., None] * R[2][None, :]
    xx, xy, xz, yy, yz, zz = (c3[..., i] for i in range(6))

    def sig(v):
        return torch.stack([xx * v[..., 0] + xy * v[..., 1] + xz * v[..., 2],
                            xy * v[..., 0] + yy * v[..., 1] + yz * v[..., 2],
                            xz * v[..., 0] + yz * v[..., 1] + zz * v[..., 2]],
                           dim=-1)

    s0 = sig(u0)
    a = (u0 * s0).sum(dim=-1) + COV2D_LOWPASS
    b = (u1 * s0).sum(dim=-1)
    c = (u1 * sig(u1)).sum(dim=-1) + COV2D_LOWPASS
    return a, b, c


def sh_rgb(degree: int, shs, means, campos):
    """SH colours (degree <= 3) along the view directions, +0.5, clamped
    at 0."""
    d = means - campos[None, :]
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    r = SH_C0 * shs[..., 0, :]
    if degree > 0:
        x, y, z = d[..., 0:1], d[..., 1:2], d[..., 2:3]
        r = (r - SH_C1 * y * shs[..., 1, :] + SH_C1 * z * shs[..., 2, :]
             - SH_C1 * x * shs[..., 3, :])
        if degree > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            r = (r + SH_C2[0] * xy * shs[..., 4, :]
                 + SH_C2[1] * yz * shs[..., 5, :]
                 + SH_C2[2] * (2.0 * zz - xx - yy) * shs[..., 6, :]
                 + SH_C2[3] * xz * shs[..., 7, :]
                 + SH_C2[4] * (xx - yy) * shs[..., 8, :])
            if degree > 2:
                r = (r + SH_C3[0] * y * (3.0 * xx - yy) * shs[..., 9, :]
                     + SH_C3[1] * xy * z * shs[..., 10, :]
                     + SH_C3[2] * y * (4.0 * zz - xx - yy) * shs[..., 11, :]
                     + SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy)
                     * shs[..., 12, :]
                     + SH_C3[4] * x * (4.0 * zz - xx - yy) * shs[..., 13, :]
                     + SH_C3[5] * z * (xx - yy) * shs[..., 14, :]
                     + SH_C3[6] * x * (xx - 3.0 * yy) * shs[..., 15, :])
    return torch.clamp_min(r + 0.5, 0.0)


def preprocess(means, scales, quats, shs, cam: Matrices, s: Settings,
               prec: str):
    """(means2d, depths, conics [N, 3], radii int32, rgb, visible)."""
    fx = s.width / (2.0 * s.tan_fovx)
    fy = s.height / (2.0 * s.tan_fovy)
    depths = transform_43(means, cam.viewmatrix, prec)[..., 2]
    p_hom = transform_44(means, cam.full_proj, prec)
    p_w = 1.0 / (p_hom[..., 3] + 1e-7)
    p_proj = p_hom[..., :3] * p_w[..., None]
    a, b, c = cov2d(means, cov3d(scales, quats), cam.viewmatrix, fx, fy,
                    s.tan_fovx, s.tan_fovy, prec)
    det = a * c - b * b
    det_ok = det != 0.0
    det_inv = 1.0 / torch.where(det_ok, det, 1.0)
    conics = torch.stack([c * det_inv, -b * det_inv, a * det_inv], dim=-1)
    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam))
    px = ndc_to_pixel(p_proj[..., 0], s.width)
    py = ndc_to_pixel(p_proj[..., 1], s.height)
    if s.principal is not None:
        px = px + (s.principal[0] - 0.5 * s.width)
        py = py + (s.principal[1] - 0.5 * s.height)
    means2d = torch.stack([px, py], dim=-1)
    visible = ((depths > NEAR_CULL_Z) & det_ok
               & (means2d[..., 0] + radius > 0)
               & (means2d[..., 0] - radius < s.width)
               & (means2d[..., 1] + radius > 0)
               & (means2d[..., 1] - radius < s.height))
    radii = torch.where(visible, radius, 0.0).to(torch.int32)
    rgb = sh_rgb(s.sh_degree, shs, means, cam.cam_center)
    return means2d, depths, conics, radii, rgb, visible


def tight_extents(conics, opac, radii):
    """Per-axis half-extents of {opacity * exp(-0.5 d^T C d) >= 1/255},
    with a pixel of margin, capped at the radius; 0 where never visible."""
    a, b, c = conics[..., 0], conics[..., 1], conics[..., 2]
    det = torch.clamp_min(a * c - b * b, 1e-12)
    L = torch.log(torch.clamp_min(opac, 1e-12) / ALPHA_MIN) * 1.001
    dead = L <= 0.0
    L = torch.clamp_min(L, 0.0)
    ex = torch.sqrt(2.0 * L * torch.clamp_min(c / det, 0.0)) + 1.0
    ey = torch.sqrt(2.0 * L * torch.clamp_min(a / det, 0.0)) + 1.0
    r = radii.to(torch.float32)
    ext = torch.stack([torch.minimum(ex, r), torch.minimum(ey, r)], dim=-1)
    return torch.where(dead[..., None], 0.0, ext)


def bin_tiles(means2d, depths, radii, visible, extents, s: Settings):
    """Depth-ordered per-tile entry lists with the caps: each Gaussian's
    rect of tiles trimmed around its centre tile to at most k_dup, one
    (tile | depth) int32 key a slot, one sort, the first max_per_tile of
    each tile. Returns (lists [T, K] of entry ids gaussian * k_dup + slot,
    -1 past the count; counts [T]; tiles_x)."""
    dev = means2d.device
    k_dup = s.k_dup
    gx, gy = -(-s.width // TILE), -(-s.height // TILE)
    num_tiles = gx * gy
    depth_bits = 31 - max(1, num_tiles + 1).bit_length()
    vis = visible & (extents[:, 0] > 0.0)
    rx, ry = extents[:, 0], extents[:, 1]

    def cell(v, hi):
        return torch.clamp(torch.floor(v / TILE), 0, hi).to(torch.int32)

    x0, y0 = cell(means2d[:, 0] - rx, gx), cell(means2d[:, 1] - ry, gy)
    x1 = cell(means2d[:, 0] + rx + TILE - 1, gx)
    y1 = cell(means2d[:, 1] + ry + TILE - 1, gy)
    rw, rh = x1 - x0, y1 - y0
    area = rw * rh
    clip = (area > k_dup) & vis

    def trim(lo, hi, centre, max_len):
        excess = torch.clamp_min(hi - lo - max_len, 0)
        return (torch.minimum(lo + excess // 2, centre),
                torch.maximum(hi - (excess - excess // 2), centre + 1))

    cx = torch.clamp((means2d[:, 0] / TILE).to(torch.int32), 0, gx - 1)
    cy = torch.clamp((means2d[:, 1] / TILE).to(torch.int32), 0, gy - 1)
    side = int(max(1, int(k_dup ** 0.5)))
    x0c, x1c = trim(x0, x1, cx, torch.where(clip, side,
                                             torch.clamp_min(rw, 1)))
    rw_c = torch.clamp_min(x1c - x0c, 1)
    y0c, y1c = trim(y0, y1, cy, torch.where(clip, k_dup // rw_c,
                                             torch.clamp_min(rh, 1)))
    rw_f = x1c - x0c
    area_f = torch.where(vis & (area > 0), rw_f * (y1c - y0c), 0)

    code = ((torch.clamp_min(depths, 0.0).view(torch.int32).to(torch.int64)
             & 0xFFFFFFFF) >> (31 - depth_bits)).to(torch.int32)
    slots = torch.arange(k_dup, dtype=torch.int32, device=dev)
    rw_sel = torch.clamp(rw_f, 1, k_dup)[:, None]
    sx = x0c[:, None] + slots[None, :] % rw_sel
    sy = y0c[:, None] + torch.div(slots[None, :], rw_sel,
                                  rounding_mode="floor")
    tile_ids = (sy * gx + sx).to(torch.int32)
    keys = torch.where(slots[None, :] < area_f[:, None],
                       (tile_ids << depth_bits) | code[:, None],
                       num_tiles << depth_bits).to(torch.int32)
    sorted_keys, perm = torch.sort(keys.reshape(-1), stable=False)
    entries = perm.to(torch.int32)
    bounds = torch.searchsorted(
        sorted_keys, torch.arange(num_tiles + 1, dtype=torch.int32,
                                  device=dev) << depth_bits,
        side="left").to(torch.int32)
    starts = bounds[:-1]
    counts = torch.clamp_max(bounds[1:] - starts, s.max_per_tile)
    j = torch.arange(s.max_per_tile, device=dev)
    idx = (starts.to(torch.int64)[:, None] + j[None, :]).clamp(
        0, entries.shape[0] - 1)
    lists = torch.where(j[None, :] < counts[:, None], entries[idx], -1)
    return lists, counts, gx


def tile_pixels(num_tiles: int, tiles_x: int, device):
    """(px, py) [T, 1024] image coordinates of each tile's pixels."""
    ids = torch.arange(num_tiles, device=device)
    pix = torch.arange(TILE * TILE, device=device)
    px = ((ids % tiles_x) * TILE)[:, None].float() \
        + (pix % TILE).float()[None, :]
    py = ((ids // tiles_x) * TILE)[:, None].float() \
        + (pix // TILE).float()[None, :]
    return px, py


def pair_terms(row, px, py):
    """(dx, dy, power, e^power, o e^power, alpha, contributes) of entry
    rows [T, 16] at pixels [T, P], each product and sum rounded on its
    own."""
    dx = row[:, 0:1] - px
    dy = row[:, 1:2] - py
    power = (-0.5 * (row[:, 2:3] * dx * dx + row[:, 4:5] * dy * dy)
             - row[:, 3:4] * dx * dy)
    ex = torch.exp(power)
    raw = row[:, 5:6] * ex
    alpha = torch.clamp_max(raw, ALPHA_MAX)
    return dx, dy, power, ex, raw, alpha, (power <= 0.0) & (alpha >= ALPHA_MIN)


def blend_forward(data, counts, tiles_x):
    """Front-to-back compositing of each tile's entries at its pixels, with
    the early stop at T < 1e-4. Returns (color [T, 3, P], final T [T, P],
    n_contrib [T, P])."""
    dev = data.device
    nb, k_max, _ = data.shape
    px, py = tile_pixels(nb, tiles_x, dev)
    p = px.shape[1]
    color = torch.zeros((nb, 3, p), device=dev)
    trans = torch.ones((nb, p), device=dev)
    n_contrib = torch.zeros((nb, p), dtype=torch.int32, device=dev)
    done = torch.zeros((nb, p), dtype=torch.bool, device=dev)
    for k in range(min(k_max, int(counts.max())) if nb else 0):
        row = data[:, k, :]
        alpha, ok = pair_terms(row, px, py)[5:]
        contrib = (k < counts)[:, None] & ~done & ok
        test_t = trans * (1.0 - alpha)
        stop = contrib & (test_t < T_EPS)
        ok = contrib & ~stop
        done = done | stop
        w = alpha * trans
        color = torch.where(ok[:, None, :],
                            color + w[:, None, :] * row[:, 6:9, None], color)
        trans = torch.where(ok, test_t, trans)
        n_contrib = torch.where(ok, k + 1, n_contrib)
    return color, trans, n_contrib


def blend_backward(data, counts, final_t, n_contrib, g_color, g_t, tiles_x):
    """Gradient of blend_forward with respect to the entry rows, walking
    each tile's entries back to front and rebuilding T from the final T.
    Returns d_data [T, K, 16] (lanes 9-15 zero)."""
    dev = data.device
    nb, k_max, _ = data.shape
    px, py = tile_pixels(nb, tiles_x, dev)
    trans = final_t
    gtt = g_t * trans
    bc = torch.zeros_like(trans)
    d_data = torch.zeros((nb, k_max, FEAT), device=dev)
    cnt = counts[:, None]
    for k in range((min(k_max, int(counts.max())) if nb else 0) - 1, -1, -1):
        row = data[:, k, :]
        dx, dy, _, ex, raw, alpha, contrib = pair_terms(row, px, py)
        valid = (k < n_contrib) & (k < cnt) & contrib
        om = torch.where(valid, torch.clamp_min(1.0 - alpha, 0.01), 1.0)
        trans = torch.where(valid, trans / om, trans)
        a_t = torch.where(valid, alpha * trans, 0.0)
        gc = (g_color[:, 0] * row[:, 6:7] + g_color[:, 1] * row[:, 7:8]
              + g_color[:, 2] * row[:, 8:9])
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
            -0.5 * (dl_dp * dx * dx).sum(-1), -(dl_dp * dx * dy).sum(-1),
            -0.5 * (dl_dp * dy * dy).sum(-1), dl_do.sum(-1),
            (a_t * g_color[:, 0]).sum(-1), (a_t * g_color[:, 1]).sum(-1),
            (a_t * g_color[:, 2]).sum(-1)], dim=-1)
        d_data[:, k, :9] = torch.where(k < cnt, sums, 0.0)
    return d_data


class _Blend(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, counts, tiles_x):
        color, final_t, n_contrib = blend_forward(data, counts, tiles_x)
        ctx.save_for_backward(data, counts, final_t, n_contrib)
        ctx.tiles_x = tiles_x
        ctx.mark_non_differentiable(n_contrib)
        return color, final_t, n_contrib

    @staticmethod
    def backward(ctx, g_color, g_t, _):
        data, counts, final_t, n_contrib = ctx.saved_tensors
        # Entries past every pixel's last contributor have no gradient.
        counts = torch.minimum(counts, n_contrib.amax(dim=-1)).to(torch.int32)
        return blend_backward(data, counts, final_t, n_contrib,
                              g_color.contiguous(), g_t.contiguous(),
                              ctx.tiles_x), None, None


def render(params: dict, cam: Matrices, s: Settings, bg: torch.Tensor,
           prec: str = "f32") -> Frame:
    """The image of the map `params` (raw parameters: xyz, features_dc,
    features_rest, opacity_logit, log_scales, quats), differentiable in
    them."""
    scales, quats, opac, shs = activated(params)
    means2d, depths, conics, radii, rgb, visible = preprocess(
        params["xyz"], scales, quats, shs, cam, s, prec)
    ext = tight_extents(conics.detach(), opac.detach(), radii)
    lists, counts, gx = bin_tiles(means2d.detach(), depths.detach(), radii,
                                  visible, ext, s)
    n = means2d.shape[0]
    feat = torch.cat([means2d, conics, opac[:, None], rgb,
                      means2d.new_zeros((n, FEAT - 9))], dim=-1)
    data = feat[torch.where(lists >= 0, lists // s.k_dup, 0)]
    color, final_t, n_contrib = _Blend.apply(data, counts, gx)
    gy = -(-s.height // TILE)

    def to_image(x):
        """[T, ..., 1024] -> [..., H, W]."""
        extra = tuple(x.shape[1:-1])
        img = x.reshape((gy, gx) + extra + (TILE, TILE))
        nex = len(extra)
        perm = tuple(range(2, 2 + nex)) + (0, 2 + nex, 1, 3 + nex)
        img = img.permute(perm).reshape(extra + (gy * TILE, gx * TILE))
        return img[..., :s.height, :s.width]

    image = to_image(color) + to_image(final_t)[None] * bg[:, None, None]
    return Frame(image=image, data=data.detach(), counts=counts,
                 n_contrib=n_contrib, tiles_x=gx, visible=visible,
                 keys=n * s.k_dup)
