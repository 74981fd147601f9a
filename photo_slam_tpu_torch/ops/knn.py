"""Mean squared distance to the 3 nearest neighbors: Gaussian scale init.

Counterpart of photo_slam_tpu/ops/knn.py (reference: simple-knn's distCUDA2,
third_party/simple-knn/simple_knn.cu:185-221):

  * small N: exact chunked brute force, the [chunk, N] distance matrix as
    one matmul (|a-b|^2 = |a|^2 + |b|^2 - 2 a.b) followed by top-k;
  * large N: Morton-code sort + a +-W window search in Morton order.

The matmul runs in full float32 on the card as long as
torch.backends.cuda.matmul.allow_tf32 is False (PyTorch's default).
"""
from __future__ import annotations

import torch

_BRUTE_FORCE_MAX = 65536
_SENTINEL = 1e19
_BIG = 1e20


def _mean_excluding_sentinel(dists: torch.Tensor) -> torch.Tensor:
    """Mean over the last axis, ignoring sentinel-distance (missing) entries;
    0 where there are none."""
    real = dists < _SENTINEL
    cnt = torch.clamp_min(real.sum(dim=-1), 1)
    vals = torch.where(real, torch.clamp_min(dists, 0.0), 0.0)
    return vals.sum(dim=-1) / cnt


def _knn_mean_sq_dist_brute(points: torch.Tensor, live: torch.Tensor, k: int,
                            chunk: int = 2048) -> torch.Tensor:
    """Exact chunked brute force. points [N,3], live [N] bool -> [N]."""
    n = points.shape[0]
    sq = (points * points).sum(dim=-1)
    col = torch.arange(n, device=points.device)
    out = []
    for c0 in range(0, n, chunk):
        cpts = points[c0:c0 + chunk]
        d = sq[c0:c0 + chunk, None] + sq[None, :] - 2.0 * (cpts @ points.T)
        cidx = col[c0:c0 + chunk]
        d = torch.where(col[None, :] == cidx[:, None], _BIG, d)
        d = torch.where(live[None, :], d, _BIG)
        neg_top = torch.topk(-d, k, dim=-1).values
        mean = _mean_excluding_sentinel(-neg_top)
        out.append(torch.where(live[c0:c0 + chunk], mean, 0.0))
    return torch.cat(out)


def _morton_codes(points: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """30-bit Morton codes [N] int64 from points quantized to a 1024^3 grid
    over the live bounding box (same locality structure as
    simple_knn.cu:45-70)."""
    lo = torch.where(live[:, None], points, _BIG).amin(dim=0)
    hi = torch.where(live[:, None], points, -_BIG).amax(dim=0)
    extent = torch.clamp_min(hi - lo, 1e-9)
    q = torch.clamp(((points - lo) / extent) * 1023.0, 0, 1023).to(torch.int64)

    def spread(v):
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    return spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)


def _knn_mean_sq_dist_morton(points: torch.Tensor, live: torch.Tensor, k: int,
                             window: int = 64) -> torch.Tensor:
    """Approximate KNN over a +-window neighborhood in Morton order."""
    n = points.shape[0]
    dev = points.device
    codes = _morton_codes(points, live)
    # Dead points sink to the end of the Morton order (codes < 2^30).
    key = torch.where(live, codes, 0xFFFFFFFF)
    order = torch.argsort(key, stable=True)
    pts_s = points[order]
    live_s = live[order]

    offs = torch.arange(-window, window + 1, device=dev)
    offs = offs[offs != 0]
    idx = torch.arange(n, device=dev)[:, None] + offs[None, :]
    valid = (idx >= 0) & (idx < n)
    idx = idx.clamp(0, n - 1)
    nbr = pts_s[idx]                       # [N, 2W, 3]
    nbr_live = live_s[idx] & valid
    d = ((pts_s[:, None, :] - nbr) ** 2).sum(dim=-1)
    d = torch.where(nbr_live, d, _BIG)
    neg_top = torch.topk(-d, k, dim=-1).values
    mean_s = _mean_excluding_sentinel(-neg_top)
    mean_s = torch.where(live_s, mean_s, 0.0)
    out = torch.zeros(n, dtype=points.dtype, device=dev)
    out[order] = mean_s
    return out


def knn_mean_sq_dist(points: torch.Tensor, live: torch.Tensor | None = None,
                     k: int = 3) -> torch.Tensor:
    """Mean squared distance of each live point to its k nearest live
    neighbors (distCUDA2 semantics). Returns [N]; dead entries are 0."""
    n = points.shape[0]
    if live is None:
        live = torch.ones(n, dtype=torch.bool, device=points.device)
    if n <= _BRUTE_FORCE_MAX:
        return _knn_mean_sq_dist_brute(points, live, k)
    return _knn_mean_sq_dist_morton(points, live, k)


def scale_init_from_points(points: torch.Tensor,
                           live: torch.Tensor | None = None) -> torch.Tensor:
    """log-scale init: log(sqrt(clamp(knn_dist2, 1e-7))) replicated to 3 axes
    (reference: src/gaussian_model.cpp:154-158)."""
    dist2 = torch.clamp_min(knn_mean_sq_dist(points, live), 1e-7)
    s = torch.log(torch.sqrt(dist2))
    return s[:, None].repeat(1, 3)
