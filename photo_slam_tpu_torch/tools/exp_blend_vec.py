"""X3: the group-vectorized blend forward against the production blend K1.

Counterpart of tools/exp_blend_vec.py. The experiment takes K1's entries
in groups of G = 64: per group it forms each pixel's transmittance S_k
before and after every entry as T times a prefix product of (1 - alpha),
applies the entries with S_k >= 1e-4 with weight alpha S_k / (1 - alpha),
and lets a pixel die only at the end of a group. It is K1's function with
another rounding. `blend_vec` is the kernel (csrc/blend_vec_fwd.cu) and
`blend_vec_plain` its plain version.

main() runs K1 and X3 on the tool's synthetic tiles (38x22 tiles, K 1024,
low opacities, seed 0) and on the production pass-1 tiles of the
300k-Gaussian room at 1200x680 (32 px, k_dup 6, K 1024), and prints their
times and the largest difference of each output.

    python -m photo_slam_tpu_torch.tools.exp_blend_vec [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from photo_slam_tpu_torch import kernels
from photo_slam_tpu_torch.ops.blend import (ALPHA_MAX, ALPHA_MIN, FEAT,
                                            PIX_LANE, PIX_SUB, T_EPS, TILE_PS,
                                            _check_data, _check_tensor,
                                            blend_fwd)
from photo_slam_tpu_torch.tools.bench_room import (N_GAUSSIANS, parse_device,
                                                   room_view, tiles32, time_ms)

GRP = 64


def blend_vec_plain(data_tiles: torch.Tensor, counts: torch.Tensor,
                    tiles_x: int, num_tiles: int):
    """Plain PyTorch version of the group-vectorized blend (tile b is image
    tile b): per group of GRP entries, S = T * cumprod(om) along the group,
    the weights alpha S / om of the entries with S >= T_EPS, the colour as
    the group's sum of weighted rgb, T times the product of the applied om,
    and a pixel's death at the group's end (tool :49-97, the roll-ladder
    prefix products as a cumulative product). Returns (color [T, 3, 8, 128],
    final_T [T, 8, 128], n_contrib [T, 8, 128] int32)."""
    dev = data_tiles.device
    nb, k_max, _ = data_tiles.shape
    p = TILE_PS * TILE_PS
    ids = torch.arange(num_tiles, device=dev)
    pix = torch.arange(p, device=dev)
    px = (((ids % tiles_x) * TILE_PS)[:, None].to(torch.float32)
          + (pix % TILE_PS).to(torch.float32)[None, :])[:, None, :]
    py = (((ids // tiles_x) * TILE_PS)[:, None].to(torch.float32)
          + (pix // TILE_PS).to(torch.float32)[None, :])[:, None, :]
    color = torch.zeros((nb, 3, p), dtype=torch.float32, device=dev)
    trans = torch.ones((nb, p), dtype=torch.float32, device=dev)
    n_contrib = torch.zeros((nb, p), dtype=torch.int32, device=dev)
    alive = torch.ones((nb, p), dtype=torch.bool, device=dev)
    n_iter = min(k_max, int(counts.max())) if nb else 0
    for k0 in range(0, n_iter, GRP):
        rows = data_tiles[:, k0:k0 + GRP, :]               # [T, G, 16]
        g = rows.shape[1]
        k = torch.arange(k0, k0 + g, device=dev)[None, :, None]
        dx = rows[:, :, 0:1] - px
        dy = rows[:, :, 1:2] - py
        power = (-0.5 * (rows[:, :, 2:3] * dx * dx
                         + rows[:, :, 4:5] * dy * dy)
                 - rows[:, :, 3:4] * dx * dy)
        alpha = torch.clamp_max(rows[:, :, 5:6] * torch.exp(power), ALPHA_MAX)
        contrib = (alive[:, None, :] & (k < counts[:, None, None])
                   & (power <= 0.0) & (alpha >= ALPHA_MIN))
        om = torch.where(contrib, 1.0 - alpha, 1.0)
        s = trans[:, None, :] * torch.cumprod(om, dim=1)
        ok = contrib & (s >= T_EPS)
        w = torch.where(ok, alpha * (s / om), 0.0)
        color = color + (rows[:, :, 6:9, None] * w[:, :, None, :]).sum(1)
        n_contrib = torch.maximum(
            n_contrib, torch.where(ok, k + 1, 0).amax(1).to(torch.int32))
        trans = trans * torch.where(ok, om, 1.0).prod(1)
        alive = alive & ~(contrib & (s < T_EPS)).any(1)
    return (color.view(nb, 3, PIX_SUB, PIX_LANE),
            trans.view(nb, PIX_SUB, PIX_LANE),
            n_contrib.view(nb, PIX_SUB, PIX_LANE))


def blend_vec(data_tiles: torch.Tensor, counts: torch.Tensor, tiles_x: int,
              num_tiles: int):
    """The group-vectorized blend (the TPU's blend_vec): data_tiles
    [T, K, 16] float32, counts [T] int32, identity tile ids. Returns
    (color [T, 3, 8, 128], final_T [T, 8, 128], n_contrib [T, 8, 128]).

    On a CUDA tensor it launches csrc/blend_vec_fwd.cu (or raises); on a CPU
    tensor it runs blend_vec_plain. `blend_vec.launches` counts kernel
    launches."""
    if data_tiles.device.type == "cpu":
        return blend_vec_plain(data_tiles, counts, tiles_x, num_tiles)
    return launch_tile_blend("blend_vec_fwd", blend_vec, data_tiles, counts,
                             tiles_x, num_tiles)


blend_vec.launches = 0


def launch_tile_blend(kernel: str, wrapper, data_tiles, counts, tiles_x,
                      num_tiles):
    """Launch a 32 px tile blend with K1's arguments and outputs (identity
    tile ids) and count the launch on `wrapper`."""
    _check_data(wrapper.__name__, data_tiles, num_tiles)
    dev = data_tiles.device
    _check_tensor(wrapper.__name__, "counts", counts, dev, torch.int32,
                  (num_tiles,))
    color = torch.empty((num_tiles, 3, PIX_SUB, PIX_LANE),
                        dtype=torch.float32, device=dev)
    final_t = torch.empty((num_tiles, PIX_SUB, PIX_LANE), dtype=torch.float32,
                          device=dev)
    n_contrib = torch.empty((num_tiles, PIX_SUB, PIX_LANE), dtype=torch.int32,
                            device=dev)
    fn = kernels.launcher(kernel)
    with torch.cuda.device(dev):
        err = fn(data_tiles.data_ptr(), counts.data_ptr(), num_tiles,
                 data_tiles.shape[1], tiles_x, color.data_ptr(),
                 final_t.data_ptr(), n_contrib.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    kernels.check_launch(kernel, err)
    wrapper.launches += 1
    return color, final_t, n_contrib


def make_data(num_tiles: int, k: int, gx: int, seed: int = 0):
    """The tool's synthetic tiles (:136-155, numpy): random means inside
    each tile, axis-aligned conics, low opacities (0.01-0.1) so that no
    pixel saturates early, counts up to K. Returns numpy (data [T, K, 16]
    float32, counts [T] int32)."""
    rng = np.random.RandomState(seed)
    data = np.zeros((num_tiles, k, FEAT), np.float32)
    counts = np.minimum((rng.rand(num_tiles) * k * 1.2).astype(np.int32), k)
    for t in range(num_tiles):
        c = counts[t]
        tx, ty = t % gx, t // gx
        data[t, :c, 0] = tx * 32 + rng.rand(c) * 32
        data[t, :c, 1] = ty * 32 + rng.rand(c) * 32
        inv_s2 = 1.0 / rng.uniform(2.0, 40.0, c)
        data[t, :c, 2] = inv_s2
        data[t, :c, 4] = inv_s2 * rng.uniform(0.5, 2.0, c)
        data[t, :c, 3] = 0.0
        data[t, :c, 5] = rng.uniform(0.01, 0.1, c)
        data[t, :c, 6:9] = rng.rand(c, 3)
    return data, counts


def real_data(n: int = N_GAUSSIANS, *, device):
    """The production workload (tool :170-203): the room scene through the
    port's preprocess, binning at 32 px and entry_gather. Returns (data
    [T, 1024, 16], counts [T], tiles_x, num_tiles)."""
    t = tiles32(room_view(n, device=device))
    return t.data, t.counts, t.tiles_x, t.num_tiles


def compare(name, data, counts, gx, nt, reps, log=print) -> dict:
    """K1 and X3 on one input: times and the largest difference of each
    output."""
    dev = data.device
    o1 = blend_fwd(data, counts, gx, nt)
    o2 = blend_vec(data, counts, gx, nt)
    k1_ms = time_ms(lambda: blend_fwd(data, counts, gx, nt), reps, dev)
    vec_ms = time_ms(lambda: blend_vec(data, counts, gx, nt), reps, dev)
    diffs = {n: float((a.float() - b.float()).abs().max())
             for a, b, n in zip(o1, o2, ("color", "T", "nc"))}
    log(f"{name}: K1 {k1_ms:.4f} ms, X3 vectorized {vec_ms:.4f} ms; "
        + ", ".join(f"max |d {n}| = {d:.3e}" for n, d in diffs.items()))
    return dict(k1_ms=k1_ms, vec_ms=vec_ms, diffs=diffs, out=o2)


def run(device, real=None, reps: int = 20, log=print) -> dict:
    """The experiment (tool main() :206-227): the synthetic tiles and the
    real pass-1 tiles (`real` = real_data's tuple, built if None)."""
    gx, gy, k = 38, 22, 1024
    data, counts = make_data(gx * gy, k, gx)
    syn = (torch.as_tensor(data, device=device),
           torch.as_tensor(counts, device=device), gx, gx * gy)
    res = {"synthetic": compare("synthetic", *syn, reps, log)}
    real = real if real is not None else real_data(device=device)
    log(f"real workload: entries={int(real[1].sum())} tiles={real[3]}")
    res["real"] = compare("real", *real, reps, log)
    res["inputs"] = {"synthetic": syn, "real": real}
    return res


def main(argv=None):
    device = parse_device(argv, "X3: the group-vectorized blend against K1")
    run(device, reps=50 if device.type == "cuda" else 1)


if __name__ == "__main__":
    main()
