"""X1: the blend forward with its pixel-side chain in bf16.

Counterpart of tools/exp_blend_bf16.py. The blend kernels are bound by
their arithmetic, so the experiment runs K1's per-pixel chain (dx, dy,
power, exp, alpha) in bf16 while the transmittance and colour stay f32.
Pixel coordinates are tile-local (0..31, exact in bf16; at x ~ 1200 a bf16
coordinate would be 8 px coarse), and each entry's mean is made tile-local
in f32 before it is rounded. `call_bf16` is the kernel
(csrc/blend_bf16_fwd.cu, two pixels per bf16x2 instruction) and
`call_bf16_plain` its plain version.

main() runs K1 and X1 on the production pass-1 tiles of the 300k-Gaussian
room at 1200x680 (32 px, k_dup 6, K 1024) and prints their times, the
colour PSNR of bf16 against f32, the largest T difference and the largest
n_contrib difference.

    python -m photo_slam_tpu_torch.tools.exp_blend_bf16 [--device cpu]
"""
from __future__ import annotations

import torch

from photo_slam_tpu_torch.ops.blend import (ALPHA_MAX, ALPHA_MIN, PIX_LANE,
                                            PIX_SUB, T_EPS, TILE_PS, blend_fwd)
from photo_slam_tpu_torch.tools.bench_room import (parse_device, psnr_max_diff,
                                                   room_view, tiles32, time_ms)
from photo_slam_tpu_torch.tools.exp_blend_vec import launch_tile_blend

BF16 = torch.bfloat16


def _bf16(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=BF16)


ALPHA_MAX_BF16 = float(_bf16(ALPHA_MAX))   # 0.98828125
ALPHA_MIN_BF16 = float(_bf16(ALPHA_MIN))   # 0.003936767578125


def power_alpha_bf16(row: torch.Tensor, ox: torch.Tensor, oy: torch.Tensor,
                     lx: torch.Tensor, ly: torch.Tensor):
    """X1's pixel-side chain for entry rows [T, 16] of tiles at origins
    ox, oy [T, 1] (f32) and tile-local pixels lx, ly [1, P] (bf16): (power,
    alpha) in bf16, each operation rounded to bf16 (tool :51-59), exp the
    float exp of the bf16 power rounded to bf16."""
    mx = (row[:, 0:1] - ox).to(BF16)
    my = (row[:, 1:2] - oy).to(BF16)
    a, b, c, o = (row[:, i:i + 1].to(BF16) for i in (2, 3, 4, 5))
    dx = mx - lx
    dy = my - ly
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    e = torch.exp(power.float()).to(BF16)
    alpha = torch.clamp_max(o * e, ALPHA_MAX_BF16)
    return power, alpha


def tile_frame(num_tiles: int, tiles_x: int, device):
    """(ox, oy [T, 1] f32 tile origins, lx, ly [1, 1024] bf16 tile-local
    pixel coordinates) for identity tile ids."""
    ids = torch.arange(num_tiles, device=device)
    pix = torch.arange(TILE_PS * TILE_PS, device=device)
    return (((ids % tiles_x) * TILE_PS).to(torch.float32)[:, None],
            ((ids // tiles_x) * TILE_PS).to(torch.float32)[:, None],
            (pix % TILE_PS).to(BF16)[None, :],
            (pix // TILE_PS).to(BF16)[None, :])


def call_bf16_plain(data_tiles: torch.Tensor, counts: torch.Tensor,
                    tiles_x: int, num_tiles: int):
    """Plain PyTorch version of the bf16 blend: K1's sequential loop
    (ops/blend.py::blend_fwd_plain) with power and alpha from
    power_alpha_bf16 and the rest in f32 (tool :60-73). Returns (color
    [T, 3, 8, 128], final_T [T, 8, 128], n_contrib [T, 8, 128] int32)."""
    dev = data_tiles.device
    nb, k_max, _ = data_tiles.shape
    p = TILE_PS * TILE_PS
    ox, oy, lx, ly = tile_frame(num_tiles, tiles_x, dev)
    color = torch.zeros((nb, 3, p), dtype=torch.float32, device=dev)
    trans = torch.ones((nb, p), dtype=torch.float32, device=dev)
    n_contrib = torch.zeros((nb, p), dtype=torch.int32, device=dev)
    done = torch.zeros((nb, p), dtype=torch.bool, device=dev)
    n_iter = min(k_max, int(counts.max())) if nb else 0
    for k in range(n_iter):
        row = data_tiles[:, k, :]
        live = (k < counts)[:, None] & ~done
        power, alpha16 = power_alpha_bf16(row, ox, oy, lx, ly)
        contrib = live & (power <= 0) & (alpha16 >= ALPHA_MIN_BF16)
        alpha = alpha16.float()
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


def call_bf16(data_tiles: torch.Tensor, counts: torch.Tensor, tiles_x: int,
              num_tiles: int):
    """The bf16 blend (the TPU's call_bf16): data_tiles [T, K, 16] float32,
    counts [T] int32, identity tile ids. Returns (color [T, 3, 8, 128],
    final_T [T, 8, 128], n_contrib [T, 8, 128]).

    On a CUDA tensor it launches csrc/blend_bf16_fwd.cu (or raises); on a
    CPU tensor it runs call_bf16_plain. `call_bf16.launches` counts kernel
    launches."""
    if data_tiles.device.type == "cpu":
        return call_bf16_plain(data_tiles, counts, tiles_x, num_tiles)
    return launch_tile_blend("blend_bf16_fwd", call_bf16, data_tiles, counts,
                             tiles_x, num_tiles)


call_bf16.launches = 0


def run(device, tiles=None, reps: int = 20, log=print) -> dict:
    """The experiment (tool main() :136-182) on the pass-1 tiles (`tiles`
    = a bench_room.Tiles32, built from the room if None)."""
    t = tiles if tiles is not None else tiles32(room_view(device=device))
    args = (t.data, t.counts, t.tiles_x, t.num_tiles)
    log(f"entries={int(t.counts.sum())}")
    o32 = blend_fwd(*args)
    obf = call_bf16(*args)
    f32_ms = time_ms(lambda: blend_fwd(*args), reps, device)
    bf16_ms = time_ms(lambda: call_bf16(*args), reps, device)
    psnr, _ = psnr_max_diff(o32[0], obf[0])
    t_diff = float((o32[1] - obf[1]).abs().max())
    nc_diff = int((o32[2] - obf[2]).abs().max())
    log(f"f32 K1 {f32_ms:.4f} ms, bf16 X1 {bf16_ms:.4f} ms; colour PSNR "
        f"bf16-vs-f32: {psnr:.2f} dB  maxT diff {t_diff:.2e}  nc diff "
        f"{nc_diff}")
    return dict(args=args, out=obf, out32=o32, f32_ms=f32_ms,
                bf16_ms=bf16_ms, psnr=psnr, t_diff=t_diff, nc_diff=nc_diff)


def main(argv=None):
    device = parse_device(argv, "X1: the bf16 blend against K1")
    run(device, reps=50 if device.type == "cuda" else 1)


if __name__ == "__main__":
    main()
