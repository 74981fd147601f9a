"""The least time of the blend kernels, an iteration and a frame on the card.

A frozen copy of chip_smoke.py's arithmetic at commit
b2b746adc8850e97c8bf961cd6f4acbaa347c7b1 (its PEAK_*, K1_OPS_*, K2_OPS_*,
BOX_OPS_* constants, `bound`, `blend_bound` and `blend_pair_counts`), with
the pairs counted from the reference's own binning, never from the
program's counters, so that the work is the same whatever implements it.
"""
from __future__ import annotations

import torch

from port_bench.reference import render as ref

# The card's published peaks (NVIDIA H100 SXM data sheet): float32 and
# float64 outside the tensor cores, and HBM bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_F64_FLOPS = 34e12
PEAK_BYTES = 3.35e12
# The least work of a blend function, counted from the kernel sources (an
# exp counts as one, a compare as none): the entry-pixel pairs at which it
# changes its state (power <= 0 and alpha >= 1/255), dx, dy 2, power 9,
# exp 1 and alpha 1 each. K1 then adds test T 2, where a pixel's stopping
# entry ends, and weight 1 and colour 6 for an applied entry. K2 adds, for
# a contributing entry, om 1, T 1, aT 1, g.c 5, dL/dalpha 4, Bc 2, dL/do
# and dL/dpower 2 and the nine sums 20. The pairs that fail are not priced:
# one box per entry row (20 double and 6 float operations) stands for
# finding them, and its row is read once.
K1_OPS_STOP = 15
K1_OPS_APPLIED = 22
K2_OPS_VALID = 49
BOX_OPS_F64 = 20
BOX_OPS_F32 = 6
# The map's floats per Gaussian at SH 3: xyz 3, features 48, opacity 1,
# scales 3, quats 4.
PARAM_FLOATS = 59


def bound(flops: float, nbytes: float) -> float:
    """Seconds: the larger of the operations over the f32 peak and the
    bytes over the memory rate."""
    return max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES)


def blend_bound(ops: float, rows: int, num_tiles: int,
                nbytes: float) -> float:
    """Seconds of a blend kernel: `ops` f32 operations of the pairs it
    needs, one box per entry row below the counts (`rows`, in f64 at its
    peak), each such row (64 B) and the counts read once, and `nbytes` of
    its other inputs and its outputs."""
    t_ops = ((ops + BOX_OPS_F32 * rows) / PEAK_F32_FLOPS
             + BOX_OPS_F64 * rows / PEAK_F64_FLOPS)
    t_bytes = (rows * 64 + num_tiles * 4 + nbytes) / PEAK_BYTES
    return max(t_ops, t_bytes)


def blend_pair_counts(data: torch.Tensor, counts: torch.Tensor,
                      n_contrib: torch.Tensor, tiles_x: int) -> dict:
    """Entry-pixel pairs that the forward kernel (each pixel's entries
    k < counts up to the one at which it stops) and the backward kernel
    (the entries k < n_contrib) evaluate, by kind."""
    dev = data.device
    nb, k_max, _ = data.shape
    px, py = ref.tile_pixels(nb, tiles_x, dev)
    nc = n_contrib.reshape(nb, -1)
    trans = torch.ones(nc.shape, device=dev)
    done = torch.zeros(nc.shape, dtype=torch.bool, device=dev)
    tally = torch.zeros(3, dtype=torch.int64, device=dev)
    with torch.no_grad():
        for k in range(min(k_max, int(counts.max())) if nb else 0):
            in_k1 = (k < counts)[:, None] & ~done
            alpha, contrib = ref.pair_terms(data[:, k], px, py)[5:]
            test_t = trans * (1.0 - alpha)
            stop = in_k1 & contrib & (test_t < ref.T_EPS)
            applied = in_k1 & contrib & ~stop
            tally += torch.stack([stop.sum(), applied.sum(),
                                  ((k < nc) & contrib).sum()])
            trans = torch.where(applied, test_t, trans)
            done |= stop
    stop, applied, valid = (int(x) for x in tally.cpu())
    return {"k1_stop": stop, "k1_applied": applied, "k2_valid": valid}


def frame_work(frame: ref.Frame) -> dict:
    """The least seconds of one render's parts from the reference's Frame:
    K1, K2 (the backward over the same tiles), the preprocess (each
    Gaussian's parameters read once), the binning sort (each key and its
    payload read and written once) and the image (written once)."""
    pairs = blend_pair_counts(frame.data, frame.counts, frame.n_contrib,
                              frame.tiles_x)
    nb = frame.data.shape[0]
    pixels = nb * ref.TILE * ref.TILE
    # counts_eff bounds the backward's rows.
    eff = torch.minimum(frame.counts, frame.n_contrib.amax(dim=-1))
    rows, rows_bwd = int(frame.counts.sum()), int(eff.sum())
    n = frame.visible.shape[0]
    return {
        # K1 writes colour, final T and n_contrib: 5 floats a pixel.
        "k1": blend_bound(K1_OPS_STOP * pairs["k1_stop"]
                          + K1_OPS_APPLIED * pairs["k1_applied"], rows, nb,
                          pixels * 5 * 4),
        # K2 reads final T, n_contrib and the three colour and one T
        # cotangents, and writes a gradient row per entry row.
        "k2": blend_bound(K2_OPS_VALID * pairs["k2_valid"], rows_bwd, nb,
                          pixels * 6 * 4 + rows_bwd * 64),
        "preprocess": n * PARAM_FLOATS * 4 / PEAK_BYTES,
        "sort": frame.keys * 2 * 2 * 4 / PEAK_BYTES,
        "image": 3 * pixels * 4 / PEAK_BYTES,
        "pairs": pairs,
    }


def iteration_seconds(work: dict, gaussians: int, pixels: int) -> float:
    """The least time of a training iteration: the frame's render parts,
    K2, Adam over every live Gaussian's PARAM_FLOATS (the parameter, its
    gradient and two moments read, the parameter and two moments written)
    and the loss's images (the render, the ground truth and the mask, read
    once)."""
    adam = gaussians * PARAM_FLOATS * 4 * 7 / PEAK_BYTES
    loss = 7 * pixels * 4 / PEAK_BYTES
    return frame_seconds(work) + work["k2"] + adam + loss


def frame_seconds(work: dict) -> float:
    """The least time of a view frame: K1, the preprocess, the sort and
    the image."""
    return work["k1"] + work["preprocess"] + work["sort"] + work["image"]
