"""The entry transpose's time on the card, for comparing checkouts.

The room's pass-1 table (300,000 Gaussians, seed 0, SH 3, 1200x680,
k_dup 6, max_per_tile 1024: [836, 1024] entry ids, as chip_smoke.py bins
it) and seeded random gradient rows [836, 1024, 16] go through
ops/tiled.py::entry_gather_transpose, the function the train step's
backward calls, with one signature in every checkout since the training
slice. After a warm-up, `--blocks` blocks of `--calls` calls, each block
timed by CUDA events; then the device time per call from a torch.profiler
trace (the sum of its device ops' intervals) with the ops' names; and a
sha256 of the [300000, 16] result, so that two checkouts' sums can be held
bit for bit.

The script imports `photo_slam_tpu_torch` from the path, so it times the
checkout that PYTHONPATH names first, and times another checkout's package
when run by its file path:

    PYTHONPATH=<checkout> python3 photo_slam_tpu_torch/tools/time_transpose.py

Two checkouts are compared in one call, in turns (P C C P), the parent
unpacked by `git archive` into a gitignored directory. Prints one JSON
line: the package's path, the card's `nvidia-smi` name and power limit,
ms per call of each block, device ms and device ops per call, the ops'
names, the valid rows and the result's sha256.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess

import numpy as np
import torch

import photo_slam_tpu_torch
from photo_slam_tpu_torch.ops import tiled
from photo_slam_tpu_torch.tools import bench_room

N_GAUSSIANS = 300_000
K_DUP, MAX_PER_TILE = 6, 1024


def device_trace(fn, calls: int):
    """(device ms per call, device ops per call, names) of fn() from a
    torch.profiler trace of `calls` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not ops:
        raise RuntimeError("the trace holds no device op")
    us = sum(e.time_range.end - e.time_range.start for e in ops)
    return us / calls / 1e3, len(ops) / calls, sorted({e.name[:60]
                                                       for e in ops})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--blocks", type=int, default=5)
    ap.add_argument("--calls", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("time_transpose needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]

    view = bench_room.room_view(N_GAUSSIANS, device=dev)
    lists = bench_room.bin_view(view, 32, K_DUP, MAX_PER_TILE).tile_lists
    g = torch.randn(tuple(lists.shape) + (16,), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(5))
    del view

    def call():
        return tiled.entry_gather_transpose(g, lists, K_DUP, N_GAUSSIANS)

    out = call()
    torch.cuda.synchronize()
    blocks = []
    for _ in range(args.blocks):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.calls):
            call()
        end.record()
        torch.cuda.synchronize()
        blocks.append(start.elapsed_time(end) / args.calls)
    dev_ms, dev_ops, names = device_trace(call, args.calls)
    print(json.dumps({
        "package": photo_slam_tpu_torch.__file__, "device": smi,
        "table": list(lists.shape), "valid_rows": int((lists >= 0).sum()),
        "ms_per_call_blocks": blocks, "ms_median": float(np.median(blocks)),
        "device_ms_per_call": dev_ms, "device_ops_per_call": dev_ops,
        "device_ops": names,
        "out_sha256": hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest(),
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
