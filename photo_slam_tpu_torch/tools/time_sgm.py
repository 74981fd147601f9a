"""Time the sgm kernel against another source of it, on EuRoC's cost
volume, in turns.

tools/synth_euroc.py's first stereo pair (752x480, the cylinder room with
its photograph, the sensor model on) gives the int16 cost volume [480, 624,
128] (ops/stereo.py::cost_volume), the shape of the EuRoC path. The
checkout's kernel runs through ops/stereo.py::sgm_aggregate (int16 sum).
`--baseline FILE` builds another source whose launcher `sgm_launch(cost,
h, w1, sum, stream)` adds into an int32 sum that its caller zeroes, as the
first design did (take it from git into build/, e.g. `git show
<commit>:photo_slam_tpu_torch/csrc/sgm.cu > build/sgm_earlier.cu`); it is
timed with its zeroing, as its wrapper ran it. Each build is first held bit
for bit against sgm_aggregate_plain, then the builds are timed `--rounds`
times in turns (checkout, baseline, baseline, checkout, ...), each time the
mean of `--reps` calls from CUDA events.

    python -m photo_slam_tpu_torch.tools.time_sgm \\
        --baseline build/sgm_earlier.cu

A knockout edits the checkout's source by text (each edit must match
exactly once; tools/variants.py) and is timed beside it:

  ring-4          4 steps of loads in flight per warp instead of 16.
  rows-only       pass 1 alone (timed, not checked: its sum is partial).

    python -m photo_slam_tpu_torch.tools.time_sgm --knockout rows-only

Prints each build's registers, shared memory and spills, then one JSON
line: the card's `nvidia-smi` name and power limit, the volume's shape and
ms per round for each build.
"""
from __future__ import annotations

import argparse
import functools
import json
import subprocess
from pathlib import Path

import torch

from photo_slam_tpu_torch import kernels
from photo_slam_tpu_torch.ops import stereo
from photo_slam_tpu_torch.tools import bench_room, variants
from photo_slam_tpu_torch.tools.synth_euroc import SynthEuroc


KNOCKOUTS = {
    "ring-4": (("constexpr int kRing = 16;", "constexpr int kRing = 4;"),),
    "rows-only": (("  // Passes 2-4.\n",
                   "  return (int)cudaGetLastError();\n"),),
}
PARTIAL = {"rows-only"}


def run(fn, cost, dtype):
    """One call of a built launcher: an int32 sum is zeroed first (the
    first design adds into it), an int16 one is written whole."""
    h, w1, _ = cost.shape
    alloc = torch.zeros if dtype == torch.int32 else torch.empty
    total = alloc(cost.shape, dtype=dtype, device=cost.device)
    kernels.check_launch("sgm variant", fn(
        cost.data_ptr(), h, w1, total.data_ptr(),
        torch.cuda.current_stream(cost.device).cuda_stream))
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path,
                    help="another sgm source (int32 sum zeroed by the "
                    "caller)")
    ap.add_argument("--knockout", action="append", default=[],
                    choices=sorted(KNOCKOUTS))
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("time_sgm needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    tag = "[time_sgm]"

    seq = SynthEuroc(1, device=dev)
    left, right = (torch.from_numpy(a).to(dev)
                   for a in (seq.left[0], seq.right[0]))
    cost = stereo.cost_volume(left, right).contiguous()
    h, w1, _ = cost.shape
    want = stereo.sgm_aggregate_plain(cost)
    calls = {"checkout": lambda: stereo.sgm_aggregate(cost)}
    calls["checkout"]()
    log = kernels.library_path("sgm").with_suffix(".log")
    for ln in variants.ptxas_lines(log.read_text() if log.exists() else ""):
        print(f"{tag} checkout: {ln}", flush=True)
    source = (kernels.CSRC_DIR / "sgm.cu").read_text()
    others = {name: variants.knockout_source(source, KNOCKOUTS[name], name)
              for name in args.knockout}
    if args.baseline is not None:
        others["baseline"] = args.baseline.read_text()
    for name, (fn, lines) in variants.build("sgm", others).items():
        for ln in lines:
            print(f"{tag} {name}: {ln}", flush=True)
        calls[name] = functools.partial(
            run, fn, cost, torch.int32 if name == "baseline" else torch.int16)
    for name, call in calls.items():
        got = call()
        torch.cuda.synchronize()
        if name in PARTIAL:
            print(f"{tag} {name}: timed only", flush=True)
            continue
        err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
        if err != 0:
            raise AssertionError(f"{name} disagrees with the plain version: "
                                 f"max abs err {err}")
        print(f"{tag} {name}: {got.dtype} sum bit-equal to the plain "
              f"version", flush=True)
    ms = {name: [] for name in calls}
    names = list(calls)
    for r in range(args.rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            ms[name].append(bench_room.time_ms(calls[name], args.reps, dev))
    print(json.dumps({"card": smi, "shape": [h, w1, stereo.NUM_DISP],
                      "reps": args.reps, "ms": ms,
                      "mean_ms": {n: sum(v) / len(v) for n, v in ms.items()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
