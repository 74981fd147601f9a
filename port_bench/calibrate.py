"""The readings the limits of port_bench/limits/<cell>.json are set from,
many seeds in one process (set-up is most of a run):

    python3 -m port_bench.calibrate --workload <cell> --seeds 1,2,3 \\
        [--seconds 2] [--control 3]

For each seed it runs the cell as port_bench.run does (set-up, a window of
--seconds, the check) and prints the compared numbers: the program's
readings, whose largest is a limit's lower reading. For the first
--control seeds it then puts each of the kind's CONTROLS in the program's
place (the reference computed in TF32, the nearest precision below the
float32 the configurations state; for a training cell also the reference
with half of the image's rows left out of the loss) and prints their
numbers: the smallest that fails is the upper reading. One JSON line per
reading.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from port_bench import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", type=int, default=0)
    args = ap.parse_args(argv)
    run.caches(run.ROOT)
    import torch

    from port_bench import cells

    if not torch.cuda.is_available():
        print("port_bench.calibrate: no CUDA device", file=sys.stderr)
        return 1
    spec = run.load_cell(run.ROOT, args.workload)
    cells.set_precision(spec["config"])
    kind = spec["kind"]
    dev = torch.device("cuda", 0)
    for j, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        cell = kind.Cell(run.ROOT, spec["config"], spec["traffic"], seed,
                         dev)
        cell.setup()
        t1 = time.perf_counter()
        cell.window(args.seconds, False)
        peak = torch.cuda.max_memory_allocated(dev)
        cell.release()
        torch.cuda.empty_cache()
        t2 = time.perf_counter()
        cell.check(False)
        t3 = time.perf_counter()
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "side": "program", "numbers": cell.numbers,
                          "e2e": cell.e2e, "attempted": cell.attempted,
                          "setup_s": t1 - t0 - cell.reference_s,
                          "check_s": t3 - t2, "peak_bytes": peak}),
              flush=True)
        for side in kind.CONTROLS if j < args.control else ():
            t4 = time.perf_counter()
            numbers = cell.control(side)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "side": side, "numbers": numbers,
                              "seconds": time.perf_counter() - t4}),
                  flush=True)
        del cell
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
