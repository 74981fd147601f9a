"""Run one cell of the benchmark once and print its result as the last line.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell is an entry of `workloads` in BENCHMARK.json, at the root of the
checkout; it names a configuration (port_bench/configs/<config>.json) and a
traffic mix (port_bench/traffic/<traffic>.json, whose "kind" names the
loop port_bench/kinds/<kind>.py), and the numbers that decide `correct`
are held to port_bench/limits/<cell>.json. A per-layer metric is the
reader port_bench/metrics/<name>.py (a function `read(layer)` that
returns a number, or None where its cell gives it nothing to read).

The run sets up the program (photo_slam_tpu_torch) from the seed in the
precision the configuration states, measures
for --seconds (a traced run: the first TRACE_SECONDS of it, under
torch.profiler), then frees the program and checks what the window
produced against the plain reference (port_bench/reference). It exits
with 1 and prints no result where there is no card, where the cell asks
for more cards than there are, or where a module of JAX or of the JAX
package has been loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from port_bench import byname  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# The window of a traced run: long enough to hold hundreds of iterations or
# frames, short enough that reading the trace stays within a minute.
TRACE_SECONDS = 2.0
# Top-level module names no run may load.
FORBIDDEN = ("jax", "jaxlib", "flax", "photo_slam_tpu")


def caches(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout;
    CUPTI kept set up between profiler sessions; transformers kept from
    loading JAX."""
    build = root / "build" / "port_bench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ.setdefault("TEARDOWN_CUPTI", "0")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole."""
    return sorted(name for name in list(sys.modules)
                  if name.split(".")[0] in FORBIDDEN)


def load_cell(root: Path, workload: str) -> dict:
    """The cell's manifest entries, data files and kind: {"cell",
    "config", "traffic", "kind", "limits", "end_to_end", "per_layer"}."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"port_bench: no workload {workload!r} in "
                         f"BENCHMARK.json ({', '.join(cells)})")
    cell = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    bench = root / "port_bench"
    e2e = [m for m in manifest["end_to_end"]
           if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if (workload in m["workloads"] if "workloads" in m
                 else m["moves"] in reported)]
    traffic = json.loads((bench / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    return {
        "cell": cell,
        "config": json.loads((root / configs[cell["config"]]["file"])
                             .read_text()),
        "traffic": traffic,
        "kind": byname.module(root, "kinds", traffic["kind"]),
        "limits": json.loads((bench / "limits" / f"{workload}.json")
                             .read_text()),
        "end_to_end": e2e,
        "per_layer": layer,
    }


def read_metric(root: Path, name: str, layer: dict):
    """The per-layer metric `name` from its reader, or None."""
    return byname.module(root, "metrics", name).read(layer)


def device_info(device) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": torch.cuda.max_memory_allocated(device)}


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device, t_start: float = T_START) -> dict:
    """Run the cell once on `device`; returns the result (the printed
    line's object) with the compared numbers under "checks"."""
    import torch

    from port_bench import cells

    spec = load_cell(root, workload)
    cells.set_precision(spec["config"])
    device = torch.device(device)
    if trace and device.type == "cuda":
        from port_bench.trace import warm_profiler
        warm_profiler(torch)
    cell = spec["kind"].Cell(root, spec["config"], spec["traffic"], seed,
                             device)
    cell.setup()
    # The reference's seconds making the inputs are not the program's.
    setup_s = time.perf_counter() - t_start - cell.reference_s
    cell.window(min(seconds, TRACE_SECONDS) if trace else seconds, trace)
    t_window = time.perf_counter()
    dev_info = device_info(device)
    cell.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    cell.check(trace)
    print(f"port_bench: {workload} seed {seed}: set-up {setup_s:.3f} s "
          f"(the reference's inputs {cell.reference_s:.3f} s apart), "
          f"window {cell.layer['window_s']:.3f} s ({cell.attempted}), "
          f"check {time.perf_counter() - t_window:.3f} s", file=sys.stderr)

    limits = spec["limits"]
    checks = {k: {"value": v, "limit": limits[k]}
              for k, v in cell.numbers.items() if k in limits}
    correct = (cell.attempted > 0 and cell.failed == 0 and all(
        c["value"] <= c["limit"] for c in checks.values()))
    metrics = {}
    if trace:
        layer = dict(cell.layer, trace=cell.trace)
        for m in spec["per_layer"]:
            value = read_metric(root, m["name"], layer)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if device.type == "cuda":
            dev_info.update(busy_s=cell.trace.busy_s,
                            window_s=cell.trace.window_s)
    else:
        values = dict(cell.e2e, setup_s=setup_s)
        for m in spec["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    result = {"correct": correct, "attempted": cell.attempted,
              "failed": cell.failed, "metrics": metrics, "device": dev_info}
    if trace and device.type == "cuda":
        result["breakdown"] = cell.trace.breakdown()
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    caches(ROOT)
    import torch

    chips = load_cell(ROOT, args.workload)["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: the cell needs {chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    found = forbidden_modules()
    if found:
        print(f"port_bench: loaded before the run: {found}", file=sys.stderr)
        return 1
    result = run_cell(ROOT, args.workload, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"port_bench: the run loaded {found}", file=sys.stderr)
        return 1
    for name, c in result["checks"].items():
        print(f"port_bench check {name}: {c['value']!r} (limit "
              f"{c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
