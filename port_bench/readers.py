"""What the per-layer metrics' readers (port_bench/metrics/<name>.py) share:
each reads the `layer` a traced run gives it ("trace": the DeviceTrace of
the window; "count": iterations or frames in it; "window_s"; "spans": the
program's Profiler summary; and the least times the cell's check priced)
and returns a number, or None where the cell gives it nothing to read."""
from __future__ import annotations


def kernel_roofline(layer: dict, kernel: str, least: str):
    """A kernel's share of its roofline, in %: its least time per
    iteration or frame, layer[least], over the device time per iteration
    or frame of the kernel function `kernel` in the trace."""
    trace, count = layer.get("trace"), layer.get("count", 0)
    if trace is None or not count or least not in layer:
        return None
    device_s = trace.kernel_seconds(kernel) / count
    return 100.0 * layer[least] / device_s if device_s > 0 else None


def step_mfu(layer: dict):
    """The whole step's share of the card's peak, in %: the least time of
    one iteration or frame over the window's seconds per iteration or
    frame."""
    count, window = layer.get("count", 0), layer.get("window_s", 0.0)
    if not count or window <= 0 or "least_s" not in layer:
        return None
    return 100.0 * layer["least_s"] / (window / count)


def device_idle(layer: dict):
    """The device's idle share of the traced window, in %: 1 - (the union
    of the device operations' intervals / the window)."""
    trace = layer.get("trace")
    if trace is None or trace.window_s <= 0 or not trace.ops:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def span_mean_ms(layer: dict, name: str):
    """The mean ms of the program's Profiler span `name`."""
    span = layer.get("spans", {}).get(name)
    return span["mean_ms"] if span and span["count"] else None
