"""The device trace of a window: torch.profiler (CUPTI) activity, reduced to
the numbers the per-layer metrics read.

Busy time is the union of the device operations' intervals, graph replays
included, as chip_smoke.py's profile phases reckon it (commit
b2b746adc8850e97c8bf961cd6f4acbaa347c7b1). The harness marks what the host
does with torch.profiler.record_function spans named "port_bench.*"; an
idle gap of the device is put down to the innermost such span, or other
host operation, that covers its middle.
"""
from __future__ import annotations

import bisect
import contextlib
from dataclasses import dataclass, field


@dataclass
class DeviceTrace:
    window_s: float = 0.0                 # host clock of the traced window
    busy_s: float = 0.0                   # union of device-op intervals
    ops: int = 0
    by_name: dict = field(default_factory=dict)    # kernel -> seconds
    gaps: dict = field(default_factory=dict)       # host activity -> s

    def kernel_seconds(self, kernel: str) -> float:
        """Device seconds of the operations of the kernel function
        `kernel` (its name as the trace shows it: namespace qualified,
        with its parameter list)."""
        return sum(s for name, s in self.by_name.items()
                   if name.startswith(kernel + "(")
                   or ("::" + kernel + "(") in name)

    def breakdown(self) -> dict:
        top = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:120], s] for n, s in top],
                "idle_gaps": [[n[:120], s] for n, s in gaps]}


def warm_profiler(torch) -> None:
    """One short profiler session, so that CUPTI is set up before the
    program captures its graphs (TEARDOWN_CUPTI=0 keeps it so)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()


@contextlib.contextmanager
def traced(torch, out: DeviceTrace):
    """Profile the block (CPU and CUDA activity) and reduce it into
    `out`. The block must end in a synchronize."""
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        yield
        out.window_s = time.perf_counter() - t0
    device, host = [], []
    for e in prof.events():
        tr = (e.time_range.start, e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            device.append((*tr, e.name))
        else:
            host.append((*tr, e.name))
    reduce_events(device, host, out)


def reduce_events(device: list, host: list, out: DeviceTrace) -> None:
    """Fill `out` from device and host events, each (start us, end us,
    name): busy time, seconds by kernel name and idle gaps by host
    activity. A device event named as
    a host event is the mirror of a host annotation on the device's
    timeline (record_function), not an operation, and is left out."""
    annotations = {name for _, _, name in host}
    device = sorted(d for d in device if d[2] not in annotations)
    busy, end = 0.0, float("-inf")
    gaps = []
    for t0, t1, name in device:
        if t0 > end and end > float("-inf"):
            gaps.append((end, t0))
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
        out.by_name[name] = out.by_name.get(name, 0.0) + (t1 - t0) * 1e-6
    out.busy_s = busy * 1e-6
    out.ops = len(device)
    # The innermost host event covering each gap's middle names it.
    host = sorted(host)
    starts = [h[0] for h in host]
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        best = None
        for t0, t1, name in host[:bisect.bisect_right(starts, mid)][-256:]:
            if t0 <= mid <= t1 and (best is None or t1 - t0 < best[0]):
                best = (t1 - t0, name)
        key = best[1] if best else "no host activity"
        out.gaps[key] = out.gaps.get(key, 0.0) + (g1 - g0) * 1e-6
