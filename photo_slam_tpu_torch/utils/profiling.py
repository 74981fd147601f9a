"""Tracing, profiling and memory observability.

Counterpart of photo_slam_tpu/utils/profiling.py (reference:
src/gaussian_mapper.cpp:617,738-740,1582-1597;
examples/replica_rgbd.cpp:235-249 GpuPeakUsageMB): wall-clock span timers
with EMA summaries that wait for the card where asked, the caching
allocator's statistics under the JAX package's key names, and a
torch.profiler trace context for deep dives.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from dataclasses import dataclass
from pathlib import Path

import torch


@dataclass
class SpanStats:
    count: int = 0
    total_s: float = 0.0
    ema_s: float = 0.0
    max_s: float = 0.0

    def record(self, dt: float) -> None:
        self.count += 1
        self.total_s += dt
        self.max_s = max(self.max_s, dt)
        self.ema_s = dt if self.count == 1 else 0.1 * dt + 0.9 * self.ema_s


def _cuda_devices(sync) -> set:
    """The CUDA devices of a tensor, or of a tuple, list or NamedTuple of
    them (nested)."""
    if isinstance(sync, torch.Tensor):
        return {sync.device} if sync.device.type == "cuda" else set()
    if isinstance(sync, (tuple, list)):
        return set().union(*(_cuda_devices(x) for x in sync))
    return set()


class Profiler:
    """Named wall-clock spans (the reference's chrono blocks, structured),
    recorded from any thread."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.spans: dict[str, SpanStats] = defaultdict(SpanStats)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name: str, sync=None):
        """Time a block; pass `sync` (a tensor, or a tuple or NamedTuple of
        them) to wait for each CUDA device among them before the clock
        stops: torch::cuda::synchronize() around the reference's render
        timer (src/gaussian_mapper.cpp:1582-1597). CPU tensors need no
        wait."""
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        yield
        for device in _cuda_devices(sync):
            torch.cuda.synchronize(device)
        self.record(name, time.perf_counter() - t0)

    def record(self, name: str, seconds: float) -> None:
        """Add one measured duration to span `name`."""
        if self.enabled:
            with self._lock:
                self.spans[name].record(seconds)

    @contextlib.contextmanager
    def locked(self, name: str, lock):
        """Hold `lock` for the block; the wait to acquire it is span
        `name`."""
        t0 = time.perf_counter()
        with lock:
            self.record(name, time.perf_counter() - t0)
            yield

    def summary(self) -> dict[str, dict]:
        with self._lock:
            spans = dict(self.spans)
        return {
            name: {
                "count": s.count,
                "mean_ms": 1000.0 * s.total_s / max(s.count, 1),
                "ema_ms": 1000.0 * s.ema_s,
                "max_ms": 1000.0 * s.max_s,
            }
            for name, s in spans.items()
        }

    def report(self) -> str:
        lines = [f"{'span':30s} {'count':>8s} {'mean ms':>10s} {'max ms':>10s}"]
        with self._lock:
            spans = sorted(self.spans.items())
        for name, s in spans:
            lines.append(
                f"{name:30s} {s.count:8d} "
                f"{1000 * s.total_s / max(s.count, 1):10.2f} "
                f"{1000 * s.max_s:10.2f}")
        return "\n".join(lines)


def device_memory_stats(device) -> dict:
    """bytes_in_use, peak_bytes_in_use and bytes_limit of a CUDA device (and
    each in MB under its *_mb name), from torch.cuda.memory_stats; {} for
    the CPU, which has no allocator statistics."""
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    raw = torch.cuda.memory_stats(device)
    stats = {
        "bytes_in_use": raw.get("allocated_bytes.all.current", 0),
        "peak_bytes_in_use": raw.get("allocated_bytes.all.peak", 0),
        "bytes_limit": torch.cuda.get_device_properties(device).total_memory,
    }
    for key in list(stats):
        stats[key.replace("bytes", "mb")] = stats[key] / (1024 * 1024)
    return stats


@contextlib.contextmanager
def trace(log_dir):
    """torch.profiler trace (CPU and, where a card is present, CUDA
    activity) of the block, written into `log_dir` as a Chrome trace
    (trace.json) for chrome://tracing or Perfetto."""
    from torch.profiler import ProfilerActivity, profile

    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(out / "trace.json"))
