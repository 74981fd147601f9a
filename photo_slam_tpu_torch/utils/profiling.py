"""Tracing, profiling and memory observability.

Counterpart of photo_slam_tpu/utils/profiling.py (reference:
src/gaussian_mapper.cpp:617,738-740,1582-1597;
examples/replica_rgbd.cpp:235-249 GpuPeakUsageMB): wall-clock span timers
with EMA summaries that wait for the card where asked, named counters, the
caching allocator's statistics under the JAX package's key names, and a
torch.profiler trace context for deep dives.

While a torch.profiler session records, every span of every Profiler,
enabled or not, is also a record_function range of its name on the trace's
timeline, so the program's stages share the device trace's clock; the
span's identifier (an iteration, a frame) is the range's argument. Each
such span (name, start and end, parent span, identifier, thread) and each
counter increment is also kept in one bounded, process-wide record, which
`traced()` returns and `trace()` writes as spans.json. With no session
recording a disabled Profiler's span costs two flag checks and opens no
range (a record_function costs microseconds even with no profiler).
"""
from __future__ import annotations

import contextlib
import itertools
import json
import statistics
import threading
import time
from collections import defaultdict, deque
from dataclasses import dataclass
from pathlib import Path

import torch
import torch.autograd.profiler as _autograd_profiler

# The traced record keeps the last SPAN_RECORDS spans.
SPAN_RECORDS = 200_000

_span_ids = itertools.count(1)
# Per thread: (id, identifier) of each traced span open on it, innermost
# last.
_open = threading.local()
_record_lock = threading.Lock()
# (id, name, start ns, end ns, parent id or 0, identifier, thread).
_records: deque = deque(maxlen=SPAN_RECORDS)
_counts: dict = defaultdict(int)


def recording() -> bool:
    """Whether a torch.profiler session records (a module flag that
    torch.profiler sets; ~0.06 us to read)."""
    return _autograd_profiler._is_profiler_enabled


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
    """Named wall-clock spans (the reference's chrono blocks, structured)
    and counters, recorded from any thread."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.spans: dict[str, SpanStats] = defaultdict(SpanStats)
        self.counters: dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()

    def span(self, name: str, sync=None, ident=None):
        """Time a block; pass `sync` (a tensor, or a tuple or NamedTuple of
        them) to wait for each CUDA device among them before the clock
        stops: torch::cuda::synchronize() around the reference's render
        timer (src/gaussian_mapper.cpp:1582-1597). CPU tensors need no
        wait. `ident` (an int: the iteration, the frame) names the
        iteration or request the span belongs to; a span given none takes
        its enclosing span's."""
        if self.enabled or recording():
            return _Span(self, name, sync, ident)
        return _NOTHING

    def _stop(self, name: str, sync, t0: float) -> None:
        if sync is not None:
            for device in _cuda_devices(sync):
                torch.cuda.synchronize(device)
        self.record(name, time.perf_counter() - t0)

    def record(self, name: str, seconds: float) -> None:
        """Add one measured duration to span `name`."""
        if self.enabled:
            with self._lock:
                self.spans[name].record(seconds)

    def count(self, name: str, n: int = 1) -> None:
        """Add `n` to counter `name` (and to the traced record's, while a
        torch.profiler session records)."""
        if self.enabled:
            with self._lock:
                self.counters[name] += n
        if recording():
            with _record_lock:
                _counts[name] += n

    @contextlib.contextmanager
    def locked(self, name: str, lock):
        """Hold `lock` for the block; the wait to acquire it is span
        `name`."""
        with self.span(name):
            lock.acquire()
        try:
            yield
        finally:
            lock.release()

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


# The spans and counts of code that keeps no Profiler of its own (the graph
# cache, a render_from_pose call given none): they reach only a trace.
DISABLED = Profiler(enabled=False)


class _Span:
    """The block of Profiler.span: timed where the profiler is enabled, a
    traced span while a torch.profiler session records."""

    __slots__ = ("prof", "name", "sync", "ident", "t0", "traced")

    def __init__(self, prof: Profiler, name: str, sync, ident):
        self.prof, self.name, self.sync, self.ident = prof, name, sync, ident

    def __enter__(self):
        self.traced = (_enter_traced(self.name, self.ident) if recording()
                       else None)
        self.t0 = time.perf_counter()

    def __exit__(self, kind, value, tb):
        if kind is None and self.prof.enabled:
            self.prof._stop(self.name, self.sync, self.t0)
        if self.traced is not None:
            _exit_traced(self.traced)


_NOTHING = contextlib.nullcontext()


def _enter_traced(name: str, ident) -> tuple:
    """Open span `name` as a record_function range (argument: the
    identifier, else the enclosing traced span's) on the calling thread."""
    stack = getattr(_open, "stack", None)
    if stack is None:
        stack = _open.stack = []
    parent, inherited = stack[-1] if stack else (0, None)
    if ident is None:
        ident = inherited
    sid = next(_span_ids)
    stack.append((sid, ident))
    handle = torch.autograd._record_function_with_args_enter(
        name, *(() if ident is None else (int(ident),)))
    return sid, name, parent, ident, handle, time.perf_counter_ns()


def _exit_traced(opened: tuple) -> None:
    """Close a span _enter_traced opened; keep it in the traced record."""
    t1 = time.perf_counter_ns()
    sid, name, parent, ident, handle, t0 = opened
    torch.autograd._record_function_with_args_exit(handle)
    _open.stack.pop()
    _records.append((sid, name, t0, t1, parent, ident,
                     threading.get_native_id()))


def clear_traced() -> None:
    """Empty the traced record."""
    with _record_lock:
        _records.clear()
        _counts.clear()


def _p95(values: list) -> float:
    """The 95th percentile (statistics.quantiles, the exclusive method)."""
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=20)[-1]


def traced(records: bool = False) -> dict:
    """The traced record: {"spans": {name: {"count", "total_ms",
    "mean_ms", "p95_ms", "max_ms", "self_ms"}}, "counters": {name:
    total}}, where self_ms is the mean of each span's duration less the
    time its child spans cover; with `records`, also "records": every span
    kept, in the order they ended, as {"id", "name", "start_ns",
    "end_ns", "parent", "ident", "thread"} (time.perf_counter_ns's clock;
    parent 0: none)."""
    with _record_lock:
        kept = list(_records)
        counters = dict(_counts)
    covered: dict = defaultdict(int)
    for _, _, t0, t1, parent, _, _ in kept:
        if parent:
            covered[parent] += t1 - t0
    by_name: dict = defaultdict(list)
    for sid, name, t0, t1, _, _, _ in kept:
        by_name[name].append((t1 - t0, t1 - t0 - covered.get(sid, 0)))
    spans = {}
    for name, pairs in by_name.items():
        ms = [1e-6 * d for d, _ in pairs]
        spans[name] = {
            "count": len(ms),
            "total_ms": sum(ms),
            "mean_ms": statistics.fmean(ms),
            "p95_ms": _p95(ms),
            "max_ms": max(ms),
            "self_ms": 1e-6 * statistics.fmean(s for _, s in pairs),
        }
    out = {"spans": spans, "counters": counters}
    if records:
        keys = ("id", "name", "start_ns", "end_ns", "parent", "ident",
                "thread")
        out["records"] = [dict(zip(keys, r)) for r in kept]
    return out


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
    activity, with the operators' input shapes, which carry the spans'
    identifiers) of the block, written into `log_dir` as a Chrome trace
    (trace.json) for chrome://tracing or Perfetto, and the traced record
    of the block's spans and counters (`traced(records=True)`) as
    spans.json."""
    from torch.profiler import ProfilerActivity, profile

    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    clear_traced()
    with profile(activities=activities, record_shapes=True) as prof:
        yield
    prof.export_chrome_trace(str(out / "trace.json"))
    (out / "spans.json").write_text(json.dumps(traced(records=True)))
