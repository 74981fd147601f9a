"""The port's profiler against the JAX package's: the four scenarios of
tests/test_profiling.py on the port, SpanStats and report() equal to
JAX's for the same durations, the lock-wait span, and trace() writing a
Chrome trace."""
import json
import threading
import time

import torch

from photo_slam_tpu.utils import profiling as jprof
from photo_slam_tpu_torch.utils import profiling as tprof
from photo_slam_tpu_torch.utils.profiling import Profiler, device_memory_stats

DTS = (0.013, 0.002, 0.25, 0.0, 0.0071, 0.04, 0.3333)


class TestProfiler:
    """tests/test_profiling.py::TestProfiler on the port."""

    def test_spans(self):
        p = Profiler()
        for _ in range(3):
            with p.span("work"):
                time.sleep(0.01)
        s = p.summary()["work"]
        assert s["count"] == 3
        assert 5.0 < s["mean_ms"] < 100.0
        assert "work" in p.report()

    def test_sync_span(self):
        p = Profiler()
        x = torch.ones((256, 256))
        with p.span("matmul", sync=x):
            y = x @ x
        assert p.summary()["matmul"]["count"] == 1
        with p.span("tuple", sync=(x, (y, x))):
            pass
        assert p.summary()["tuple"]["count"] == 1

    def test_disabled(self):
        p = Profiler(enabled=False)
        with p.span("nothing"):
            pass
        p.record("nothing", 1.0)
        assert p.summary() == {}

    def test_device_memory_stats(self):
        assert device_memory_stats("cpu") == {}


def test_span_stats_and_report_match_jax():
    """The same durations give JAX's SpanStats, summary() and report()
    layout."""
    jp, tp = jprof.Profiler(), Profiler()
    for i, dt in enumerate(DTS):
        name = "render" if i % 2 else "a much longer span name"
        jp.spans[name].record(dt)
        tp.record(name, dt)
    for name, js in jp.spans.items():
        ts = tp.spans[name]
        assert (ts.count, ts.total_s, ts.ema_s, ts.max_s) == (
            js.count, js.total_s, js.ema_s, js.max_s)
    assert tp.summary() == jp.summary()
    assert tp.report() == jp.report()
    one = tprof.SpanStats()
    ref = jprof.SpanStats()
    for dt in DTS:
        one.record(dt)
        ref.record(dt)
    assert one == tprof.SpanStats(ref.count, ref.total_s, ref.ema_s,
                                  ref.max_s)


def test_locked_times_the_wait():
    """locked() holds the lock for its block and records the wait."""
    p = Profiler()
    lock = threading.Lock()
    lock.acquire()
    released = threading.Timer(0.05, lock.release)
    released.start()
    with p.locked("wait", lock):
        assert lock.locked()
    released.join(timeout=5)
    assert not lock.locked()
    s = p.summary()["wait"]
    assert s["count"] == 1 and s["max_ms"] >= 30.0


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(tmp_path / "tb"):
        torch.ones(64, 64).sum()
    data = json.loads((tmp_path / "tb" / "trace.json").read_text())
    assert data["traceEvents"]


def test_spans_from_many_threads():
    """Spans recorded from more threads than cores at a short switch
    interval lose no count."""
    import os
    import sys

    threads = len(os.sched_getaffinity(0)) + 2
    p = Profiler()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(500):
                p.record("s", 1e-3)

        ts = [threading.Thread(target=work) for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert p.summary()["s"]["count"] == threads * 500
