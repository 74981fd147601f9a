"""The port's profiler against the JAX package's: the four scenarios of
tests/test_profiling.py on the port, SpanStats and report() equal to
JAX's for the same durations, the lock-wait span, and trace() writing a
Chrome trace."""
import collections
import json
import statistics
import threading
import time

import pytest
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


# ---------------------------------------------------------------------------
# Spans on a torch.profiler trace, counters and the traced record.
# ---------------------------------------------------------------------------

def _session():
    from torch.profiler import ProfilerActivity, profile

    tprof.clear_traced()
    return profile(activities=[ProfilerActivity.CPU], record_shapes=True)


def test_span_joins_the_trace_with_its_identifier():
    """Under a session a span, of an enabled or a disabled Profiler, is a
    range of its name among the trace's events, its identifier the
    range's argument, inherited by the spans inside it."""
    p = Profiler()
    with _session() as prof:
        with p.span("outer", ident=41):
            with tprof.DISABLED.span("inner"):
                torch.ones(8).sum()
        with p.span("plain"):
            pass
    got = {e.name: e for e in prof.events()
           if e.name in ("outer", "inner", "plain")}
    assert set(got) == {"outer", "inner", "plain"}
    assert got["outer"].concrete_inputs == [41]
    assert got["inner"].concrete_inputs == [41]
    outer, inner = got["outer"].time_range, got["inner"].time_range
    assert outer.start <= inner.start <= inner.end <= outer.end
    assert set(p.summary()) == {"outer", "plain"}
    assert tprof.DISABLED.summary() == {}
    records = {r["name"]: r for r in tprof.traced(records=True)["records"]}
    assert records["inner"]["parent"] == records["outer"]["id"]
    assert records["outer"]["parent"] == records["plain"]["parent"] == 0
    assert records["plain"]["ident"] is None
    assert records["inner"]["thread"] == threading.get_native_id()


def test_no_session_opens_no_range(monkeypatch):
    """With no session a span opens no record_function range and leaves
    the traced record empty; a disabled Profiler's span is the shared
    empty context."""
    opened = []
    monkeypatch.setattr(torch.autograd, "_record_function_with_args_enter",
                        lambda *a: opened.append(a))
    tprof.clear_traced()
    p = Profiler()
    with p.span("timed", ident=3), tprof.DISABLED.span("untimed"):
        pass
    p.count("c")
    tprof.DISABLED.count("c")
    assert opened == [] and not tprof.recording()
    assert tprof.traced() == {"spans": {}, "counters": {}}
    assert p.summary()["timed"]["count"] == 1 and p.counters == {"c": 1}
    assert tprof.DISABLED.span("x") is tprof.DISABLED.span("y")
    assert tprof.DISABLED.counters == {}


def test_counters_and_traced_statistics(monkeypatch):
    """count() adds to the Profiler's counters and, under a session, to the
    record's, a disabled Profiler's to the record's alone; traced() gives
    each span's count, total, mean, p95, max and self time (less its
    children) on the span clock."""
    clock = iter(range(0, 10**12, 10**6))   # each reading 1 ms later
    monkeypatch.setattr(tprof.time, "perf_counter_ns", lambda: next(clock))
    p = Profiler()
    with _session():
        for i in range(20):
            with p.span("outer", ident=i):
                for _ in range(i):
                    next(clock)
                with tprof.DISABLED.span("inner"):
                    next(clock)
            p.count("c", 3)
            tprof.DISABLED.count("d")
    rec = tprof.traced()
    # outer: i + 3 readings apart (i waits, inner's own two, its own),
    # inner: 2 apart.
    outer = [float(i + 4) for i in range(20)]
    s = rec["spans"]["outer"]
    assert s["count"] == 20
    assert s["total_ms"] == pytest.approx(sum(outer))
    assert s["mean_ms"] == pytest.approx(sum(outer) / 20)
    assert s["p95_ms"] == pytest.approx(
        statistics.quantiles(outer, n=20)[-1])
    assert s["max_ms"] == pytest.approx(23.0)
    assert s["self_ms"] == pytest.approx(sum(outer) / 20 - 2.0)
    assert rec["spans"]["inner"]["self_ms"] == pytest.approx(2.0)
    assert rec["counters"] == {"c": 60, "d": 20}
    assert p.counters == {"c": 60}
    assert tprof.DISABLED.counters == {}


def test_traced_record_is_bounded(monkeypatch):
    """The record keeps the last SPAN_RECORDS spans."""
    assert tprof._records.maxlen == tprof.SPAN_RECORDS == 200_000
    monkeypatch.setattr(tprof, "_records", collections.deque(maxlen=5))
    with _session():
        for i in range(8):
            with tprof.DISABLED.span("s", ident=i):
                pass
    kept = tprof.traced(records=True)
    assert [r["ident"] for r in kept["records"]] == [3, 4, 5, 6, 7]
    assert kept["spans"]["s"]["count"] == 5


def test_trace_writes_the_record_beside_the_chrome_trace(tmp_path):
    """trace() empties the record on entry and writes the block's spans
    and counters as spans.json."""
    with _session():
        with tprof.DISABLED.span("before"):
            pass
    with tprof.trace(tmp_path / "tb"):
        with Profiler().span("work", ident=5):
            tprof.DISABLED.count("graphs.replays", 2)
            torch.ones(64, 64).sum()
    out = json.loads((tmp_path / "tb" / "spans.json").read_text())
    assert set(out["spans"]) == {"work"}
    assert out["counters"] == {"graphs.replays": 2}
    (rec,) = out["records"]
    assert rec["name"] == "work" and rec["ident"] == 5
    assert rec["end_ns"] >= rec["start_ns"]
    chrome = json.loads((tmp_path / "tb" / "trace.json").read_text())
    assert any(e.get("name") == "work" for e in chrome["traceEvents"])


def test_traced_spans_from_many_threads():
    """Nested spans from more threads than cores at a short switch
    interval, under a session: none is lost, each has its own thread's
    parent and identifier."""
    import os
    import sys

    threads = len(os.sched_getaffinity(0)) + 2
    p = Profiler()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for i in range(200):
                with p.span("outer", ident=1000 * k + i):
                    with tprof.DISABLED.span("inner"):
                        tprof.DISABLED.count("n")

        with _session():
            ts = [threading.Thread(target=work, args=(k,))
                  for k in range(threads)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    rec = tprof.traced(records=True)
    by_id = {r["id"]: r for r in rec["records"]}
    assert len(by_id) == 2 * 200 * threads
    for r in rec["records"]:
        if r["name"] == "inner":
            parent = by_id[r["parent"]]
            assert parent["name"] == "outer"
            assert (parent["thread"], parent["ident"]) == (r["thread"],
                                                           r["ident"])
    assert rec["counters"] == {"n": 200 * threads}
    assert p.summary()["outer"]["count"] == 200 * threads


def test_spans_on_one_clock_match_jax(monkeypatch):
    """Spans timed on the same clock give JAX's summary() and report()."""
    # A start and an end reading a span, each profiler in turn.
    readings = iter([t for dt in DTS for t in (1.0, 1.0 + dt) * 2])
    monkeypatch.setattr(time, "perf_counter", lambda: next(readings))
    jp, tp = jprof.Profiler(), Profiler()
    for i in range(len(DTS)):
        for prof in (jp, tp):
            with prof.span("render" if i % 2 else "work"):
                pass
    assert tp.summary() == jp.summary()
    assert tp.report() == jp.report()
