"""The harness's arithmetic on synthetic numbers: the rate, the 95th
percentile over every frame, busy and idle time from spans, the per-layer
readers and the least-time pricing."""
from __future__ import annotations

import statistics
from pathlib import Path

import pytest
import torch

from port_bench import byname, cells, roofline
from port_bench.trace import DeviceTrace, reduce_events

REPO = Path(__file__).resolve().parents[2]


def reader(name):
    return byname.module(REPO, "metrics", name).read


def test_p95_is_over_every_frame():
    lat = [0.001 * i for i in range(1, 101)]
    assert cells.p95(lat) == pytest.approx(
        statistics.quantiles(lat, n=20)[18])
    assert cells.p95(lat) == pytest.approx(0.09595)
    assert cells.p95([0.25]) == 0.25


def test_busy_idle_and_gaps():
    """Device ops [0, 10), [5, 20), [30, 40) us in a 50 us window: busy
    30 us, one 10 us gap put down to the host span covering it."""
    out = DeviceTrace(window_s=50e-6)
    reduce_events([(30.0, 40.0, "k2"), (0.0, 10.0, "k1"),
                   (5.0, 20.0, "k1"), (0.0, 50.0, "port_bench.window")],
                  [(0.0, 50.0, "port_bench.window"),
                   (18.0, 33.0, "port_bench.fetch")], out)
    assert out.busy_s == pytest.approx(30e-6)
    assert out.ops == 3
    assert out.by_name["k1"] == pytest.approx(25e-6)
    assert out.gaps == {"port_bench.fetch": pytest.approx(10e-6)}
    for name in ("device_idle.train", "device_idle.view"):
        assert reader(name)({"trace": out}) == pytest.approx(40.0)
    b = out.breakdown()
    assert b["device_ops"][0][0] == "k1" and len(b["idle_gaps"]) == 1


def test_rooflines_and_mfu_readers():
    ns = "(anonymous namespace)::"
    trace = DeviceTrace(window_s=1.0, busy_s=0.5, ops=10,
                        by_name={ns + "blend_fwd_kernel(float const*)": 0.2,
                                 ns + "blend_bwd_kernel(float const*)": 0.4})
    layer = {"trace": trace, "count": 100, "window_s": 1.0,
             "k1_s": 0.0005, "k2_s": 0.001, "least_s": 0.002}
    assert trace.kernel_seconds("blend_fwd_kernel") == 0.2
    assert trace.kernel_seconds("blend_fwd") == 0.0
    # K1: 0.5 ms least against 2 ms a call on the device.
    assert reader("blend_fwd_roofline.train")(layer) == pytest.approx(25.0)
    assert reader("blend_bwd_roofline")(layer) == pytest.approx(25.0)
    assert reader("train_mfu")(layer) == pytest.approx(20.0)
    assert reader("view_mfu")(layer) == pytest.approx(20.0)
    assert reader("blend_fwd_roofline.view")({"trace": trace}) is None
    assert reader("view_render_ms")({"spans": {"viewer.render": {
        "count": 3, "mean_ms": 2.5}}}) == 2.5
    assert reader("view_d2h_ms")({}) is None
    assert reader("view_ms_p95_traced")({"frame_ms_p95": 6.25}) == 6.25
    assert reader("view_ms_p95_traced")({}) is None


def test_bounds_price_the_peaks():
    assert roofline.bound(67e12, 0.0) == pytest.approx(1.0)
    assert roofline.bound(0.0, 3.35e12) == pytest.approx(1.0)
    # 1,000 rows: 26,000 box ops (20 a row at the f64 peak) take less
    # than reading the rows (64 B each) and 10 counts.
    t = roofline.blend_bound(0.0, 1000, 10, 0.0)
    assert t == pytest.approx((64_000 + 40) / 3.35e12)
    t = roofline.blend_bound(1e9, 1000, 10, 0.0)
    assert t == pytest.approx((1e9 + 6000) / 67e12 + 20000 / 34e12)


def test_pair_counts_on_one_tile():
    """One opaque entry over a whole tile: every pixel where it reaches
    alpha 0.99 stops there (T = 0.01 >= 1e-4, so it is applied)."""
    row = torch.zeros(1, 1, 16)
    row[0, 0, :6] = torch.tensor([16.0, 16.0, 1e-6, 0.0, 1e-6, 1.0])
    counts = torch.tensor([1], dtype=torch.int32)
    nc = torch.ones(1, 1024, dtype=torch.int32)
    pairs = roofline.blend_pair_counts(row, counts, nc, 1)
    assert pairs == {"k1_stop": 0, "k1_applied": 1024, "k2_valid": 1024}


def test_leaf_gap_against_the_median_leaf():
    ref = {"a": torch.ones(4), "b": torch.ones(4) * 3, "c": torch.zeros(4)}
    prog = {"a": torch.ones(4), "b": torch.ones(4) * 3,
            "c": torch.ones(4) * 1e-3}
    # c's norm 2e-3 against the median leaf's 2.
    assert cells.leaf_gaps(prog, ref) == pytest.approx(1e-3)
    assert cells.leaf_gaps(prog, ref, keep=["a", "b"]) == 0.0
