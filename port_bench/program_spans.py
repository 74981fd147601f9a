"""What the readers of the program's own spans and counters share
(port_bench/metrics/<name>.py): the traced record of the window, which
photo_slam_tpu_torch.utils.profiling.traced() returns (each span name's
count, mean, p95, max and self time in ms; each counter's total), and the
device's idle gaps put down to the program's spans. A program without
such a record, or a record that holds nothing, gives None."""
from __future__ import annotations


def record():
    """The program's traced record, or None where it has none or the
    record holds nothing."""
    from photo_slam_tpu_torch.utils import profiling

    traced = getattr(profiling, "traced", None)
    if traced is None:
        return None
    rec = traced()
    return rec if rec["spans"] or rec["counters"] else None


def span_stat(name: str, stat: str):
    """The statistic `stat` ("mean_ms", "p95_ms", ...) of span `name`, or
    None where the record has no such span."""
    rec = record()
    span = rec["spans"].get(name) if rec else None
    return span[stat] if span and span["count"] else None


def counter(name: str):
    """The total of counter `name` over the window (0 where the record
    holds other spans or counters but not this one), or None."""
    rec = record()
    return rec["counters"].get(name, 0) if rec else None


def idle_in_spans(layer: dict, prefixes: tuple):
    """ms per iteration or frame of the device's idle gaps whose covering
    host activity is one of the program's spans named with one of
    `prefixes` (port_bench/trace.py: the innermost host event at the
    gap's middle), or None where the trace holds no device operation."""
    trace, count = layer.get("trace"), layer.get("count", 0)
    if trace is None or not trace.ops or not count or record() is None:
        return None
    idle_s = sum(s for name, s in trace.gaps.items()
                 if name.startswith(prefixes))
    return 1e3 * idle_s / count
