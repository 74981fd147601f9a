"""The 95th percentile, in ms, of the program's `viewer.request` span (the
whole GaussianMapper.render_from_pose call) over the traced window: the
program's counterpart of view_ms_p95_traced."""
from port_bench.program_spans import span_stat


def read(layer):
    return span_stat("viewer.request", "p95_ms")
