"""Mean ms of render_from_pose's `viewer.d2h` span (the program's Profiler:
the frame's copy to the host) over the traced window."""
from port_bench.readers import span_mean_ms


def read(layer):
    return span_mean_ms(layer, "viewer.d2h")
