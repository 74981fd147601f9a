"""Mean ms of render_from_pose's `viewer.render` span (the program's Profiler:
enqueue to the device's finish) over the traced window."""
from port_bench.readers import span_mean_ms


def read(layer):
    return span_mean_ms(layer, "viewer.render")
