"""Mean ms of the program's `viewer.camera` span (the pose, the render
ladder and the camera matrices of a frame) over the traced window."""
from port_bench.program_spans import span_stat


def read(layer):
    return span_stat("viewer.camera", "mean_ms")
