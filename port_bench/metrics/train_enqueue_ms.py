"""Mean ms of the program's `mapper.enqueue` span (the step graph's
donate check, learning-rate fills, fresh copies and replay launch) over
the traced window."""
from port_bench.program_spans import span_stat


def read(layer):
    return span_stat("mapper.enqueue", "mean_ms")
