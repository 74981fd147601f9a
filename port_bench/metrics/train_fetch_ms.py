"""Mean ms of the program's `mapper.fetch` span (the metrics read back
to the host: its wait for the device) over the fetches of the traced
window."""
from port_bench.program_spans import span_stat


def read(layer):
    return span_stat("mapper.fetch", "mean_ms")
