"""ms per frame that the device idles while the host is inside the
program's own `viewer.*` or `graphs.*` spans and no operation inside them
(the trace's idle gaps by their innermost host activity)."""
from port_bench.program_spans import idle_in_spans


def read(layer):
    return idle_in_spans(layer, ("viewer.", "graphs."))
