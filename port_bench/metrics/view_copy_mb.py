"""MB (1e6 bytes) a frame that the program's graph replays copy into
their input buffers and clone out of their outputs (its counters
`graphs.copy_bytes` and `graphs.clone_bytes`), over the frames of the
traced window (its `viewer.request` spans)."""
from port_bench.program_spans import counter, span_stat


def read(layer):
    frames = span_stat("viewer.request", "count")
    if not frames:
        return None
    moved = counter("graphs.copy_bytes") + counter("graphs.clone_bytes")
    return 1e-6 * moved / frames
