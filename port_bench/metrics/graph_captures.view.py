"""CUDA graphs the program captured in the traced window of the view
cells (its counter `graphs.captures`): a render graph built again, where
set-up captured every one (expected 0)."""
from port_bench.program_spans import counter


def read(layer):
    return counter("graphs.captures")
