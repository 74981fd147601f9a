"""The whole frame's share of the card's peak, in %: its least time
(port_bench/roofline.py: its priced parts at the published peaks) over
the traced window's seconds per frame."""
from port_bench.readers import step_mfu


def read(layer):
    return step_mfu(layer)
