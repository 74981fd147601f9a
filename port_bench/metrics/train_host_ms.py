"""Mean ms of the program's `mapper.iteration` span (the whole
GaussianTrainer.train_iteration call on the host) over the traced window:
the host's pace beside the device's time per iteration."""
from port_bench.program_spans import span_stat


def read(layer):
    return span_stat("mapper.iteration", "mean_ms")
