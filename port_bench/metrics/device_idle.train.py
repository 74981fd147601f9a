"""The device's idle share of the traced window of the training cells,
in % (port_bench/readers.py::device_idle)."""
from port_bench.readers import device_idle


def read(layer):
    return device_idle(layer)
