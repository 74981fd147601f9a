"""K2's share of its roofline, in %: the least time of the blend
backward per iteration (port_bench/roofline.py, from the reference's
binning of the cell's views) over the device time per iteration of the
kernel blend_bwd_kernel."""
from port_bench.readers import kernel_roofline


def read(layer):
    return kernel_roofline(layer, "blend_bwd_kernel", "k2_s")
