"""K1's share of its roofline, in %: the least time of the blend
forward per frame (port_bench/roofline.py, from the reference's binning
of the cell's views) over the device time per frame of the kernel
blend_fwd_kernel."""
from port_bench.readers import kernel_roofline


def read(layer):
    return kernel_roofline(layer, "blend_fwd_kernel", "k1_s")
