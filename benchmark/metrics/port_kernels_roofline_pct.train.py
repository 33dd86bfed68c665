"""The port kernels' share of their roofline in the traced stretch
(train cells)."""
from benchmark.readers import port_kernels_roofline, traced


def read(r):
    return port_kernels_roofline(r) if traced(r, "train") else None
