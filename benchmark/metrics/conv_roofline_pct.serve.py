"""Convolution roofline of the traced stretch (serve cells)."""
from benchmark.readers import conv_roofline, traced


def read(r):
    return conv_roofline(r) if traced(r, "serve") else None
