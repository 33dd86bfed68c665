"""Convolution roofline of the traced stretch (train cells)."""
from benchmark.readers import conv_roofline, traced


def read(r):
    return conv_roofline(r) if traced(r, "train") else None
