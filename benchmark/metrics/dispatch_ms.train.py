"""Host ms a step until the program's call returns, before any sync."""
from benchmark.readers import span_ms


def read(r):
    return span_ms(r, "train", "dispatch")
