"""Host ms a step spent in next() on the program's device_prefetch."""
from benchmark.readers import span_ms


def read(r):
    return span_ms(r, "train", "batch_wait")
