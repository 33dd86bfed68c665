"""Host ms a training step spent in the calls that ``host_syncs.train``
counts."""
from benchmark.spans import sync_wait_ms


def read(r):
    return sync_wait_ms(r, "train")
