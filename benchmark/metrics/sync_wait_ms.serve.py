"""Host ms a request spent in the calls that ``host_syncs.serve`` counts."""
from benchmark.spans import sync_wait_ms


def read(r):
    return sync_wait_ms(r, "serve")
