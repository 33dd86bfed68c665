"""The 95th percentile of every request of the window, in ms: from the
host frameset in hand to its depth and poses on the host."""
from benchmark.readers import p95


def read(r):
    if r["kind"] != "serve":
        return None
    return 1e3 * p95(r["spans"]["request"])
