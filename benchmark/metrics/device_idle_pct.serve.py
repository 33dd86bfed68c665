"""Share of the traced stretch with no kernel, copy or memset on the
device (serve cells)."""
from benchmark.readers import idle_pct, traced


def read(r):
    return idle_pct(r) if traced(r, "serve") else None
