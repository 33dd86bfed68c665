"""The whole step's share of the chip's peak: the traced stretch's
analytic FLOPs over the device's span of it (from the trace, idle gaps
included) and the precision's peak, in percent (serve cells)."""
from benchmark.readers import step_mfu, traced


def read(r):
    return step_mfu(r) if traced(r, "serve") else None
