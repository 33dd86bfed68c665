"""The whole step's share of the chips' peak: analytic FLOPs of the work
the window completed over its time, the chips and the precision's peak,
in percent."""


def read(r):
    return 100.0 * r["flops"]["total"] * r["units_per_chip"] / (
        r["window_s"] * r["peak_flops"])
