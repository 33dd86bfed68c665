"""Seconds from the start of the process to the first step or request
of the window: imports, data, weights, warm-up and kernel builds."""


def read(r):
    return r["setup_s"]
