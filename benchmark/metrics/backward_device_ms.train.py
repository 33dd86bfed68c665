"""Device ms a training step of the operations launched inside the
program's ``vf.step.backward`` (autograd's device thread included)."""
from benchmark.spans import device_ms


def read(r):
    return device_ms(r, "backward")
