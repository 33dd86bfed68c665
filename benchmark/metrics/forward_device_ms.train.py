"""Device ms a training step of the operations launched inside the
program's ``vf.step.forward`` (the model's forward and the loss)."""
from benchmark.spans import device_ms


def read(r):
    return device_ms(r, "forward")
