"""Device ms a training step of the operations launched inside the
program's ``vf.geometry.warp_depth`` (each camera's neighbours' depths and
its own warped into its rotated view) and ``vf.losses.synthesis`` (the
depth-synthesis consistency and smoothness terms). Forward only: their
backward's kernels are launched under ``vf.step.backward``. None where the
trace holds neither span (no depth synthesis, or a program without
them)."""
from benchmark import spans

SPANS = ("vf.geometry.warp_depth", "vf.losses.synthesis")


def read(r):
    sp = spans.of(r, "train")
    if sp is None or not any(sp.has(s) for s in SPANS):
        return None
    return sp.device_us(SPANS) / 1e3 / r["trace_units"]
