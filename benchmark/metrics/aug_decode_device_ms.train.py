"""Device ms a training step of the operations launched inside the
program's ``vf.nets.depth.aug``: the depth-synthesis view's frustum sample
(K3's second call) and its decoder pass. Forward only: their backward's
kernels are launched under ``vf.step.backward``. None where the trace
holds no such span (no depth synthesis, or a program without it)."""
from benchmark import spans

SPANS = ("vf.nets.depth.aug",)


def read(r):
    sp = spans.of(r, "train")
    if sp is None or not any(sp.has(s) for s in SPANS):
        return None
    return sp.device_us(SPANS) / 1e3 / r["trace_units"]
