"""Host calls a training step that wait for the device (``spans.SYNC_CALLS``)
inside the program's ``vf.train_step``, in the stretch with host operators."""
from benchmark.spans import host_syncs


def read(r):
    return host_syncs(r, "train")
