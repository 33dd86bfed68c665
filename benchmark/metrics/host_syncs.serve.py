"""Host calls a request that wait for the device (``spans.SYNC_CALLS``)
inside the program's ``vf.predict``, in the stretch with host operators."""
from benchmark.spans import host_syncs


def read(r):
    return host_syncs(r, "serve")
