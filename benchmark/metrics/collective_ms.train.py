"""Device ms a step in NCCL kernels on rank 0 (several ranks)."""
from benchmark.readers import collective_ms, traced


def read(r):
    return collective_ms(r) if traced(r, "train") else None
