"""Host-to-device copy bytes a training step (1e6 B) launched inside the
program's ``vf.loader.*`` and ``vf.train_step`` spans."""
from benchmark.spans import upload_mb


def read(r):
    return upload_mb(r, "train")
