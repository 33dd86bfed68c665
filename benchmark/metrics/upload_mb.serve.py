"""Host-to-device copy bytes a request (1e6 B) launched inside the
program's ``vf.predict``."""
from benchmark.spans import upload_mb


def read(r):
    return upload_mb(r, "serve")
