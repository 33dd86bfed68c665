"""torch.cuda.max_memory_allocated over the window, GiB (the highest
rank; serve cells)."""


def read(r):
    if r["kind"] != "serve" or not r["peak_bytes"]:
        return None
    return r["peak_bytes"] / 2 ** 30
