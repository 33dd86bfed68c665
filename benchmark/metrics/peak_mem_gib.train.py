"""torch.cuda.max_memory_allocated over the window, GiB (the highest
rank; train cells)."""


def read(r):
    if r["kind"] != "train" or not r["peak_bytes"]:
        return None
    return r["peak_bytes"] / 2 ** 30
