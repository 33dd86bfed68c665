"""Framesets that finished a training step in the window, over the
whole window (every rank's)."""


def read(r):
    if r["kind"] != "train":
        return None
    return r["framesets"] / r["window_s"]
