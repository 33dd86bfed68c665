"""vfdepth_tpu_torch — the PyTorch / CUDA port of ``vfdepth_tpu``.

The same surround-view fusion model, written in PyTorch for NVIDIA Hopper
cards: one card, or one process a card (``parallel/``). Module names
mirror the JAX package so each part has an obvious counterpart; public
boundaries keep its layouts (NHWC batch dicts, channels-last voxel
features in (y, x, z) flat order). The TPU's Pallas
kernels are replaced by CUDA kernels under ``csrc/`` that are compiled at
first use (``ops/_build.py``); every kernel has a plain PyTorch version
beside it, which is what runs for CPU tensors.

This package imports torch and numpy only — never jax or ``vfdepth_tpu``.
"""

__version__ = "0.1.0"

from .config import Config, get_config  # noqa: E402
