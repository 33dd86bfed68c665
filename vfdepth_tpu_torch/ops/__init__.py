"""Sampling and resize ops. The CUDA kernels build lazily at first launch
(``_build``), so importing this package needs neither nvcc nor a card."""
from .backproject_sample import (backproject_grouped_raw,
                                 backproject_grouped_raw_plain)
from .resize import resize_bilinear, upsample2x_nearest
from .sample3d import sample3d_trilinear, sample3d_trilinear_plain

__all__ = ["backproject_grouped_raw", "backproject_grouped_raw_plain",
           "resize_bilinear", "upsample2x_nearest", "sample3d_trilinear",
           "sample3d_trilinear_plain"]
