"""Sampling, warp and resize ops. The CUDA kernels build lazily at first
launch (``_build``), so importing this package needs neither nvcc nor a
card."""
from .backproject_sample import (BackprojectGroupedRaw,
                                 backproject_grouped_raw,
                                 backproject_grouped_raw_bwd,
                                 backproject_grouped_raw_bwd_plain,
                                 backproject_grouped_raw_plain)
from .resize import resize_bilinear, upsample2x_nearest
from .sample3d import (Sample3dTrilinear, sample3d_trilinear,
                       sample3d_trilinear_bwd, sample3d_trilinear_bwd_plain,
                       sample3d_trilinear_plain)
from .warp import (WarpImageMask, warp_image_mask, warp_image_mask_maps,
                   warp_image_mask_maps_plain)

__all__ = ["BackprojectGroupedRaw", "backproject_grouped_raw",
           "backproject_grouped_raw_bwd", "backproject_grouped_raw_bwd_plain",
           "backproject_grouped_raw_plain", "resize_bilinear",
           "upsample2x_nearest", "Sample3dTrilinear", "sample3d_trilinear",
           "sample3d_trilinear_bwd", "sample3d_trilinear_bwd_plain",
           "sample3d_trilinear_plain", "WarpImageMask", "warp_image_mask",
           "warp_image_mask_maps", "warp_image_mask_maps_plain"]
