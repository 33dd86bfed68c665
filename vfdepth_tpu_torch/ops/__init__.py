"""Sampling, warp and resize ops. The CUDA kernels build lazily at first
launch (``_build``), so importing this package needs neither nvcc nor a
card."""
from .backproject_sample import (
    BackprojectGrouped, Sample2d, backproject_grouped, backproject_grouped_bwd,
    backproject_grouped_bwd_plain, backproject_grouped_plain, sample2d,
    sample2d_bwd, sample2d_bwd_plain, sample2d_plain, sample_backproject,
    sample_backproject_grouped, sample_backproject_grouped_raw,
    sample_backproject_raw, sample_bilinear, sample_bilinear_with_nearest_mask)
from .resize import resize_bilinear, upsample2x_nearest
from .sample3d import (Sample3dTrilinear, sample3d_trilinear,
                       sample3d_trilinear_bwd, sample3d_trilinear_bwd_plain,
                       sample3d_trilinear_plain)
from .warp import (WarpImageMask, warp_image_mask, warp_image_mask_maps,
                   warp_image_mask_maps_plain)

__all__ = ["BackprojectGrouped", "Sample2d", "backproject_grouped",
           "backproject_grouped_bwd", "backproject_grouped_bwd_plain",
           "backproject_grouped_plain", "sample2d", "sample2d_bwd",
           "sample2d_bwd_plain", "sample2d_plain", "sample_backproject",
           "sample_backproject_grouped", "sample_backproject_grouped_raw",
           "sample_backproject_raw", "sample_bilinear",
           "sample_bilinear_with_nearest_mask", "resize_bilinear",
           "upsample2x_nearest", "Sample3dTrilinear", "sample3d_trilinear",
           "sample3d_trilinear_bwd", "sample3d_trilinear_bwd_plain",
           "sample3d_trilinear_plain", "WarpImageMask", "warp_image_mask",
           "warp_image_mask_maps", "warp_image_mask_maps_plain"]
