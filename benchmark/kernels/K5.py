"""Image and mask warp of view rendering (csrc/warp_image_mask.cu), one
thread a target pixel, 256 a block; a launch's target pixels come from its
grid (the last block's idle threads included, at most 255).

Each target pixel reads its two coordinates and writes the image (3), the
mask (1) and both image derivatives (3 + 3), all f32. A dense launch reads
its sources (RGB and mask) whole. A launch over warp windows reads only
the part of each source that its windows map to: the rig's warps see the
same scene from a neighbouring camera or frame, near one to one, so such
a launch's source pixels are counted as its target pixels, and as the
whole sources where those are fewer."""

KERNELS = ("warp_image_mask_kernel",)
BOUND_PER_LAUNCH_OF = KERNELS

THREADS = 256


def nbytes(v):
    pixels = v["grid"] * THREADS
    sources = min(v["k5_nb"] * v["H"] * v["W"], pixels)
    return 4 * (4 * sources + (2 + 3 + 1 + 3 + 3) * pixels)


def flops(v):
    return 3 * 11 * v["grid"] * THREADS
