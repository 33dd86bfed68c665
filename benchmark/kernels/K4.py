"""Trilinear frustum sample, backward with f32 updates
(csrc/sample3d_bwd.cu): the volume gradient, a destination-tiled reduction
with its plan. Reads the cotangent rows of the live frustum points and the
points once; writes the volume gradient once."""

KERNELS = ("sample3d_bwd_keys_kernel", "sample3d_bwd_tile_kernel",
           "sample3d_bwd_combine_kernel")
BOUND_PER_LAUNCH_OF = ("sample3d_bwd_tile_kernel",)


def nbytes(v):
    return 4 * (v["live"] * v["vc"] + v["fpts"] * 3
                + v["b"] * v["nvox"] * v["vc"])


def flops(v):
    return 16 * v["live"] * v["vc"]
