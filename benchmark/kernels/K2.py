"""Grouped voxel back-projection, backward (csrc/backproject_sample_bwd.cu):
the feature gradient, a destination-tiled reduction with its plan. Reads
the cotangent rows of the voxels some camera of their group sees, the
voxel points and validity once; writes the feature gradient once."""

KERNELS = ("backproject_bwd_keys_kernel", "backproject_bwd_tile_kernel",
           "backproject_bwd_combine_kernel")
BOUND_PER_LAUNCH_OF = ("backproject_bwd_tile_kernel",)


def nbytes(v):
    bc, c, nvox = v["bc"], v["C"], v["nvox"]
    return 4 * (v["seen"] * c + bc * nvox * 3 + bc * nvox
                + bc * v["fh"] * v["fw"] * c)


def flops(v):
    return 8 * v["valid"] * v["C"]
