"""Grouped voxel back-projection, forward (csrc/backproject_sample.cu):
every camera's features at every voxel, summed over the two overlap
groups. Reads the features, the low-resolution mask and the camera-plane
voxel points once; writes the two group sums (features, relative depth,
validity) and each camera's validity once."""

KERNELS = ("backproject_grouped_kernel",)
BOUND_PER_LAUNCH_OF = ("backproject_grouped_kernel",)


def nbytes(v):
    bc, fpix, c, nvox = v["bc"], v["fh"] * v["fw"], v["C"], v["nvox"]
    return 4 * (bc * fpix * c + bc * fpix + bc * nvox * 3
                + v["b"] * 2 * nvox * (c + 2) + bc * nvox)


def flops(v):
    return 8 * v["valid"] * v["C"]
