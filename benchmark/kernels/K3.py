"""Trilinear frustum sample of the fused voxel volume (csrc/sample3d.cu).
Reads the voxel rows a live tap reads and the frustum points once; writes
the sample once."""

KERNELS = ("sample3d_trilinear_kernel", "sample3d_trilinear_vec_kernel")
BOUND_PER_LAUNCH_OF = KERNELS


def nbytes(v):
    return 4 * (v["rows"] * v["vc"] + v["fpts"] * 3 + v["fpts"] * v["vc"])


def flops(v):
    return 16 * v["live"] * v["vc"]
