from .se3 import axis_angle_to_matrix, vec_to_matrix, invert_pose
from .pose import distribute_pose
from .projection import (frustum_world_points, linspace_f32, pixel_grid_homo,
                         voxel_points_homo)

__all__ = ["axis_angle_to_matrix", "vec_to_matrix", "invert_pose",
           "distribute_pose", "frustum_world_points", "linspace_f32",
           "pixel_grid_homo", "voxel_points_homo"]
