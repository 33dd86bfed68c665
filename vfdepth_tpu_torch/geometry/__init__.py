from .se3 import axis_angle_to_matrix, vec_to_matrix, invert_pose
from .pose import distribute_pose, relative_cam_poses
from .projection import (backproject, frustum_world_points, linspace_f32,
                         pixel_grid_homo, project_coords,
                         project_coords_window, reproject, voxel_points_homo)

__all__ = ["axis_angle_to_matrix", "vec_to_matrix", "invert_pose",
           "distribute_pose", "relative_cam_poses", "backproject",
           "frustum_world_points", "linspace_f32", "pixel_grid_homo",
           "project_coords", "project_coords_window", "reproject",
           "voxel_points_homo"]
