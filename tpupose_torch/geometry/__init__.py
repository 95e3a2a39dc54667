"""Geometry: cameras, projection, epipolar distances, rays, triangulation.

Plain torch, (x, y) image convention, 3D in dataset units.
"""
from tpupose_torch.geometry.cameras import (
    CameraSet,
    fundamental_from_krt,
    fundamental_matrices,
    load_calibration_pickle,
    make_camera_set,
    project_points,
)
from tpupose_torch.geometry.epipolar import (
    epipolar_distance_directed,
    epipolar_distance_matrix,
    epipolar_distance_pair,
    point_line_distance_2d,
)
from tpupose_torch.geometry.rays import (
    back_project_rays,
    line_line_distance_3d,
    line_point_distance_3d,
)
from tpupose_torch.geometry.triangulation import (
    dlt_design_rows,
    fuse_pairwise_humans,
    triangulate_joints,
    triangulate_pairwise,
    triangulate_top_down,
)

__all__ = [
    "CameraSet",
    "fundamental_from_krt",
    "fundamental_matrices",
    "load_calibration_pickle",
    "make_camera_set",
    "project_points",
    "epipolar_distance_directed",
    "epipolar_distance_matrix",
    "epipolar_distance_pair",
    "point_line_distance_2d",
    "back_project_rays",
    "line_line_distance_3d",
    "line_point_distance_3d",
    "dlt_design_rows",
    "fuse_pairwise_humans",
    "triangulate_joints",
    "triangulate_pairwise",
    "triangulate_top_down",
]
