"""Geometry: camera projection, viewing-ray rotation, translation recovery by
SVD, and the metric lifting of detections.

Counterpart of ``anytime3d_tpu/geometry``, batched over objects and
hypotheses on the tensors' device. Of the JAX package's geometry, only the
bundle adjustment, pose graph, two-view and feature modules (``ba``,
``posegraph``, ``twoview``, ``features``) are not ported yet.
"""

from anytime3d_tpu_torch.geometry.lifting import lift_detections, rescale_transform_points, voxel_grid_points
from anytime3d_tpu_torch.geometry.projection import (
    KITTI_PROJ,
    KITTI_PROJ_INV,
    compose_object_rotation,
    euler_to_rotation,
    get_ray,
    project_bbox3d_corners,
    project_points,
    ray_rotation,
)
from anytime3d_tpu_torch.geometry.translation import recover_translation

__all__ = [
    "KITTI_PROJ",
    "KITTI_PROJ_INV",
    "get_ray",
    "ray_rotation",
    "euler_to_rotation",
    "compose_object_rotation",
    "project_points",
    "project_bbox3d_corners",
    "recover_translation",
    "voxel_grid_points",
    "rescale_transform_points",
    "lift_detections",
]
