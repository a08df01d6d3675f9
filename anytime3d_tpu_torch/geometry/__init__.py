"""Geometry: camera projection, viewing-ray rotation, translation recovery by
SVD, the metric lifting of detections, and the mapping layer: features,
two-view pose, the pose graph and bundle adjustment.

Counterpart of ``anytime3d_tpu/geometry``, batched over objects and
hypotheses on the tensors' device.
"""

from anytime3d_tpu_torch.geometry.ba import BAProblem, ba_step, ba_step_sharded, project, rodrigues, solve
from anytime3d_tpu_torch.geometry.features import (
    Keypoints,
    Matches,
    detect_keypoints,
    extract_descriptors,
    harris_response,
    match_descriptors,
)
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
from anytime3d_tpu_torch.geometry.posegraph import (
    PoseGraph,
    compose,
    edge_residual,
    graph_residuals,
    inverse,
    pgo_step,
    relative,
    rotmat_to_rvec,
    solve_pose_graph,
)
from anytime3d_tpu_torch.geometry.translation import recover_translation
from anytime3d_tpu_torch.geometry.twoview import (
    TwoViewResult,
    decompose_essential,
    estimate_essential,
    triangulate,
    two_view_pose,
)

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
    "Keypoints",
    "Matches",
    "harris_response",
    "detect_keypoints",
    "extract_descriptors",
    "match_descriptors",
    "TwoViewResult",
    "estimate_essential",
    "decompose_essential",
    "triangulate",
    "two_view_pose",
    "BAProblem",
    "rodrigues",
    "project",
    "ba_step",
    "ba_step_sharded",
    "solve",
    "PoseGraph",
    "rotmat_to_rvec",
    "compose",
    "inverse",
    "relative",
    "edge_residual",
    "graph_residuals",
    "pgo_step",
    "solve_pose_graph",
    "voxel_grid_points",
    "rescale_transform_points",
    "lift_detections",
]
