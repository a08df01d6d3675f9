"""Pose-graph optimisation over SE(3): Gauss-Newton on relative-pose edges.

Counterpart of ``anytime3d_tpu/geometry/posegraph.py``. Nodes are (rvec,
tvec) poses; an edge carries a measured relative transform Z_ij and an
information weight (0 disables it). The residual of an edge is

    r_ij = log( Z_ij^-1 · (T_i^-1 · T_j) )  in R^6  (rotation vector and translation)

and a damped Gauss-Newton step takes the dense (6E, 6N) Jacobian from
``torch.func.jacfwd`` over the fixed edge list. Pose 0 holds the gauge.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch.func import jacfwd, vmap

from anytime3d_tpu_torch.geometry.ba import rodrigues


def rotmat_to_rvec(r: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> rotation vector (the log map).

    Safe for derivatives at the identity: theta is atan2(sin, cos) (finite
    where arccos is not), sin from a clamped norm, and the small-angle branch
    takes the exact limit scale 1/2."""
    axis_raw = torch.stack([r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]])
    sq = torch.sum(torch.square(axis_raw))
    sin_t = 0.5 * torch.sqrt(torch.clamp(sq, min=1e-24))
    cos_t = 0.5 * (r[0, 0] + r[1, 1] + r[2, 2] - 1.0)
    theta = torch.atan2(sin_t, cos_t)
    scale = torch.where(sq < 1e-12, torch.full_like(sq, 0.5), theta / (2.0 * sin_t))
    return axis_raw * scale


def compose(pose_a: torch.Tensor, pose_b: torch.Tensor) -> torch.Tensor:
    """T_a · T_b in (rvec, tvec) form."""
    ra, rb = rodrigues(pose_a[:3]), rodrigues(pose_b[:3])
    return torch.cat([rotmat_to_rvec(ra @ rb), ra @ pose_b[3:] + pose_a[3:]])


def inverse(pose: torch.Tensor) -> torch.Tensor:
    r = rodrigues(pose[:3])
    return torch.cat([rotmat_to_rvec(r.T), -(r.T @ pose[3:])])


def relative(pose_i: torch.Tensor, pose_j: torch.Tensor) -> torch.Tensor:
    """T_i^-1 · T_j."""
    return compose(inverse(pose_i), pose_j)


@dataclasses.dataclass
class PoseGraph:
    poses: torch.Tensor  # (N, 6)
    edges_i: torch.Tensor  # (E,) int source indices
    edges_j: torch.Tensor  # (E,) int target indices
    measurements: torch.Tensor  # (E, 6) measured T_i^-1 T_j
    weights: torch.Tensor  # (E,) information weights (0 disables an edge)


def edge_residual(pose_i: torch.Tensor, pose_j: torch.Tensor, meas: torch.Tensor) -> torch.Tensor:
    """The 6-vector (rvec, tvec) of the discrepancy transform Z^-1 · T_i^-1 T_j."""
    return compose(inverse(meas), relative(pose_i, pose_j))


def graph_residuals(graph: PoseGraph) -> torch.Tensor:
    """(E, 6) weighted edge residuals."""
    r = vmap(edge_residual)(graph.poses[graph.edges_i], graph.poses[graph.edges_j], graph.measurements)
    return r * graph.weights[:, None]


def pgo_step(graph: PoseGraph, damping: float = 1e-3) -> Tuple[PoseGraph, torch.Tensor]:
    """One damped Gauss-Newton step over all poses, pose 0 fixed. Returns
    (the updated graph, the cost sum r^2 BEFORE the step)."""
    n = graph.poses.shape[0]

    def res_flat(poses_flat):
        return graph_residuals(dataclasses.replace(graph, poses=poses_flat.reshape(n, 6))).reshape(-1)

    x0 = graph.poses.reshape(-1)
    r = res_flat(x0)
    jac = jacfwd(res_flat)(x0)  # (6E, 6N)
    eye = torch.eye(6 * n, dtype=x0.dtype, device=x0.device)
    h = jac.T @ jac + damping * eye
    b = -jac.T @ r
    free = torch.arange(6 * n, device=x0.device) >= 6  # the gauge: pose 0 pinned
    zero = torch.zeros((), dtype=h.dtype, device=h.device)
    h = torch.where(free[:, None] & free[None, :], h, zero) + torch.diag(torch.where(free, 0.0, 1.0).to(h.dtype))
    dx = torch.linalg.solve(h, torch.where(free, b, zero))
    return dataclasses.replace(graph, poses=(x0 + dx).reshape(n, 6)), torch.sum(torch.square(r))


def solve_pose_graph(graph: PoseGraph, iters: int = 10, damping: float = 1e-3) -> Tuple[PoseGraph, torch.Tensor]:
    """Returns (the solved graph, the (iters,) cost history); entry k is the
    cost before step k, so the last is one step stale."""
    history = []
    for _ in range(iters):
        graph, cost = pgo_step(graph, damping)
        history.append(cost)
    return graph, torch.stack(history)
