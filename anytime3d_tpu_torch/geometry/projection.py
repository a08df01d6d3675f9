"""Camera projection, viewing rays and rotation composition.

Counterpart of ``anytime3d_tpu/geometry/projection.py``. Every function is
batched over leading axes and runs on its inputs' device. A projection
matrix may be given as a NumPy array (``KITTI_PROJ``) or a tensor; it is
used in the dtype of the points it acts on, float32 as the JAX package uses
it.
"""

from __future__ import annotations

import numpy as np
import torch

# The hard-coded KITTI camera of the reference visualizer.
KITTI_PROJ = np.array(
    [
        [7.21537720e02, 0.0, 6.09559326e02, 4.48572807e01],
        [0.0, 7.21537720e02, 1.72854004e02, 2.16379106e-01],
        [0.0, 0.0, 1.0, 2.74588400e-03],
        [0.0, 0.0, 0.0, 1.0],
    ],
    dtype=np.float64,
)
KITTI_PROJ_INV = np.linalg.inv(KITTI_PROJ)


def as_matrix(m, like: torch.Tensor) -> torch.Tensor:
    """``m`` (array or tensor) as a tensor of ``like``'s dtype and device."""
    if isinstance(m, torch.Tensor):
        return m.to(like.device, like.dtype)
    return torch.as_tensor(np.asarray(m), dtype=like.dtype, device=like.device)


def get_ray(proj_inv, pixels: torch.Tensor) -> torch.Tensor:
    """Back-project pixels (..., 2) to unit viewing rays (..., 3)."""
    ones = torch.ones_like(pixels[..., 0])
    p = torch.stack([pixels[..., 0], pixels[..., 1], ones, ones], dim=-1)
    ray = torch.einsum("ij,...j->...i", as_matrix(proj_inv, p), p)[..., :3]
    return ray / torch.linalg.vector_norm(ray, dim=-1, keepdim=True)


def ray_rotation(ray: torch.Tensor) -> torch.Tensor:
    """The rotation taking the camera z axis to a viewing ray (..., 3) -> (..., 3, 3)
    (an x rotation, then a y rotation)."""
    ray = ray / torch.linalg.vector_norm(ray, dim=-1, keepdim=True)
    rx, ry, rz = ray[..., 0], ray[..., 1], ray[..., 2]
    cy = torch.sqrt(ry * ry + rz * rz)
    cx, sx, sy = rz / cy, -ry / cy, rx
    zeros = torch.zeros_like(rx)
    return torch.stack([
        torch.stack([cy, zeros, sy], dim=-1),
        torch.stack([sx * sy, cx, -sx * cy], dim=-1),
        torch.stack([-cx * sy, sx, cx * cy], dim=-1),
    ], dim=-2)


def euler_to_rotation(sin_aei: torch.Tensor, cos_aei: torch.Tensor) -> torch.Tensor:
    """(sin, cos) of (azimuth, elevation, in-plane) -> R = RA RE RI, (..., 3) -> (..., 3, 3)."""
    sA, sE, sI = sin_aei.unbind(-1)
    cA, cE, cI = cos_aei.unbind(-1)
    return torch.stack([
        torch.stack([-sA * sE * sI + cA * cI, -sA * cE, sA * sE * cI + sI * cA], dim=-1),
        torch.stack([sA * cI + sE * sI * cA, cA * cE, sA * sI - sE * cA * cI], dim=-1),
        torch.stack([-sI * cE, sE, cE * cI], dim=-1),
    ], dim=-2)


def compose_object_rotation(sin_aei: torch.Tensor, cos_aei: torch.Tensor, pixel_center: torch.Tensor,
                            proj_inv=KITTI_PROJ_INV, elevation_correction_deg: float = -5.0) -> torch.Tensor:
    """The object's rotation in the camera: the Euler composition with the
    elevation turned by ``elevation_correction_deg``, the Pascal-to-KITTI flip
    (90 degrees about x), then the viewing ray's rotation at the detection's
    center."""
    beta = torch.deg2rad(torch.tensor(elevation_correction_deg, dtype=sin_aei.dtype, device=sin_aei.device))
    sE, cE = sin_aei[..., 1], cos_aei[..., 1]
    sin_c = torch.stack([sin_aei[..., 0], sE * torch.cos(beta) - cE * torch.sin(beta), sin_aei[..., 2]], dim=-1)
    cos_c = torch.stack([cos_aei[..., 0], cE * torch.cos(beta) + sE * torch.sin(beta), cos_aei[..., 2]], dim=-1)
    r = euler_to_rotation(sin_c, cos_c)
    flip = torch.stack([r[..., 0, :], -r[..., 2, :], r[..., 1, :]], dim=-2)  # rows (0, -2, 1)
    return ray_rotation(get_ray(proj_inv, pixel_center)) @ flip


def project_points(proj, points: torch.Tensor) -> torch.Tensor:
    """World points (..., 3) -> pixel coordinates (..., 2) through a 4x4 projection."""
    homog = torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)
    x = torch.einsum("ij,...j->...i", as_matrix(proj, points), homog)
    return x[..., :2] / x[..., 2:3]


_CORNER_SIGNS = [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]


def project_bbox3d_corners(proj, r: torch.Tensor, t: torch.Tensor, whl: torch.Tensor) -> torch.Tensor:
    """The 8 projected corners of an oriented 3-D box, (..., 8, 2)."""
    w, h, l = whl.unbind(-1)
    half = torch.stack([w / 2.0, l / 2.0, h / 2.0], dim=-1)  # (dx, dy, dz)
    signs = torch.tensor(_CORNER_SIGNS, dtype=whl.dtype, device=whl.device)  # (8, 3)
    corners = signs * half[..., None, :]
    world = torch.einsum("...ij,...kj->...ki", r, corners) + t[..., None, :]
    return project_points(proj, world)
