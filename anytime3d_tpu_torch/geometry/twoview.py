"""Two-view relative pose: the normalised 8-point essential matrix, the
cheirality vote among its four decompositions, and midpoint triangulation.

Counterpart of ``anytime3d_tpu/geometry/twoview.py``. Every solve has a fixed
shape: one 9x9 ``eigh`` for E, four (R, t) candidates each scored by the
weighted count of points in front of both cameras, triangulation as batched
closed-form 2x2 solves. Correspondences are selected by weights, never by
shrinking arrays.

The null vector of ``eigh`` and the singular vectors of ``svd`` carry a sign
that each linear-algebra library picks for itself, so E is fixed only up to
sign. The set of four candidates does not depend on that sign, and the vote
picks among them, so the pose and the points do not either.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

__all__ = ["TwoViewResult", "estimate_essential", "decompose_essential", "triangulate", "two_view_pose"]


class TwoViewResult(NamedTuple):
    rotation: torch.Tensor  # (3, 3) camera 2 from camera 1
    translation: torch.Tensor  # (3,) unit norm (the scale is unobservable)
    essential: torch.Tensor  # (3, 3)
    points: torch.Tensor  # (N, 3) triangulated, in camera 1's frame
    inlier_weight: torch.Tensor  # (N,) the weights used


def _normalize_points(x: torch.Tensor, w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hartley normalisation: zero centroid, mean distance sqrt(2). Returns (points, T)."""
    wsum = torch.clamp(torch.sum(w), min=1e-6)
    mean = torch.sum(x * w[:, None], dim=0) / wsum
    centered = x - mean
    scale = math.sqrt(2.0) / torch.clamp(torch.sum(torch.linalg.norm(centered, dim=-1) * w) / wsum, min=1e-9)
    zero, one = torch.zeros_like(scale), torch.ones_like(scale)
    t = torch.stack([torch.stack([scale, zero, -scale * mean[0]]), torch.stack([zero, scale, -scale * mean[1]]),
                     torch.stack([zero, zero, one])])
    return centered * scale, t


def estimate_essential(pts1: torch.Tensor, pts2: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """The weighted normalised 8-point algorithm. ``pts1``, ``pts2`` (N, 2)
    are calibrated coordinates (pixels premultiplied by K^-1); ``weights`` in
    [0, 1] select correspondences."""
    x1n, t1 = _normalize_points(pts1, weights)
    x2n, t2 = _normalize_points(pts2, weights)
    u1, v1 = x1n[:, 0], x1n[:, 1]
    u2, v2 = x2n[:, 0], x2n[:, 1]
    a = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, torch.ones_like(u1)], dim=-1)
    a = a * weights[:, None]
    # the smallest right singular vector of A, from eigh of A^T A (9x9)
    _, vecs = torch.linalg.eigh(a.T @ a)
    f = t2.T @ vecs[:, 0].reshape(3, 3) @ t1
    # onto the essential manifold: singular values (s, s, 0)
    u, s, vt = torch.linalg.svd(f)
    s_avg = (s[0] + s[1]) / 2.0
    return u @ torch.diag(torch.stack([s_avg, s_avg, torch.zeros_like(s_avg)])) @ vt


def decompose_essential(e: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The four (R, t) candidates of E: rotations (4, 3, 3), translations (4, 3)."""
    u, _, vt = torch.linalg.svd(e)
    u = u * torch.sign(torch.linalg.det(u))  # proper rotations
    vt = vt * torch.sign(torch.linalg.det(vt))
    w = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=e.dtype, device=e.device)
    r1, r2 = u @ w @ vt, u @ w.T @ vt
    t = u[:, 2]
    return torch.stack([r1, r1, r2, r2]), torch.stack([t, -t, t, -t])


def triangulate(pts1: torch.Tensor, pts2: torch.Tensor, r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Midpoint triangulation in camera 1's frame, (N, 3).

    Rays: d1 = (x1, y1, 1) from the origin; d2 = R^T (x2, y2, 1) from
    o2 = -R^T t. Each point is the midpoint of the closest pair on the two
    rays, a closed-form 2x2 solve."""
    d1 = torch.cat([pts1, torch.ones_like(pts1[:, :1])], dim=-1)
    d2 = torch.cat([pts2, torch.ones_like(pts2[:, :1])], dim=-1) @ r  # R^T d2
    o2 = -r.T @ t
    aa, bb, ab = (d1 * d1).sum(-1), (d2 * d2).sum(-1), (d1 * d2).sum(-1)
    ao, bo = d1 @ o2, d2 @ o2
    det = aa * bb - ab * ab
    det = torch.where(torch.abs(det) < 1e-9, torch.full_like(det, 1e-9), det)
    s = (bb * ao - ab * bo) / det
    u = (ab * ao - aa * bo) / det
    return (s[:, None] * d1 + (o2 + u[:, None] * d2)) / 2.0


def two_view_pose(pts1: torch.Tensor, pts2: torch.Tensor, weights: torch.Tensor) -> TwoViewResult:
    """E, its four candidates, the cheirality vote, the points. The candidate
    with the largest weight of points in front of both cameras wins; a tie
    goes to the first."""
    e = estimate_essential(pts1, pts2, weights)
    rs, ts = decompose_essential(e)
    scores, all_pts = [], []
    for r, t in zip(rs, ts):
        pts = triangulate(pts1, pts2, r, t)
        z2 = (pts @ r.T + t)[:, 2]
        scores.append(torch.sum(((pts[:, 2] > 0) & (z2 > 0)).to(weights.dtype) * weights))
        all_pts.append(pts)
    best = torch.argmax(torch.stack(scores))
    t = ts[best]
    return TwoViewResult(rotation=rs[best], translation=t / torch.clamp(torch.linalg.norm(t), min=1e-9),
                         essential=e, points=torch.stack(all_pts)[best], inlier_weight=weights)
