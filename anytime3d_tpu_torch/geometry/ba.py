"""Bundle adjustment with the landmarks marginalised by the Schur complement.

Counterpart of ``anytime3d_tpu/geometry/ba.py``: damped Gauss-Newton
(Levenberg-Marquardt) over camera poses (a Rodrigues rotation vector and a
translation each) and 3-D landmarks seen through a pinhole camera. The
landmark blocks are eliminated, so each step solves the (6P, 6P) reduced
camera system and back-substitutes the landmarks. Observations are a dense
(P, L) visibility mask, so shapes never depend on the data; pose 0 holds
the gauge.

The per-observation Jacobians (2x6 and 2x3) come from ``torch.func.jacfwd``
under ``torch.func.vmap`` over (P, L), so no Python branch may depend on
the data: ``rodrigues`` keeps both of its branches finite and picks one with
``torch.where``. ``ba_step_sharded`` splits the landmarks over the ``data``
ranks of a mesh: each rank reduces its shard's part of the camera system,
one all-reduce sums them, and every rank solves the small system and
back-substitutes its own landmarks.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch.func import jacfwd, vmap


# ----------------------------------------------------------------- rotations

def _skew(v: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(v[0])
    return torch.stack([torch.stack([z, -v[2], v[1]]), torch.stack([v[2], z, -v[0]]),
                        torch.stack([-v[1], v[0], z])])


def rodrigues(rvec: torch.Tensor) -> torch.Tensor:
    """Rotation vector (3,) -> rotation matrix (3, 3).

    Safe at zero for values and for forward-mode derivatives: theta comes
    from a clamped squared norm, and near the identity the first-order
    exponential I + skew(rvec) (exact derivative at 0) is selected."""
    sq = torch.sum(torch.square(rvec))
    theta = torch.sqrt(torch.clamp(sq, min=1e-24))
    kx = _skew(rvec / theta)
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    r_full = eye + torch.sin(theta) * kx + (1.0 - torch.cos(theta)) * (kx @ kx)
    r_small = eye + _skew(rvec)
    return torch.where(sq < 1e-12, r_small, r_full)


def project(pose: torch.Tensor, point: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """pose (6,) = [rvec, tvec]; point (3,); intrinsics (fx, fy, cx, cy) -> pixel (2,)."""
    pc = rodrigues(pose[:3]) @ point + pose[3:]
    fx, fy, cx, cy = intrinsics[0], intrinsics[1], intrinsics[2], intrinsics[3]
    z = torch.clamp(pc[2], min=1e-6)
    return torch.stack([fx * pc[0] / z + cx, fy * pc[1] / z + cy])


# ----------------------------------------------------------------- the step

@dataclasses.dataclass
class BAProblem:
    poses: torch.Tensor  # (P, 6)
    points: torch.Tensor  # (L, 3)
    observations: torch.Tensor  # (P, L, 2) pixels
    mask: torch.Tensor  # (P, L) 1.0 where observed
    intrinsics: torch.Tensor  # (4,)


def _residual_and_jacobians(poses, points, observations, mask, intrinsics):
    """Residuals r (P, L, 2) and Jacobians Jp (P, L, 2, 6), Jl (P, L, 2, 3)
    of every observation, each multiplied by the mask."""

    def one(pose, point, obs):
        def res_fn(pose_, point_):
            return project(pose_, point_, intrinsics) - obs

        jp, jl = jacfwd(res_fn, argnums=(0, 1))(pose, point)
        return res_fn(pose, point), jp, jl

    over_pl = vmap(vmap(one, in_dims=(None, 0, 0)), in_dims=(0, None, 0))
    r, jp, jl = over_pl(poses, points, observations)
    m = mask[..., None]
    return r * m, jp * m[..., None], jl * m[..., None]


def _schur_reduce(r, jp, jl, damping: float):
    """The reduced camera system of these observations.

    Returns (S (6P, 6P), rhs (6P,), Hll^-1 (L, 3, 3), bl (L, 3), W (L, 6P, 3)),
    all that back-substitution needs. Over landmark shards S and rhs add up."""
    p, n_l = r.shape[0], r.shape[1]
    hpp = torch.einsum("plki,plkj->pij", jp, jp)  # (P, 6, 6): block diagonal over the poses
    bp = -torch.einsum("plki,plk->pi", jp, r)  # (P, 6)
    eye3 = torch.eye(3, dtype=r.dtype, device=r.device)
    hll = torch.einsum("plki,plkj->lij", jl, jl) + damping * eye3  # (L, 3, 3)
    bl = -torch.einsum("plki,plk->li", jl, r)  # (L, 3)
    w = torch.einsum("plki,plkj->lpij", jp, jl)  # (L, P, 6, 3) cross blocks

    hll_inv = torch.linalg.inv(hll)
    w_flat = w.reshape(n_l, p * 6, 3)
    whi = torch.einsum("lab,lbc->lac", w_flat, hll_inv)  # (L, 6P, 3)
    s_corr = torch.einsum("lab,lcb->ac", whi, w_flat)  # sum over landmarks of W Hll^-1 W^T
    rhs_corr = torch.einsum("lab,lb->a", whi, bl)

    s = torch.block_diag(*hpp) - s_corr
    s = s + damping * torch.eye(p * 6, dtype=r.dtype, device=r.device)
    return s, bp.reshape(-1) - rhs_corr, hll_inv, bl, w_flat


def _apply_gauge(s, rhs, fixed_pose: int = 0):
    """Pin one pose (the gauge freedom): its rows and columns become the identity's, its rhs zero."""
    idx = torch.arange(s.shape[0], device=s.device)
    free = (idx < fixed_pose * 6) | (idx >= (fixed_pose + 1) * 6)
    s = torch.where(free[:, None] & free[None, :], s, torch.zeros((), dtype=s.dtype, device=s.device))
    s = s + torch.diag(torch.where(free, 0.0, 1.0).to(s.dtype))
    return s, torch.where(free, rhs, torch.zeros((), dtype=rhs.dtype, device=rhs.device))


def _back_substitute(w_flat, hll_inv, bl, dp):
    """dl_j = Hll_j^-1 (bl_j - W_j^T dp)."""
    wt_dp = torch.einsum("lab,a->lb", w_flat, dp)
    return torch.einsum("lij,lj->li", hll_inv, bl - wt_dp)


def ba_step(problem: BAProblem, damping: float = 1e-3, fix_first_pose: bool = True) -> Tuple[BAProblem,
                                                                                                torch.Tensor]:
    """One LM step: the Schur solve for the poses, then the landmarks.

    Returns (the updated problem, the mean squared residual BEFORE the step)."""
    r, jp, jl = _residual_and_jacobians(problem.poses, problem.points, problem.observations, problem.mask,
                                        problem.intrinsics)
    s, rhs, hll_inv, bl, w_flat = _schur_reduce(r, jp, jl, damping)
    if fix_first_pose:
        s, rhs = _apply_gauge(s, rhs)
    dp = torch.linalg.solve(s, rhs)
    dl = _back_substitute(w_flat, hll_inv, bl, dp)
    new = dataclasses.replace(problem, poses=problem.poses + dp.reshape(-1, 6), points=problem.points + dl)
    n_obs = torch.clamp(torch.sum(problem.mask), min=1.0)
    return new, torch.sum(torch.square(r)) / n_obs


def solve(problem: BAProblem, iters: int = 10, damping: float = 1e-3) -> Tuple[BAProblem, torch.Tensor]:
    """``iters`` LM steps; returns (problem, the (iters,) history of the mse before each step)."""
    history = []
    for _ in range(iters):
        problem, mse = ba_step(problem, damping)
        history.append(mse)
    return problem, torch.stack(history)


# ----------------------------------------------------------- landmark-sharded

def ba_step_sharded(problem: BAProblem, mesh, damping: float = 1e-3) -> Tuple[BAProblem, torch.Tensor]:
    """``ba_step`` with the landmarks split over the ``data`` ranks of
    ``mesh`` (``parallel.make_mesh``), each rank taking its contiguous L/N.

    Every rank holds the whole problem and reduces its shard's (S, rhs); one
    float32 all-reduce sums S, rhs, the observation count and the squared
    residuals. Each shard added the damping diagonal once, so (N-1) of them
    are taken off. Every rank solves the replicated system, back-substitutes
    its own landmarks, and an all-gather hands every rank the whole updated
    problem. L must divide by N."""
    from anytime3d_tpu_torch.parallel.mesh import all_gather_rows, all_reduce_sum, data_rank_and_size

    rank, n = data_rank_and_size(mesh)
    n_l = problem.points.shape[0]
    if n_l % n:
        raise ValueError(f"{n_l} landmarks do not split over {n} ranks")
    sl = slice(rank * n_l // n, (rank + 1) * n_l // n)
    mask = problem.mask[:, sl]
    r, jp, jl = _residual_and_jacobians(problem.poses, problem.points[sl], problem.observations[:, sl], mask,
                                        problem.intrinsics)
    s, rhs, hll_inv, bl, w_flat = _schur_reduce(r, jp, jl, damping)
    m = s.shape[0]
    summed = all_reduce_sum(torch.cat([s.reshape(-1), rhs, torch.sum(mask)[None], torch.sum(torch.square(r))[None]]),
                            mesh)
    s_g = summed[:m * m].reshape(m, m) - (n - 1) * damping * torch.eye(m, dtype=s.dtype, device=s.device)
    s_g, rhs_g = _apply_gauge(s_g, summed[m * m:m * m + m])
    dp = torch.linalg.solve(s_g, rhs_g)
    dl = _back_substitute(w_flat, hll_inv, bl, dp)
    points = all_gather_rows(problem.points[sl] + dl, mesh)
    new = dataclasses.replace(problem, poses=problem.poses + dp.reshape(-1, 6), points=points)
    return new, summed[-1] / torch.clamp(summed[-2], min=1.0)
