"""The plain reference of a served request: encode, the class prior's means
over all one-hots, the nearest prior over the observed latent dims, the
missing dims filled from a class's mean, and the decode, in float32.

:func:`served_like` computes what the serving program would answer, the
class taken by the reference itself (the control computes it so, in a lower
precision); :func:`expected` computes the latent and the logits that the
served category implies, which is what a served answer is judged against.
"""

from __future__ import annotations

from typing import Dict

import torch

from perfbench.reference import model as ref


def prior_means(P: ref.Params, cfg: dict, precision: str = "f32") -> torch.Tensor:
    k = cfg["prior_category"]["input_dim"]
    eye = torch.eye(k, device=next(iter(P.values())).device)
    return ref.prior(P, cfg, "prior_category", eye, None, precision)[0]


def latent(P: ref.Params, cfg: dict, vox: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """(B, 1, D, H, W) occupancy -> the posterior mean of the category block."""
    return ref.split_posterior(cfg, ref.encode_voxels(P, cfg, vox, precision))[0]


def bits_order(logits_blocked: torch.Tensor) -> torch.Tensor:
    """(B, 64, D/4, H/4, W/4) blocked logits -> (B, N) in the row-major order of the fine grid."""
    return ref.depth_to_space(logits_blocked, 4).flatten(1)


def expected(P: ref.Params, cfg: dict, z_ref: torch.Tensor, means: torch.Tensor, mask: torch.Tensor,
             category: torch.Tensor, precision: str = "f32") -> Dict[str, torch.Tensor]:
    """The latent the served ``category`` implies (observed dims from
    ``z_ref``, the rest from the class's mean) and its decode's logits (B, N)."""
    z = torch.where(mask > 0, z_ref, means[category])
    return {"z": z, "logits": bits_order(ref.decode_logits(P, cfg, z, precision))}


def served_like(P: ref.Params, cfg: dict, vox: torch.Tensor, mask: torch.Tensor,
                precision: str = "f32") -> Dict[str, torch.Tensor]:
    """What the serving program answers, computed by the reference at
    ``precision``: ``category``, ``z_mean``, ``bits`` (B, N)."""
    means = prior_means(P, cfg, precision)
    z = latent(P, cfg, vox, precision)
    d = (mask[:, None, :] * (z[:, None, :] - means[None]) ** 2).sum(-1)
    category = d.argmin(dim=1)
    out = expected(P, cfg, z, means, mask, category, precision)
    return {"category": category, "z_mean": out["z"], "bits": (out["logits"] > 0).to(torch.uint8)}
