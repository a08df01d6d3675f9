"""Loss functions of the multi-modal VAE family.

Counterpart of ``anytime3d_tpu/ops/losses.py``. Every function is batched
over the leading axis and reduces per sample (a sum over the feature axes),
so the caller picks the batch reduction.
"""

from __future__ import annotations

from typing import Optional

import torch


def gaussian_kl(mean: torch.Tensor, log_var: torch.Tensor, mean_target: torch.Tensor,
                log_var_target: torch.Tensor) -> torch.Tensor:
    """KL( N(mean, exp(log_var)) || N(mean_target, exp(log_var_target)) ),
    closed form, summed over the last axis:
    0.5*(lv_t - lv) + (exp(lv) + (m - m_t)^2) / (2 exp(lv_t)) - 0.5."""
    kl = (
        0.5 * (log_var_target - log_var)
        + (torch.exp(log_var) + torch.square(mean - mean_target)) / (2.0 * torch.exp(log_var_target))
        - 0.5
    )
    return kl.sum(dim=-1)


def standard_gaussian_kl(mean: torch.Tensor, log_var: torch.Tensor) -> torch.Tensor:
    """KL( N(mean, exp(log_var)) || N(0, I) ): the plain-VAE prior term."""
    return gaussian_kl(mean, log_var, torch.zeros_like(mean), torch.zeros_like(log_var))


def focal_binary_loss(pred: torch.Tensor, target: torch.Tensor, gamma: float = 0.6, b_range: bool = False,
                      epsilon: float = 1e-7) -> torch.Tensor:
    """Gamma-weighted binary cross-entropy over flattened voxels, per sample.

    ``gamma`` weights the occupied voxels; ``b_range`` shifts the targets from
    {0, 1} to {-1, 2}. ``pred`` holds probabilities, clipped to
    [epsilon, 1 - epsilon] before the log. The math runs in float32 whatever
    the input dtype: in bfloat16 the upper clip bound rounds to 1.0 and a
    saturated prediction gives log(0)."""
    b = 1.0 if b_range else 0.0
    n = pred.shape[0]
    pred = pred.reshape(n, -1).float().clamp(epsilon, 1.0 - epsilon)
    y = -b + (2.0 * b + 1.0) * target.reshape(n, -1).float()
    loss = -(gamma * y * torch.log(pred) + (1.0 - gamma) * (1.0 - y) * torch.log(1.0 - pred))
    return loss.sum(dim=-1)


def prior_repulsion(z_mean: torch.Tensor, z_log_var: torch.Tensor, dist_in_z_space: float,
                    class_onehot: Optional[torch.Tensor] = None, z_mean_cols: Optional[torch.Tensor] = None,
                    class_onehot_cols: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pairwise repulsion of prior Gaussians in latent space, per sample.

    For each ordered pair (i, j) of the batch the variance-normalised L1
    distance d_ij = sum_k |mu_i - mu_j|_k / exp(0.5 * lv_i)_k is hinged at
    ``dist_in_z_space``: pairs closer than the margin pay (d_ij - margin)^2.
    The diagonal (d_ii = 0) pays the constant margin^2, as in the JAX package.
    ``class_onehot`` gates the penalty to same-class pairs. The j of a pair
    runs over ``z_mean_cols`` (and ``class_onehot_cols``) where given: a
    data-parallel rank's rows i against the means of the whole batch."""
    cols = z_mean if z_mean_cols is None else z_mean_cols
    diff = (z_mean[:, None, :] - cols[None, :, :]).abs() / torch.exp(0.5 * z_log_var[:, None, :])
    hinge = diff.sum(dim=-1) - dist_in_z_space  # (B, B)
    penalty = torch.where(hinge > 0.0, torch.zeros_like(hinge), torch.square(hinge))
    if class_onehot is not None:
        onehot_cols = class_onehot if class_onehot_cols is None else class_onehot_cols
        differ = (class_onehot[:, None, :] - onehot_cols[None, :, :]).abs().sum(dim=-1)
        penalty = penalty * (differ <= 0.0).to(penalty.dtype)
    return penalty.sum(dim=-1)


def softmax_cross_entropy(logits: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    """Per-sample softmax cross-entropy against (possibly smoothed) one-hot
    targets, in float32 whatever the inputs' dtype: the max-shifted
    log-softmax, as the JAX package writes it (classifier pretraining)."""
    logits = logits.float()
    shifted = logits - logits.amax(dim=-1, keepdim=True)
    log_p = shifted - torch.log(torch.exp(shifted).sum(dim=-1, keepdim=True))
    return -(onehot.float() * log_p).sum(dim=-1)
