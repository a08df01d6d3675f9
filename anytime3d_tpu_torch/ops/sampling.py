"""Reparameterised Gaussian sampling and latent masking.

Counterpart of ``anytime3d_tpu/ops/sampling.py``. Where the JAX functions
take a PRNG key, these take a ``torch.Generator`` on the tensor's device, or
the draw itself (``eps``, ``keep``, ``take_prior``), so that a test can hand
both packages the same numbers.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def _bernoulli(p: float, like: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Boolean tensor shaped as ``like``, true with probability ``p``."""
    return torch.rand(like.shape, generator=generator, device=like.device) < p


def reparameterize(mean: torch.Tensor, log_var: torch.Tensor, generator: Optional[torch.Generator] = None,
                   eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """z = mean + exp(0.5 * log_var) * eps, eps ~ N(0, I) drawn from
    ``generator`` unless given."""
    if eps is None:
        eps = torch.randn(mean.shape, generator=generator, device=mean.device, dtype=mean.dtype)
    return mean + torch.exp(0.5 * log_var) * eps.to(mean.dtype)


def mask_latent(z: torch.Tensor, missing_prob: float, fill_value: Union[torch.Tensor, float] = 0.0,
                generator: Optional[torch.Generator] = None,
                keep: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Anytime observation mask: each latent dim is missing with probability
    ``missing_prob`` and then takes ``fill_value`` (broadcastable). Returns
    ``(z_masked, mask)``, ``mask`` 1.0 where observed."""
    if keep is None:
        keep = _bernoulli(1.0 - missing_prob, z, generator)
    keep = keep.bool()
    fill = torch.as_tensor(fill_value, dtype=z.dtype, device=z.device).expand(z.shape)
    return torch.where(keep, z, fill), keep.to(z.dtype)


def mix_latent(z: torch.Tensor, z_prior: torch.Tensor, mix_prob: float = 0.5,
               generator: Optional[torch.Generator] = None,
               take_prior: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Element-wise mixture: each element takes the prior sample with
    probability ``mix_prob``."""
    if take_prior is None:
        take_prior = _bernoulli(mix_prob, z, generator)
    return torch.where(take_prior.bool(), z_prior, z)
