"""Reparameterised Gaussian sampling and latent masking.

Counterpart of ``anytime3d_tpu/ops/sampling.py``. Where the JAX functions
take a PRNG key, these take a ``torch.Generator`` on the tensor's device, or
the draw itself (``eps``, ``keep``, ``take_prior``), so that a test can hand
both packages the same numbers.

Inside ``batch_shard(index, count)`` every draw of a batched shape is made
for the whole batch of ``count`` equal shards from the generator, and the
rows of shard ``index`` are kept: a data-parallel rank that holds one shard
of the batch draws the numbers a single device draws for those rows, and
every rank's generator stays in step. Scalar draws are made as they are.
"""

from __future__ import annotations

import contextlib
import contextvars
import hashlib
from typing import Optional, Sequence, Union

import torch

_SHARD: contextvars.ContextVar = contextvars.ContextVar("batch_shard", default=None)


@contextlib.contextmanager
def batch_shard(index: int, count: int):
    """Draw for a batch of ``count`` shards and keep shard ``index``'s rows (see the module's doc)."""
    token = _SHARD.set((index, count))
    try:
        yield
    finally:
        _SHARD.reset(token)


def _draw(fn, shape: Sequence[int], generator: Optional[torch.Generator], device, dtype=None) -> torch.Tensor:
    shard = _SHARD.get()
    if shard is None or len(shape) == 0:
        return fn(tuple(shape), generator=generator, device=device, dtype=dtype)
    index, count = shard
    rows = shape[0]
    full = fn((rows * count, *shape[1:]), generator=generator, device=device, dtype=dtype)
    return full[index * rows:(index + 1) * rows]


def uniform(shape: Sequence[int], generator: Optional[torch.Generator], device) -> torch.Tensor:
    """U[0, 1) float32 of ``shape``, ``torch.rand``'s draw (batch-sharded)."""
    return _draw(torch.rand, shape, generator, device)


def normal(shape: Sequence[int], generator: Optional[torch.Generator], device, dtype=None) -> torch.Tensor:
    """N(0, 1) of ``shape``, ``torch.randn``'s draw (batch-sharded)."""
    return _draw(torch.randn, shape, generator, device, dtype)


def fold_in(generator: torch.Generator, index: int) -> torch.Generator:
    """A generator of its own for ``index`` (a data-parallel rank), on
    ``generator``'s device: seeded from ``generator``'s state and ``index``,
    after which ``generator`` advances by one draw, so that each call gives
    new streams. The counterpart of ``jax.random.fold_in``; no device sync."""
    state = generator.get_state()
    uniform((), generator, generator.device)
    digest = hashlib.sha256(state.numpy().tobytes() + int(index).to_bytes(8, "little")).digest()
    return torch.Generator(device=generator.device).manual_seed(int.from_bytes(digest[:8], "little") >> 1)


def _bernoulli(p: float, like: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Boolean tensor shaped as ``like``, true with probability ``p``."""
    return uniform(like.shape, generator, like.device) < p


def reparameterize(mean: torch.Tensor, log_var: torch.Tensor, generator: Optional[torch.Generator] = None,
                   eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """z = mean + exp(0.5 * log_var) * eps, eps ~ N(0, I) drawn from
    ``generator`` unless given."""
    if eps is None:
        eps = normal(mean.shape, generator, mean.device, mean.dtype)
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
