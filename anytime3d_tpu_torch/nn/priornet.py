"""Prior network: one-hot label -> Gaussian latent prior (mean, log_var).

Counterpart of ``anytime3d_tpu/nn/priornet.py``: a tower of
Dense + LayerNorm + Dropout + activation layers over ``2*onehot - 1`` and a
linear last layer gives the mean; ``const_log_var`` pins the log-variance, or
with ``const_log_var=None`` a second tower of the same shape learns it.
Dropout follows the module's train/eval mode (flax's ``deterministic``) and
draws from the ``torch.Generator`` it is handed: the mean tower's masks
first, then the log-var tower's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn

from anytime3d_tpu_torch.nn.blocks import activation, dense, layer_norm
from anytime3d_tpu_torch.ops.sampling import uniform


@dataclasses.dataclass(frozen=True)
class PriorNetConfig:
    input_dim: int = 40
    unit_nums: Tuple[int, ...] = (64, 32, 16)  # last entry is the latent dim
    act: str = "elu"
    const_log_var: Optional[float] = 0.0
    dropout_rate: float = 0.2


class _Tower(nn.Module):
    def __init__(self, input_dim: int, unit_nums: Tuple[int, ...], act: str, dropout_rate: float,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.depth = len(unit_nums)
        widths = (input_dim, *unit_nums)
        for i in range(self.depth):
            self.add_module(f"dense_{i}", dense(widths[i], widths[i + 1], generator))
            if i < self.depth - 1:
                self.add_module(f"layernorm_{i}", layer_norm(widths[i + 1]))
        self.dropout_rate = dropout_rate
        self.act = activation(act)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for i in range(self.depth - 1):
            x = getattr(self, f"layernorm_{i}")(getattr(self, f"dense_{i}")(x))
            if self.training and self.dropout_rate > 0.0:
                keep = uniform(x.shape, generator, x.device) >= self.dropout_rate
                x = torch.where(keep, x / (1.0 - self.dropout_rate), torch.zeros_like(x))
            x = self.act(x)
        return getattr(self, f"dense_{self.depth - 1}")(x)


class PriorNet(nn.Module):
    """One-hot label (B, input_dim) -> (mean, log_var), each (B, unit_nums[-1])."""

    def __init__(self, config: PriorNetConfig, generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype  # compute dtype; None: that of the input
        self.config = config
        self.mean_tower = _Tower(config.input_dim, config.unit_nums, config.act,
                                 config.dropout_rate, generator)
        self.log_var_tower = (_Tower(config.input_dim, config.unit_nums, config.act, config.dropout_rate, generator)
                              if config.const_log_var is None else None)

    def forward(self, onehot: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> tuple[torch.Tensor, torch.Tensor]:
        """``generator`` feeds the dropout masks in train mode."""
        onehot = onehot.to(self.dtype or onehot.dtype)
        x = 2.0 * onehot - 1.0
        mean = self.mean_tower(x, generator)
        if self.log_var_tower is not None:
            return mean, self.log_var_tower(x, generator)
        return mean, torch.full_like(mean, self.config.const_log_var)
