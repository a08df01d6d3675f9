"""Train state: the module (float32 parameters), its Adam optimizer and the
step count.

Counterpart of ``anytime3d_tpu/train/state.py``. The JAX state is an
immutable tree that every step replaces; here the module and the optimizer
are updated in place and the same ``TrainState`` object is handed on. The
flat-buffer Adam of the JAX package (a measured negative there) is not
ported.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import torch
import torch.nn as nn


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """The parameters by ``state_dict`` name."""
        return dict(self.model.named_parameters())

    def apply_gradients(self, grads: Mapping[str, torch.Tensor]) -> "TrainState":
        """One optimizer update from ``grads`` (keyed as ``params``), in place;
        the step count advances."""
        for name, p in self.model.named_parameters():
            p.grad = grads[name]
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1
        return self


def create_train_state(model: nn.Module, learning_rate: float = 1e-4) -> TrainState:
    """Adam as ``optax.adam(learning_rate)``: b1 0.9, b2 0.999, eps 1e-8 added
    to the root of the bias-corrected second moment, no weight decay. The
    model's parameters must be float32 (the optimizer updates them as they
    are); pick a lower compute dtype with the model's ``dtype`` argument."""
    low = [n for n, p in model.named_parameters() if p.dtype != torch.float32]
    if low:
        raise ValueError(f"training needs float32 parameters; {low[0]} (and {len(low) - 1} more) are not")
    opt = torch.optim.Adam(model.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    return TrainState(model=model, optimizer=opt, step=0)


def grads_finite_flag(grads: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """1.0 iff every gradient leaf is finite, as a float32 scalar on the
    gradients' device (no host sync). An exact per-leaf ``isfinite`` test: a
    sum of squares could overflow on a large but finite gradient."""
    flags = torch.stack([torch.isfinite(g).all() for g in grads.values()])
    return flags.all().float()


def l2_penalty(params: Mapping[str, torch.Tensor], weight: float = 5e-4) -> torch.Tensor:
    """Kernel L2 regularisation, ``weight * sum w^2`` over the conv and dense
    kernels; norm scales and every bias are exempt (the flax leaves named
    ``kernel`` are the port's ``weight`` tensors of more than one axis)."""
    kernels = [p for name, p in params.items() if name.endswith(".weight") and p.dim() > 1]
    return weight * sum(torch.sum(torch.square(p)) for p in kernels)
