"""Train state: the module (float32 parameters), its Adam optimizer and the
step count.

Counterpart of ``anytime3d_tpu/train/state.py``. The JAX state is an
immutable tree that every step replaces; here the module and the optimizer
are updated in place and the same ``TrainState`` object is handed on.
``create_train_state(..., flat_opt=True)`` takes :class:`FlatAdam`, the JAX
package's ``flat_adam``: the same update over one contiguous buffer. Under
tensor parallelism (``parallel.tensor.parallelize``) a sharded parameter is
this rank's slice, so Adam holds moments of the slice's size.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import torch
import torch.distributed as dist
import torch.nn as nn

from anytime3d_tpu_torch.parallel.mesh import model_rank_and_size


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
        if isinstance(self.optimizer, FlatAdam):
            self.optimizer.load_grads([grads[name] for name, _ in self.model.named_parameters()])
            self.optimizer.step()
        else:
            for name, p in self.model.named_parameters():
                p.grad = grads[name]
            self.optimizer.step()
            self.optimizer.zero_grad(set_to_none=True)
        self.step += 1
        return self


class FlatAdam(torch.optim.Optimizer):
    """Adam over one contiguous float32 buffer: the JAX package's
    ``flat_adam``, the same update as ``optax.adam`` (b1 0.9, b2 0.999, eps
    1e-8 added to the root of the bias-corrected second moment), only the
    rounding at the boundaries differing.

    The module's parameters become views into one flat buffer, their
    gradients views into a second (``load_grads`` copies a step's gradients
    in with one ``cat``), and each moment is one buffer of the same length:
    the update is four passes over flat buffers whatever the number of
    leaves. The flat buffer is the optimizer's one parameter, so
    ``state_dict`` and ``load_state_dict`` (the checkpoints) work as for
    ``torch.optim.Adam``. The module must not be moved or re-cast after:
    its parameters would stop being views."""

    def __init__(self, params, lr: float = 1e-4, betas: tuple[float, float] = (0.9, 0.999), eps: float = 1e-8):
        self.views = list(params)
        if not self.views or any(p.dtype != torch.float32 for p in self.views):
            raise ValueError("FlatAdam takes a non-empty list of float32 parameters")
        device = self.views[0].device
        total = sum(p.numel() for p in self.views)
        flat = torch.empty(total, dtype=torch.float32, device=device)
        self.flat_grad = torch.zeros_like(flat)
        offset = 0
        with torch.no_grad():
            for p in self.views:
                n = p.numel()
                flat[offset:offset + n].copy_(p.reshape(-1))
                p.data = flat[offset:offset + n].view_as(p)
                p.grad = self.flat_grad[offset:offset + n].view_as(p)
                offset += n
        self.flat = flat
        super().__init__([flat], dict(lr=lr, betas=betas, eps=eps))

    def load_grads(self, grads) -> None:
        """Copy a step's gradients, in the order of the parameters, into the flat gradient buffer."""
        torch.cat([g.reshape(-1) for g in grads], out=self.flat_grad)

    @torch.no_grad()
    def step(self, closure=None):
        group = self.param_groups[0]
        flat = group["params"][0]
        b1, b2 = group["betas"]
        state = self.state[flat]
        if not state:  # fresh, or reset by graft_submodule
            state["step"] = 0
            state["exp_avg"] = torch.zeros_like(flat)
            state["exp_avg_sq"] = torch.zeros_like(flat)
        state["step"] += 1
        count = state["step"]
        m, v, g = state["exp_avg"], state["exp_avg_sq"], self.flat_grad
        m.mul_(b1).add_(g, alpha=1.0 - b1)
        v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
        # -lr * m_hat / (sqrt(v_hat) + eps), m_hat = m / (1 - b1^t), v_hat = v / (1 - b2^t)
        denom = (v / (1.0 - b2**count)).sqrt_().add_(group["eps"])
        flat.addcdiv_(m / (1.0 - b1**count), denom, value=-group["lr"])
        return None


def create_train_state(model: nn.Module, learning_rate: float = 1e-4, flat_opt: bool = False) -> TrainState:
    """Adam as ``optax.adam(learning_rate)``: b1 0.9, b2 0.999, eps 1e-8 added
    to the root of the bias-corrected second moment, no weight decay;
    ``flat_opt``: the same update over one flat buffer (:class:`FlatAdam`,
    the JAX package's ``flat_adam``), the parameters then views into it. The
    model's parameters must be float32 (the optimizer updates them as they
    are); pick a lower compute dtype with the model's ``dtype`` argument."""
    low = [n for n, p in model.named_parameters() if p.dtype != torch.float32]
    if low:
        raise ValueError(f"training needs float32 parameters; {low[0]} (and {len(low) - 1} more) are not")
    if flat_opt:
        opt = FlatAdam(model.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    else:
        opt = torch.optim.Adam(model.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    return TrainState(model=model, optimizer=opt, step=0)


def grads_finite_flag(grads: Mapping[str, torch.Tensor], mesh=None) -> torch.Tensor:
    """1.0 iff every gradient leaf is finite, as a float32 scalar on the
    gradients' device (no host sync). An exact per-leaf ``isfinite`` test: a
    sum of squares could overflow on a large but finite gradient. With a
    ``mesh`` that has a "model" axis the flag is the least over the model
    ranks, whose sharded leaves differ: a non-finite slice on one rank zeroes
    every rank's update, as the JAX flag over the global leaves does."""
    flags = torch.stack([torch.isfinite(g).all() for g in grads.values()])
    flag = flags.all().float()
    if model_rank_and_size(mesh)[1] > 1:
        bad = 1.0 - flag  # summed: every backend has SUM on every device
        dist.all_reduce(bad, group=mesh.get_group("model"))
        flag = (bad == 0).float()
    return flag


def l2_penalty(params: Mapping[str, torch.Tensor], weight: float = 5e-4) -> torch.Tensor:
    """Kernel L2 regularisation, ``weight * sum w^2`` over the conv and dense
    kernels; norm scales and every bias are exempt (the flax leaves named
    ``kernel`` are the port's ``weight`` tensors of more than one axis). A
    tensor-parallel kernel (marked ``model_group`` by ``parallelize``) is this
    rank's slice: its squares count summed over the model ranks, whose other
    slices enter as a constant, so that the gradient is this slice's own; a
    replicated kernel counts once."""
    kernels = [p for name, p in params.items() if name.endswith(".weight") and p.dim() > 1]
    total = sum(torch.sum(torch.square(p)) for p in kernels)
    shards = [p for p in kernels if getattr(p, "model_group", None) is not None]
    if shards:
        own = sum(torch.sum(torch.square(p.detach())) for p in shards)
        every = own.clone()
        dist.all_reduce(every, group=shards[0].model_group)
        total = total + (every - own)
    return weight * total
