"""Tensor parallelism over the "model" axis of a ("data", "model") mesh.

Counterpart of the JAX package's tensor parallelism, where ``jit`` with the
``NamedSharding``s of ``DEFAULT_RULES`` lets GSPMD partition each sharded
kernel and insert the collectives. Here the shards and the collectives are
explicit, one process a device, column parallel:

- each model rank holds its slice of the output channels of every kernel
  the rules shard (``parallel.mesh.shard_params``), marked with the axis
  (``model_axis``) and the group (``model_group``) it is sharded over;
- a sharded layer reads its whole input through ``copy_to_model``, whose
  forward is the identity and whose backward sums dx over the model group
  (each rank's dx is the part of the sum that its output channels make);
- it computes its slice of the output, and ``gather_from_model`` joins the
  slices along the channel (last) axis, as the layer returns its output
  channels-last (``ConvTransposeEquiv3D``'s after its depth-to-space). The
  forward is ``mesh.gather_along``: the rank's slice placed in a zero-filled
  whole and all-reduced, which is exact and runs on NCCL, gloo on the CPU
  and gloo on CUDA tensors. The backward is the rank's own slice of dy, with
  no communication: every model rank computes the same whole dy
  downstream. (``torch.distributed.nn.functional.all_gather`` sums dy over
  the ranks in its backward, which would double every sharded gradient.)

Everything between the sharded layers (norms, activations, the losses, the
replicated layers) runs on every model rank on the same values, so every
replicated gradient is the same on each. ``parallelize`` applies this to a
model in place; the train steps (``train/step.py``) then all-reduce the
gradients over "data" only and take the finite flag and the kernel L2 over
"model" too (``train/state.py``).
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from anytime3d_tpu_torch.nn.blocks import Conv2d, Conv3d, ConvK2, ConvTranspose3d, ConvTransposeEquiv3D, Dense
from anytime3d_tpu_torch.parallel.mesh import (
    DEFAULT_RULES,
    gather_along,
    model_rank_and_size,
    param_sharding_rules,
    shard_params,
)

# The layers the rules shard, with the output-channel axis of their weight.
COLUMN_AXIS = {Dense: 0, ConvK2: 4, Conv3d: 0, ConvTranspose3d: 1, ConvTransposeEquiv3D: 1, Conv2d: 0}


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        dx = dy.clone(memory_format=torch.contiguous_format)  # dy may be another node's gradient too
        dist.all_reduce(dx, group=ctx.group)
        return dx, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y: torch.Tensor, group) -> torch.Tensor:
        ctx.start, ctx.width = dist.get_rank(group) * y.shape[-1], y.shape[-1]
        return gather_along(y.contiguous(), -1, group)

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        return dy.narrow(-1, ctx.start, ctx.width).contiguous(), None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself; its gradient is summed over the model ``group``."""
    return _CopyToModel.apply(x, group)


def gather_from_model(y: torch.Tensor, group) -> torch.Tensor:
    """The model ranks' slices ``y`` joined along the last axis in rank order;
    the gradient is this rank's slice of the whole one."""
    return _GatherFromModel.apply(y, group)


class _ColumnParallel:
    """A layer whose weight holds this model rank's output channels: its
    whole input in, its whole output out (see the module's doc)."""

    model_group = None

    def forward(self, x: torch.Tensor, *args, **kwargs) -> torch.Tensor:
        if kwargs.get("phase_output"):
            raise ValueError("a column-parallel ConvTransposeEquiv3D gathers its output after the depth-to-space; "
                             "its phase tensor is not gathered")
        y = super().forward(copy_to_model(x, self.model_group), *args, **kwargs)
        return gather_from_model(y, self.model_group)


class _ColumnParallelDense(_ColumnParallel):
    """``Dense`` with its weight's rows sharded and its bias whole: the bias
    is added after the gather, so that it stays replicated."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(copy_to_model(x, self.model_group), self.weight.to(x.dtype))
        return gather_from_model(y, self.model_group) + self.bias.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _column_parallel(cls: type) -> type:
    mixin = _ColumnParallelDense if cls is Dense else _ColumnParallel
    return type(f"ColumnParallel{cls.__name__}", (mixin, cls), {})


def parallelize(model: nn.Module, mesh, rules=DEFAULT_RULES) -> nn.Module:
    """Shard ``model`` over ``mesh``'s "model" axis, in place, and return it.
    ``model`` holds the whole parameters (the same on every rank); each leaf
    that the rules shard becomes this rank's slice (a new ``Parameter``
    marked with ``model_axis`` and ``model_group``), and the layer that owns
    it gathers its output over the model ranks. Build the optimizer after.
    Without a model axis (one model rank) the model is returned unchanged."""
    size = model_rank_and_size(mesh)[1]
    if size == 1:
        return model
    group = mesh.get_group("model")
    layers = dict(model.named_modules())
    params = dict(model.named_parameters())
    shards = shard_params(params, mesh, rules)
    for name, axis in param_sharding_rules(params, size, rules).items():
        if axis is None:
            continue
        owner, leaf = name.rsplit(".", 1)
        layer = layers[owner]
        kind = type(layer)
        if COLUMN_AXIS.get(kind) != axis or leaf != "weight":
            raise ValueError(f"{name}: the rules shard axis {axis} of a {kind.__name__}, which is not a "
                             "column-parallel layer's weight")
        shard = nn.Parameter(shards[name].detach().clone(), requires_grad=params[name].requires_grad)
        shard.model_axis, shard.model_group = axis, group
        layer.weight = shard
        layer.__class__ = _column_parallel(kind)
        layer.model_group = group
    return model

