"""The device mesh of a parallel run, its collectives and the tensor-parallel
rules.

Counterpart of ``anytime3d_tpu/parallel/mesh.py``. ``make_mesh`` returns a
``torch.distributed.device_mesh.DeviceMesh`` with the dims ("data",
"model"), one device a process, "model" innermost (as ``mesh_utils`` lays
it out): rank = data index * model + model index. The batch is split over
"data" (``shard_batch``, this rank's rows of a global batch); every rank of
one data index holds the same rows.

Tensor parallelism (TP) over "model": ``DEFAULT_RULES`` are the JAX
package's rules on the port's parameter names. Each sharded kernel is split
along its output channels (the axis of that leaf in the port's layout, see
``convert.py``); every other leaf, the biases and norm scales among them, is
replicated. ``param_sharding_rules`` gives each leaf's placement,
``tp_coverage`` the share of parameters sharded, ``shard_params`` this
rank's slice of each sharded leaf and ``gather_params`` the whole state dict
back. ``parallel/tensor.py`` runs a model on those shards.

The helpers below take the mesh or None (one device, no collective):
``data_rank_and_size``, ``model_rank_and_size``, ``all_reduce_sum``,
``all_gather_rows`` (with gradients where asked), ``all_reduce_grads`` (the gradients
flattened into one buffer of the reduction's dtype, summed over "data",
upcast to float32 and only then averaged where asked), ``reduce_metrics``,
``global_mean`` and ``rank_share``.
"""

from __future__ import annotations

import functools
import re
from typing import Dict, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from anytime3d_tpu_torch.parallel.multihost import _device_of, initialize, make_global_batch


@functools.lru_cache(maxsize=None)
def _mesh(device_type: str, data: int, model: int):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (data, model), mesh_dim_names=("data", "model"))


def make_mesh(data: Optional[int] = None, model: int = 1, device=None):
    """The ("data", "model") mesh over every rank of the run, joining the
    process group first where it is not joined (``multihost.initialize``).
    ``device`` is this rank's device type (CUDA by default); ``data``
    defaults to every rank over ``model``. The same arguments give the same
    mesh."""
    _, world = initialize(device=device)
    data = world // model if data is None else data
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} != {world} ranks")
    return _mesh(_device_of(device).type, data, model)


def mesh_device(mesh) -> torch.device:
    """This rank's device in ``mesh``."""
    return _device_of(mesh.device_type)


def data_rank_and_size(mesh) -> Tuple[int, int]:
    """(this rank's index, the number of ranks) along "data"; (0, 1) without a mesh."""
    if mesh is None:
        return 0, 1
    return mesh.get_local_rank("data"), mesh.size(mesh.mesh_dim_names.index("data"))


def model_rank_and_size(mesh) -> Tuple[int, int]:
    """(this rank's index, the number of ranks) along "model"; (0, 1) without a mesh."""
    if mesh is None:
        return 0, 1
    return mesh.get_local_rank("model"), mesh.size(mesh.mesh_dim_names.index("model"))


def batch_sharding(mesh) -> Tuple[int, int]:
    """How a batch splits over ``mesh``: (this rank's shard, the number of shards) of the leading axis."""
    return data_rank_and_size(mesh)


def replicated(mesh) -> torch.device:
    """Where a replicated tensor lives: every rank holds a whole copy on its own device."""
    return mesh_device(mesh)


def shard_batch(batch: Mapping, mesh) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global host batch, on this rank's device."""
    from anytime3d_tpu_torch.data.prefetch import to_device

    return to_device(make_global_batch(batch, mesh), mesh_device(mesh))


def all_reduce_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``x`` over the "data" ranks (a new tensor; ``x`` itself without a mesh)."""
    if mesh is None:
        return x
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.get_group("data"))
    return out


def gather_along(t: torch.Tensor, axis: int, group) -> torch.Tensor:
    """The slices ``t`` of one tensor that the ranks of ``group`` hold,
    joined along ``axis`` in rank order: this rank's slice placed in a
    zero-filled whole and summed over ``group`` by one all-reduce. Exact (x + 0 = x), and it runs on NCCL,
    on gloo on the CPU and on gloo on CUDA tensors, for which gloo has only
    broadcast and all-reduce."""
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    axis = axis % t.dim()
    n = t.shape[axis]
    whole = t.new_zeros(*t.shape[:axis], n * size, *t.shape[axis + 1:])
    whole.narrow(axis, rank * n, n).copy_(t)
    dist.all_reduce(whole, group=group)
    return whole


class _GatherRows(torch.autograd.Function):
    """``gather_along`` the leading axis, with the gradient of a sum of the
    ranks' losses: every rank's gradient of the whole, summed, at this
    rank's rows."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group, ctx.start, ctx.rows = group, dist.get_rank(group) * x.shape[0], x.shape[0]
        return gather_along(x.contiguous(), 0, group)

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        dy = dy.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(dy, group=ctx.group)
        return dy.narrow(0, ctx.start, ctx.rows), None


def all_gather_rows(x: torch.Tensor, mesh, grad: bool = False) -> torch.Tensor:
    """Every "data" rank's ``x`` stacked along the leading axis in rank
    order (``gather_along``, so on any backend and any mesh). With ``grad``
    the gather carries gradients back to each rank's own rows."""
    if mesh is None or data_rank_and_size(mesh)[1] == 1:  # a gather of one: x itself
        return x
    group = mesh.get_group("data")
    if grad:
        return _GatherRows.apply(x, group)
    return gather_along(x.contiguous(), 0, group)


def all_reduce_grads(grads: Mapping[str, torch.Tensor], mesh, dtype: torch.dtype = torch.float32,
                     average: bool = False) -> Dict[str, torch.Tensor]:
    """The gradients summed over the "data" ranks in ``dtype``: every leaf
    cast into one flat buffer, one all-reduce (SUM), the buffer upcast to
    float32 and, with ``average``, divided by the number of ranks after the
    upcast. Leaves come back float32 in their shapes."""
    names = list(grads)
    flat = torch.cat([grads[n].reshape(-1).to(dtype) for n in names])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.get_group("data"))
    flat = flat.float()
    if average:
        flat = flat / data_rank_and_size(mesh)[1]
    out: List[torch.Tensor] = list(torch.split(flat, [grads[n].numel() for n in names]))
    return {n: t.view(grads[n].shape) for n, t in zip(names, out)}


def rank_share(x: torch.Tensor, mesh) -> torch.Tensor:
    """A term that every rank computes whole (a penalty on the replicated
    parameters) divided by the number of ranks, so that the ranks' sum counts
    it once; ``x`` itself without a mesh."""
    return x if mesh is None else x / data_rank_and_size(mesh)[1]


def global_mean(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's share of the mean over the global batch: the mean of its
    equal shard divided by the number of ranks, which the ranks' sum (of the
    values, or of their gradients) turns into the global mean. Without a
    mesh, the mean."""
    if mesh is None:
        return x.mean()
    return x.mean() / data_rank_and_size(mesh)[1]


def reduce_metrics(metrics: Mapping[str, torch.Tensor], mesh, average: bool = False) -> Dict[str, torch.Tensor]:
    """Scalar metrics summed over the "data" ranks in float32 by one
    all-reduce (divided by the number of ranks with ``average``); as they
    are without a mesh."""
    if mesh is None or not metrics:
        return dict(metrics)
    names = list(metrics)
    flat = all_reduce_sum(torch.stack([metrics[n].float() for n in names]), mesh)
    if average:
        flat = flat / data_rank_and_size(mesh)[1]
    return dict(zip(names, flat.unbind()))


# --------------------------------------------------------------------- TP rules

# (name pattern, rank of the kernel): the JAX package's DEFAULT_RULES on the
# port's names (flax ``Class_i`` is ``class_i``, '/' is '.', ``kernel`` is
# ``weight``), searched in order; a leaf takes the first rule whose pattern it
# contains, whose rank it has and whose output channels divide by the size of
# "model". Only the channel-heavy kernels shard; everything else replicates.
# The final stage's bare decoder ``convtranspose(equiv3d)_0`` stays out of
# the rules by design: its output is the voxel channel (1).
DEFAULT_RULES: Tuple[Tuple[str, int], ...] = (
    (r"decoder\.denseblock_0\.dense_0\.weight", 2),
    # the classic middle stages' transposed convs and their phase-equivalent lowering
    (r"decoder\.deconv\w*block3d_\d+\.convtranspose\w*\.weight", 5),
    # the blocked tail's k=2 convs (and mid_blocked's middle ones, the pixel-shuffle conv)
    (r"decoder\.conv_\d+\.weight", 5),
    # the voxel encoder's stages and its final conv
    (r"encoder3d\..*conv.*\.weight", 5),
    # the image backbones' and heads' 2-D convs
    (r"backbone\..*conv.*\.weight", 4),
    (r"head\..*conv.*\.weight", 4),
)


def output_axis(name: str, shape) -> Optional[int]:
    """The output-channel axis of a kernel leaf in the port's layout
    (``convert.py``), or None for a leaf that is no conv or dense kernel:
    ``conv_k2``'s (2, 2, 2, C, N) 4; ``Conv3d``'s OIDHW and ``Conv2d``'s
    OIHW 0; the transposed convs' (Cin, Cout, k, k, k) 1; ``Dense``'s (out,
    in) 0."""
    *_, module, leaf = ("." + name).split(".")
    kind = module.rsplit("_", 1)[0]
    if leaf != "weight" or len(shape) < 2:
        return None
    if kind.startswith("convtranspose"):
        return 1
    if kind == "conv":
        return 4 if len(shape) == 5 and tuple(shape[:3]) == (2, 2, 2) else 0
    return 0 if kind == "dense" else None


def _model_size(mesh) -> int:
    return mesh if isinstance(mesh, int) else model_rank_and_size(mesh)[1]


def param_sharding_rules(params: Mapping[str, torch.Tensor], mesh,
                         rules=DEFAULT_RULES) -> Dict[str, Optional[int]]:
    """Each leaf's placement: the axis it is sharded along over "model", or
    None where it is replicated. ``params`` maps names to the whole tensors
    (anything with a ``shape``); ``mesh`` is the mesh or the size of its
    "model" axis."""
    size = _model_size(mesh)
    out: Dict[str, Optional[int]] = {}
    for name, leaf in params.items():
        shape, axis = tuple(leaf.shape), output_axis(name, leaf.shape)
        out[name] = None
        if axis is None:
            continue
        for pattern, rank in rules:
            if re.search(pattern, name) and rank == len(shape) and shape[axis] % size == 0:
                out[name] = axis
                break
    return out


def tp_coverage(params: Mapping[str, torch.Tensor], mesh, rules=DEFAULT_RULES) -> float:
    """Share of the parameter count that the rules shard over "model" (the
    rest replicates): the JAX package's ``tp_coverage``."""
    placements = param_sharding_rules(params, mesh, rules)
    total = sharded = 0
    for name, leaf in params.items():
        n = int(torch.Size(leaf.shape).numel())
        total += n
        sharded += n if placements[name] is not None else 0
    return sharded / max(total, 1)


def shard_params(params: Mapping[str, torch.Tensor], mesh, rules=DEFAULT_RULES) -> Dict[str, torch.Tensor]:
    """This rank's leaves of the whole ``params``: its slice of the output
    channels of each sharded leaf (model rank r of m holds the r-th of m
    equal parts), the rest as they are."""
    rank, size = model_rank_and_size(mesh)
    out = {}
    for name, axis in param_sharding_rules(params, size, rules).items():
        t = params[name]
        if axis is not None:
            n = t.shape[axis] // size
            t = t.narrow(axis, rank * n, n).contiguous()
        out[name] = t
    return out


def gather_params(model, mesh) -> Dict[str, torch.Tensor]:
    """The whole state dict of a tensor-parallel ``model``: every sharded
    parameter (those that ``parallel.tensor.parallelize`` marked with
    ``model_axis``) gathered over "model", every other tensor as it is, all
    detached. JAX's global arrays give this by ``np.asarray``."""
    group = mesh.get_group("model") if model_rank_and_size(mesh)[1] > 1 else None
    out = {}
    for name, t in model.state_dict(keep_vars=True).items():
        axis = getattr(t, "model_axis", None)
        t = t.detach()
        out[name] = t if axis is None or group is None else gather_along(t, axis, group)
    return out
