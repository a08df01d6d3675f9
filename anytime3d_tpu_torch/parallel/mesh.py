"""The device mesh of a data-parallel run and its collectives.

Counterpart of ``anytime3d_tpu/parallel/mesh.py``. ``make_mesh`` returns a
``torch.distributed.device_mesh.DeviceMesh`` with the dims ("data",
"model"), one device a process. Only data parallelism is ported: the
"model" dim must be 1, since the JAX package's tensor-parallel rules are
left out of the port. Parameters are replicated (every rank holds the whole
model, ``replicated``); the batch is split over "data" (``shard_batch``,
this rank's rows of a global batch).

The helpers below take the mesh or None (one device, no collective):
``data_rank_and_size``, ``all_reduce_sum``, ``all_gather_rows`` (with
gradients where asked, through ``torch.distributed.nn.functional``),
``all_reduce_grads`` (the gradients flattened into one buffer of the
reduction's dtype, summed, upcast to float32 and only then averaged where
asked), ``reduce_metrics``, ``global_mean`` and ``rank_share``.
"""

from __future__ import annotations

import functools
import warnings
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
    ``device`` is this rank's device type (CUDA by default); the same
    arguments give the same mesh."""
    if model != 1:
        raise ValueError(f"a 'model' axis of {model}: tensor parallelism is not in the port, "
                         "whose mesh is data-parallel only (model=1)")
    _, world = initialize(device=device)
    data = world if data is None else data
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


def all_gather_rows(x: torch.Tensor, mesh, grad: bool = False) -> torch.Tensor:
    """Every rank's ``x`` stacked along the leading axis in rank order. With
    ``grad`` the gather carries gradients back to each rank's own rows."""
    if mesh is None or data_rank_and_size(mesh)[1] == 1:  # a gather of one: x itself
        return x
    group = mesh.get_group("data")
    if grad:
        from torch.distributed.nn import functional as dist_nn

        with warnings.catch_warnings():  # deprecated in favour of a functional form without this backward on gloo
            warnings.simplefilter("ignore", FutureWarning)
            return torch.cat(dist_nn.all_gather(x, group=group), dim=0)
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=0)


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
