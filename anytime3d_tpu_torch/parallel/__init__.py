"""Data parallelism: the mesh of one device a process, each rank's part of
the batch, and the collectives of the data-parallel steps.

Counterpart of ``anytime3d_tpu/parallel``. The JAX package shards the batch
of one program over a device mesh; here a run over N devices is N
processes joined by ``torch.distributed`` (NCCL on CUDA, gloo on the CPU),
each holding the whole model and its rows of the global batch. The tensor
parallel rules of the JAX mesh are not ported.
"""

from anytime3d_tpu_torch.parallel.mesh import (
    all_gather_rows,
    all_reduce_grads,
    all_reduce_sum,
    batch_sharding,
    data_rank_and_size,
    global_mean,
    make_mesh,
    mesh_device,
    rank_share,
    reduce_metrics,
    replicated,
    shard_batch,
)
from anytime3d_tpu_torch.parallel.multihost import host_local_batch_slice, initialize, make_global_batch

__all__ = [
    "make_mesh",
    "batch_sharding",
    "replicated",
    "shard_batch",
    "mesh_device",
    "data_rank_and_size",
    "all_reduce_sum",
    "all_gather_rows",
    "all_reduce_grads",
    "global_mean",
    "reduce_metrics",
    "rank_share",
    "initialize",
    "host_local_batch_slice",
    "make_global_batch",
]
