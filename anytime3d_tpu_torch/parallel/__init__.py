"""Data and tensor parallelism: the ("data", "model") mesh of one device a
process, each rank's part of the batch, the collectives of the parallel
steps, and the tensor-parallel rules and layers.

Counterpart of ``anytime3d_tpu/parallel``. The JAX package shards the batch
and the parameters of one program over a device mesh; here a run over N
devices is N processes joined by ``torch.distributed`` (NCCL on CUDA, gloo
on the CPU), each holding its rows of the global batch over "data" and, over
"model", its slice of the output channels of every kernel the rules shard
(``parallel/tensor.py``: the shards and their collectives are explicit).
"""

from anytime3d_tpu_torch.parallel.mesh import (
    DEFAULT_RULES,
    all_gather_rows,
    all_reduce_grads,
    all_reduce_sum,
    batch_sharding,
    data_rank_and_size,
    gather_params,
    global_mean,
    make_mesh,
    mesh_device,
    model_rank_and_size,
    param_sharding_rules,
    rank_share,
    reduce_metrics,
    replicated,
    shard_batch,
    shard_params,
    tp_coverage,
)
from anytime3d_tpu_torch.parallel.multihost import host_local_batch_slice, initialize, make_global_batch
from anytime3d_tpu_torch.parallel.tensor import copy_to_model, gather_from_model, parallelize

__all__ = [
    "make_mesh",
    "batch_sharding",
    "replicated",
    "shard_batch",
    "mesh_device",
    "data_rank_and_size",
    "model_rank_and_size",
    "all_reduce_sum",
    "all_gather_rows",
    "all_reduce_grads",
    "global_mean",
    "reduce_metrics",
    "rank_share",
    "DEFAULT_RULES",
    "param_sharding_rules",
    "tp_coverage",
    "shard_params",
    "gather_params",
    "copy_to_model",
    "gather_from_model",
    "parallelize",
    "initialize",
    "host_local_batch_slice",
    "make_global_batch",
]
