"""Joining the ranks of a parallel run, and each rank's part of a batch.

Counterpart of ``anytime3d_tpu/parallel/multihost.py``. A run over several
devices is one process a device, the same program in each: ``initialize``
joins them through ``torch.distributed`` from the environment variables the
JAX package reads (``COORDINATOR_ADDRESS`` host:port, ``NUM_PROCESSES``,
``PROCESS_ID``). Without them the run is one rank on a local store. The
backend is NCCL for a CUDA device and gloo for the CPU unless the caller
names one (``backend="gloo"`` on CUDA tensors: NCCL refuses two ranks on one
card, as a tensor-parallel run on a single card has them); where NCCL cannot
start, ``initialize`` raises, and never falls back to gloo or to the CPU.

Every rank builds the same global batch from the same seed and keeps its
contiguous slice of the rows (``host_local_batch_slice``,
``make_global_batch``).
"""

from __future__ import annotations

import os
from typing import Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist


def _device_of(device) -> torch.device:
    device = torch.device(device if device is not None else "cuda")
    if device.type == "cuda" and device.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA parallel run needs CUDA, which is not available")
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device=None, backend: Optional[str] = None) -> Tuple[int, int]:
    """Join the process group, once; returns (rank, world size).

    Arguments default to ``COORDINATOR_ADDRESS``, ``NUM_PROCESSES`` and
    ``PROCESS_ID``; with no address the run is one rank on an in-process
    store. ``backend`` defaults to NCCL on CUDA and gloo on the CPU; gloo
    on CUDA only where it is asked for by name. On CUDA each rank takes
    device ``rank % device_count`` and the group is checked by one
    all-reduce there, so that an NCCL that cannot start raises here."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    device = torch.device(device if device is not None else "cuda")
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    address = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if address:
        world = num_processes or int(os.environ["NUM_PROCESSES"])
        rank = process_id if process_id is not None else int(os.environ["PROCESS_ID"])
    else:
        world, rank = 1, 0
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA parallel run needs CUDA, which is not available")
        torch.cuda.set_device(device.index if device.index is not None else rank % torch.cuda.device_count())
    if address:
        dist.init_process_group(backend, init_method=f"tcp://{address}", world_size=world, rank=rank)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0)
    probe = torch.ones(1, device=_device_of(device))
    dist.all_reduce(probe)
    if int(probe.item()) != world:
        raise RuntimeError(f"the process group's all-reduce gave {probe.item()}, not {world}")
    return rank, world


def host_local_batch_slice(global_batch: int) -> Tuple[int, int]:
    """(start, size) of this rank's rows of a global batch, which must divide evenly."""
    rank, world = (dist.get_rank(), dist.get_world_size()) if dist.is_initialized() else (0, 1)
    if global_batch % world:
        raise ValueError(f"global batch {global_batch} does not split over {world} ranks")
    per = global_batch // world
    return rank * per, per


def make_global_batch(batch: Mapping, mesh=None) -> dict:
    """This rank's rows of every leaf of a global host batch (numpy arrays or
    tensors with the batch first): the rank's part of the global batch,
    which the ranks together hold. Nothing moves to the device."""
    from anytime3d_tpu_torch.parallel.mesh import data_rank_and_size

    rank, n = data_rank_and_size(mesh) if mesh is not None else ((dist.get_rank(), dist.get_world_size())
                                                                 if dist.is_initialized() else (0, 1))
    out = {}
    for k, v in batch.items():
        rows = np.shape(v)[0]
        if rows % n:
            raise ValueError(f"batch leaf {k!r} of {rows} rows does not split over {n} ranks")
        per = rows // n
        out[k] = v[rank * per:(rank + 1) * per]
    return out
