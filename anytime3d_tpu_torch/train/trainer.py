"""Training loop: prefetched batches from a host loader, periodic eval with
the anytime metrics, checkpoints, and NaN restarts from the last checkpoint.

Counterpart of ``anytime3d_tpu/train/trainer.py``. With ``prefetch_depth``
> 0 (the default, 2) a ``DevicePrefetcher`` makes the batches on a worker
thread and copies them to the device on a side stream, so batch making
overlaps the steps before; at 0 each batch is made between steps and copied
from pinned memory without blocking. Metrics are fetched (a device sync) on
the logging cadence. Each eval adds the anytime protocol's metrics
(``anytime_*``, at ``eval_missing_prob``) for models with a category prior.

Checkpoints and failures follow the JAX loop (``trainer.py:133-213``): a
``load_path`` is restored when the trainer is made; every ``save_every``
steps the state is saved to ``save_path`` without waiting for the write,
but only when the step's loss is finite and its gradients were
(``grads_finite``), so a NaN that falls between log ticks never reaches the
checkpoint; on a non-finite logged loss the run restores the last checkpoint
it saved while ``max_nan_restarts`` allows, reseeds its generator with
``step * 7919 + restarts`` and rewinds the batch stream to the restored step,
and aborts otherwise; a final save follows unless the run aborted. The
multi-scale image schedule changes the batch a loader makes, so it lives in
the batch function (``cli.train.build_batch_fn``), which walks
:func:`multi_scale_schedule`.

Spans (``utils/profiling.py``), one of which is open at every point of an
iteration but the loop's own lines: ``trainer.batch_wait`` (the
prefetcher's ``get``, or at depth 0 the batch made and copied in line),
``trainer.step`` (the ``step_fn`` call), ``trainer.fetch`` (the metrics'
``float``: the sync), ``trainer.log`` (logger, history, the NaN check and
restart), ``trainer.save``, ``trainer.eval``.

``use_mesh`` trains data-parallel over every rank of the run
(``parallel.make_mesh``, one process a device): every rank calls
``batch_fn`` for the same global batch and keeps its rows, and the default
steps (or the ``step_fn`` a caller builds with the same mesh) compute the
single-device step on the global batch, so every rank holds the same state
after each step. Rank 0 alone logs to ``jsonl_path`` and prints, and alone
writes the checkpoints, each of which every rank waits for at a barrier, so
that a restore reads a whole file.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from anytime3d_tpu_torch.anytime.engine import anytime_eval
from anytime3d_tpu_torch.data.prefetch import DevicePrefetcher, to_device
from anytime3d_tpu_torch.parallel import data_rank_and_size, make_global_batch, make_mesh, reduce_metrics
from anytime3d_tpu_torch.train.checkpoint import restore_state, save_state
from anytime3d_tpu_torch.train.state import TrainState
from anytime3d_tpu_torch.train.step import LossConfig, make_eval_step, make_train_step, sharded_draws
from anytime3d_tpu_torch.utils.logging import MetricLogger
from anytime3d_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 1000
    eval_every: int = 100
    save_every: int = 1000
    log_every: int = 1
    save_path: Optional[str] = None
    load_path: Optional[str] = None
    jsonl_path: Optional[str] = None
    eval_missing_prob: float = 0.5
    # batches made on a worker thread this many steps ahead; 0 makes each between steps
    prefetch_depth: int = 2
    # on a non-finite loss, restore the last checkpoint this many times before aborting
    max_nan_restarts: int = 0
    # data parallel over every rank of the run, the batch split over them
    use_mesh: bool = False


class Trainer:
    """Drives ``make_train_step`` over a host loader.

    ``batch_fn(step) -> dict of numpy arrays`` decouples the trainer from the
    loader; ``cli.train.build_batch_fn`` adapts the loaders. ``state`` holds
    the model, which lives on the device the trainer runs on. ``step_fn``
    (``step(state, batch, generator) -> (state, metrics)``) and ``eval_fn``
    (``eval(batch, generator) -> metrics``) replace the MultiModalVAE steps,
    so that the detector reuses this loop (prefetch, checkpoints, NaN
    restarts, logging) with its own losses; with a ``step_fn`` and no
    ``eval_fn`` there is no eval, and the anytime protocol runs for the
    default steps only, as in the JAX loop. Both are plain attributes: a
    caller may wrap them (to time a step, say) before ``run``."""

    def __init__(self, model, state: TrainState, batch_fn: Callable[[int], Mapping[str, np.ndarray]],
                 loss_config: LossConfig = LossConfig(),
                 eval_batch_fn: Optional[Callable[[int], Mapping[str, np.ndarray]]] = None,
                 config: TrainerConfig = TrainerConfig(), step_fn: Optional[Callable] = None,
                 eval_fn: Optional[Callable] = None):
        self.model = model
        self.state = state
        self.batch_fn = batch_fn
        self.eval_batch_fn = eval_batch_fn
        self.cfg = config
        self.loss_cfg = loss_config
        self.device = next(model.parameters()).device
        self.mesh = make_mesh(device=self.device) if config.use_mesh else None
        self.rank = data_rank_and_size(self.mesh)[0]
        self._custom_step = step_fn is not None
        self.step_fn = step_fn or make_train_step(model, loss_config, mesh=self.mesh)
        self.eval_fn = eval_fn or (None if step_fn else make_eval_step(model, loss_config, mesh=self.mesh))
        lead = self.rank == 0
        self.logger = MetricLogger(config.jsonl_path if lead else None, print_every=config.log_every if lead else 0)
        self.history: List[Dict[str, float]] = []
        self.eval_history: List[Dict[str, float]] = []
        self.aborted_nan = False
        self._stream: Optional[DevicePrefetcher] = None  # the batch stream of a run
        if config.load_path:
            self.state = restore_state(config.load_path, self.state)

    def to_device(self, batch: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return to_device(batch, self.device)

    def _host_batch(self, fn: Callable[[int], Mapping[str, np.ndarray]], it: int) -> Mapping[str, np.ndarray]:
        """``fn(it)``, or under a mesh this rank's rows of it."""
        batch = fn(it)
        return batch if self.mesh is None else make_global_batch(batch, self.mesh)

    def _save(self, wait: bool) -> None:
        """Save the state; under a mesh rank 0 writes it whole and every rank waits for it at a barrier."""
        if self.mesh is None:
            save_state(self.cfg.save_path, self.state, wait=wait)
            return
        if self.rank == 0:
            save_state(self.cfg.save_path, self.state, wait=True)
        torch.distributed.barrier(group=self.mesh.get_group("data"))

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def _prefetcher(self, start: int) -> Optional[DevicePrefetcher]:
        """The batch stream from step ``start``: ``batch_fn(start), batch_fn(start + 1), ...``
        made ``prefetch_depth`` ahead, or None at depth 0."""
        if self.cfg.prefetch_depth <= 0:
            return None
        steps = iter(range(start, self.cfg.total_steps))
        return DevicePrefetcher(lambda: self._host_batch(self.batch_fn, next(steps)), self.device,
                                self.cfg.prefetch_depth)

    def run(self, epoch_fn: Optional[Callable[[], int]] = None) -> TrainState:
        self._stream = self._prefetcher(self.state.step)
        try:
            return self._run_loop(epoch_fn)
        finally:
            if self._stream is not None:
                self._stream.close()
                self._stream = None

    def _run_loop(self, epoch_fn: Optional[Callable[[], int]]) -> TrainState:
        cfg = self.cfg
        generator = self._generator(self.state.step)  # the draws of a run follow from the step it starts at
        it = self.state.step
        nan_restarts, last_saved_step = 0, -1
        while it < cfg.total_steps:
            with span("trainer.batch_wait"):
                batch = (self._stream.get() if self._stream is not None
                         else self.to_device(self._host_batch(self.batch_fn, it)))
            with span("trainer.step"):
                self.state, metrics = self.step_fn(self.state, batch, generator)
            if it % cfg.log_every == 0 or it == cfg.total_steps - 1:
                with span("trainer.fetch"):
                    host_metrics = {k: float(v) for k, v in metrics.items()}
                with span("trainer.log"):
                    self.logger.update(host_metrics, step=it, epoch=epoch_fn() if epoch_fn else 0)
                    self.history.append(host_metrics)
                    if not math.isfinite(host_metrics["loss_total"]):
                        if nan_restarts < cfg.max_nan_restarts and cfg.save_path and last_saved_step >= 0:
                            nan_restarts += 1
                            print(f"\nNaN/Inf loss at step {it}, restoring the checkpoint of step "
                                  f"{last_saved_step} (restart {nan_restarts}/{cfg.max_nan_restarts})")
                            self.state = restore_state(cfg.save_path, self.state)
                            generator = self._generator(self.state.step * 7919 + nan_restarts)
                            it = self.state.step
                            if self._stream is not None:  # rewind the batch stream to the restored step
                                self._stream.close()
                                self._stream = self._prefetcher(it)
                            continue
                        print("\nNaN/Inf loss, aborting")
                        self.aborted_nan = True
                        break
            # never checkpoint a non-finite state: the loss is checked on the log cadence only, and a
            # finite loss with overflowed gradients would save poison too (two scalar syncs a save)
            if cfg.save_path and (it + 1) % cfg.save_every == 0:
                with span("trainer.save"):
                    if math.isfinite(float(metrics["loss_total"])) and float(metrics["grads_finite"]) > 0:
                        self._save(wait=False)
                        last_saved_step = it
            if self.eval_batch_fn is not None and cfg.eval_every > 0 and (it + 1) % cfg.eval_every == 0:
                with span("trainer.eval"):
                    self.evaluate(it)
            it += 1
        if cfg.save_path and not self.aborted_nan:
            self._save(wait=True)
        self.logger.close()
        return self.state

    def evaluate(self, it: int) -> Dict[str, float]:
        """Losses and P/R of one eval batch at a posterior sample, no gradient;
        for a model with a category prior, also the anytime protocol on the
        same batch at ``eval_missing_prob`` (``anytime_*``). Both draw from
        generators seeded with ``it``; under a mesh, of the global eval batch.
        Without an ``eval_fn``, nothing."""
        if self.eval_fn is None:
            return {}
        batch = self.to_device(self._host_batch(self.eval_batch_fn, it))
        metrics = self.eval_fn(batch, self._generator(it))
        out = {f"eval_{k}": float(v) for k, v in metrics.items()}
        if not self._custom_step and self.model.config.prior_category is not None and self.cfg.eval_missing_prob > 0:
            with sharded_draws(self.mesh):  # under a mesh the global batch's draws; every metric is a batch mean
                anytime = anytime_eval(self.model, batch, self._generator(it), missing_prob=self.cfg.eval_missing_prob)
            anytime = reduce_metrics(anytime, self.mesh, average=True)
            out.update({f"anytime_{k}": float(v) for k, v in anytime.items()})
        self.eval_history.append(out)
        if self.rank == 0:
            print("\n" + " ".join(f"{k}:{v:.4f}" for k, v in sorted(out.items())))
        return out


def multi_scale_schedule(sizes: Sequence[Tuple[int, int, int]], it: int, period: int = 3,
                         seed: int = 0) -> Tuple[int, int, int]:
    """The (rows, cols, batch) of step ``it``: the list is walked ``period``
    steps an entry, in an order shuffled anew every ``period * len(sizes)``
    steps from ``numpy.random.default_rng(seed + round)``, as the JAX package
    walks it."""
    sizes = list(sizes)
    block = period * len(sizes)
    order = np.random.default_rng(seed + it // block).permutation(len(sizes))
    return sizes[order[(it % block) // period]]
