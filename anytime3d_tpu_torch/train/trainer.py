"""Training loop: batches from a host loader, periodic eval, NaN abort.

Counterpart of ``anytime3d_tpu/train/trainer.py``. Each batch is copied to
the device from pinned memory without blocking, so the copy overlaps the
step before it; metrics are fetched (a device sync) only on the logging
cadence. Checkpoints, NaN restarts from a checkpoint, the background
prefetcher, the multi-scale schedule and the anytime eval metrics are not
ported yet: ``TrainerConfig`` has no field for them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Mapping, Optional

import numpy as np
import torch

from anytime3d_tpu_torch.train.state import TrainState
from anytime3d_tpu_torch.train.step import LossConfig, make_eval_step, make_train_step
from anytime3d_tpu_torch.utils.logging import MetricLogger


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 1000
    eval_every: int = 100
    log_every: int = 1
    jsonl_path: Optional[str] = None


class Trainer:
    """Drives ``make_train_step`` over a host loader.

    ``batch_fn(step) -> dict of numpy arrays`` decouples the trainer from the
    loader; ``cli.train.build_batch_fn`` adapts the loaders. ``state`` holds
    the model, which lives on the device the trainer runs on. ``step_fn`` and
    ``eval_fn`` are plain attributes: a caller may wrap them (to time a step,
    say) before ``run``."""

    def __init__(self, model, state: TrainState, batch_fn: Callable[[int], Mapping[str, np.ndarray]],
                 loss_config: LossConfig = LossConfig(),
                 eval_batch_fn: Optional[Callable[[int], Mapping[str, np.ndarray]]] = None,
                 config: TrainerConfig = TrainerConfig()):
        self.model = model
        self.state = state
        self.batch_fn = batch_fn
        self.eval_batch_fn = eval_batch_fn
        self.cfg = config
        self.loss_cfg = loss_config
        self.device = next(model.parameters()).device
        self.step_fn = make_train_step(model, loss_config)
        self.eval_fn = make_eval_step(model, loss_config)
        self.logger = MetricLogger(config.jsonl_path, print_every=config.log_every)
        self.history: List[Dict[str, float]] = []
        self.eval_history: List[Dict[str, float]] = []
        self.aborted_nan = False

    def to_device(self, batch: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(v)
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t
        return out

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def run(self, epoch_fn: Optional[Callable[[], int]] = None) -> TrainState:
        cfg = self.cfg
        generator = self._generator(self.state.step)  # the draws of a run follow from the step it starts at
        it = self.state.step
        while it < cfg.total_steps:
            self.state, metrics = self.step_fn(self.state, self.to_device(self.batch_fn(it)), generator)
            if it % cfg.log_every == 0 or it == cfg.total_steps - 1:
                host_metrics = {k: float(v) for k, v in metrics.items()}
                self.logger.update(host_metrics, step=it, epoch=epoch_fn() if epoch_fn else 0)
                self.history.append(host_metrics)
                if not math.isfinite(host_metrics["loss_total"]):
                    print("\nNaN/Inf loss, aborting")
                    self.aborted_nan = True
                    break
            if self.eval_batch_fn is not None and cfg.eval_every > 0 and (it + 1) % cfg.eval_every == 0:
                self.evaluate(it)
            it += 1
        self.logger.close()
        return self.state

    def evaluate(self, it: int) -> Dict[str, float]:
        """Losses and P/R of one eval batch at a posterior sample, no gradient."""
        metrics = self.eval_fn(self.to_device(self.eval_batch_fn(it)), self._generator(it))
        out = {f"eval_{k}": float(v) for k, v in metrics.items()}
        self.eval_history.append(out)
        print("\n" + " ".join(f"{k}:{v:.4f}" for k, v in sorted(out.items())))
        return out
