"""The window driver of training mixes (traffic ``kind`` "train").

Set-up builds one object, the port's ``Trainer`` over ``make_train_step``
with its model and Adam state, as ``cli/train.py`` builds it: the seeded
weights loaded into the model, batches made by ``cli.train.build_batch_fn``
over the benchmark's seeded shapes (packed by the native packer where the
mix says ``packed``, images on the multi-scale schedule where it lists
sizes) and prefetched by the trainer's ``DevicePrefetcher``. The step's
random draws are the benchmark's, made from the seed and handed to the step
as its ``draws`` (and its prior nets' dropout generator). Set-up drives that
object through its first ``warm_steps`` steps, every shape of the mix among
them, and keeps what the comparison needs of the first ``checked_steps``:
their losses, the first gradient's norms as Adam holds them, the
parameters' change. The window then drives the same object for the given
seconds, with no eval and no save, and ends in a synchronize.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench import flops, generators, judge
from perfbench.drivers.common import EventSpans, Readings, Tracer, build_model, load_weights, no_tf32


@dataclasses.dataclass
class _Snap:
    losses: List[float] = dataclasses.field(default_factory=list)
    grad_norms: Dict[str, float] = dataclasses.field(default_factory=dict)
    change_norms: Dict[str, float] = dataclasses.field(default_factory=dict)


class Driver:
    def __init__(self, cell, seed: int, device, faults=()):
        self.cell, self.seed, self.device = cell, int(seed), torch.device(device)
        self.cfg, self.mix = cell.config, cell.traffic
        self.faults = set(faults)
        self.batch = int(self.mix["batch"])
        self.checked = int(self.mix["checked_steps"])
        self.pool = int(self.mix["draw_pool"])
        self.image = self.cfg["model"]["encoder"] == "image"
        self.sizes = list(self.mix.get("image_sizes", []))
        self.rows: Dict[int, np.ndarray] = {}
        self.step_size: Dict[int, Optional[int]] = {}
        self.batch_ms: List[tuple] = []
        self.snap = _Snap()
        self.spans = EventSpans(enabled=False)
        self.tracer: Optional[Tracer] = None
        self.stop_at: Optional[float] = None
        self.t_end: Optional[float] = None

    # ---- set-up -----------------------------------------------------------
    def setup(self, trace: bool = False) -> None:
        from anytime3d_tpu_torch.cli.train import build_batch_fn
        from anytime3d_tpu_torch.train.state import create_train_state
        from anytime3d_tpu_torch.train.trainer import Trainer, TrainerConfig

        m, dev = self.cfg["model"], self.device
        self.marks = [("start", time.perf_counter())]
        self.shapes = generators.make_shapes(int(self.mix["samples"]), m["decoder"]["output_shape"][0],
                                             m["category_dim"] or 40, m["inst_dim"] or 10, self.seed, dev)
        self.renders = {s: generators.render(self.shapes, s, dev) for s in self.sizes}
        loader = generators.ShapeLoader(self.shapes, self.seed, self.renders or None)
        self.marks.append(("data", time.perf_counter()))
        dtype = torch.bfloat16 if self.mix["compute"] == "bf16" else torch.float32
        self.model, self.loss_cfg, self.weights = build_model(self.cfg, self.seed, dev, dtype)
        load_weights(self.model, self.weights)
        self.marks.append(("weights", time.perf_counter()))
        state = create_train_state(self.model, learning_rate=float(self.mix["learning_rate"]))
        native = True if dev.type == "cuda" else None  # on the card the native packer or nothing, as cli/train
        if self.mix.get("multi_scale"):
            size, schedule = None, [(s, s, self.batch) for s in self.sizes]
        else:
            size, schedule = ((self.sizes[0], self.sizes[0]) if self.sizes else None), None
        fn = build_batch_fn(loader, self.model.config, self.batch, bool(self.mix["packed"]) and not self.image,
                            native, size, schedule)

        def batch_fn(it: int):
            t0 = time.perf_counter()
            out = fn(it)
            self.batch_ms.append((t0, (time.perf_counter() - t0) * 1e3))
            self.rows[it] = loader.served[-1]
            self.step_size[it] = out["input"].shape[1] if self.image else None
            return out

        self.draws = [generators.step_draws(self.cfg, self.batch, self.seed, i, dev) for i in range(self.pool)]
        self.trainer = Trainer(self.model, state, batch_fn, loss_config=self.loss_cfg,
                               config=TrainerConfig(total_steps=int(self.mix["warm_steps"]), eval_every=0,
                                                    save_every=10**9, log_every=1,
                                                    prefetch_depth=int(self.mix["prefetch_depth"])))
        self._step = self.trainer.step_fn
        self.trainer.step_fn = self._timed_step
        self.spans = EventSpans(enabled=trace)
        if trace:
            self.spans.hook_forward("train.encoder_fwd", *self._encoder_modules())
            self.spans.hook_forward("train.decoder_fwd", self.model.decoder, self.model.decoder)
        self.marks.append(("model", time.perf_counter()))
        self.trainer.run()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        self.marks.append(("warm steps", time.perf_counter()))
        self.snap.losses = [h["loss_total"] for h in self.trainer.history[:self.checked]]
        self.spans.clear()
        self.batch_ms.clear()

    def _encoder_modules(self):
        if self.image:
            return self.model.backbone, self.model.head
        return self.model.encoder3d, self.model.encoder3d

    def _run_step(self, state, batch, i: int):
        draws = self.draws[i % self.pool]
        gen = torch.Generator(device=self.device).manual_seed(generators.dropout_seed(self.seed, i % self.pool))
        if "half" in self.faults:  # planted: half of the batch left out, the mean over the rest
            h = self.batch // 2
            batch = {k: v[:h] for k, v in batch.items()}
            draws = {k: (v[:h] if v.dim() else v) for k, v in draws.items()}
        if "unchanged" in self.faults:  # planted: a step that returns its state unchanged
            from anytime3d_tpu_torch.train.step import compute_losses

            with torch.no_grad():
                _, metrics = compute_losses(self.model, self.loss_cfg, batch, gen, draws=draws)
            metrics["grads_finite"] = torch.ones((), device=self.device)
            state.step += 1
            return state, metrics
        return self._step(state, batch, gen, draws)

    def _timed_step(self, state, batch, generator=None):
        i = state.step
        with self.spans.span("train.step_device"):
            state, metrics = self._run_step(state, batch, i)
        if state.step == 1:
            self._snap_grads(state)
        if state.step == self.checked:
            self._snap_change()
        if self.stop_at is not None and self.t_end is None and time.perf_counter() >= self.stop_at:
            if self.device.type == "cuda":
                torch.cuda.synchronize()
            self.t_end = time.perf_counter()
            self.steps = state.step - self.start_step
            self.spans.enabled = False
            if self.tracer is not None:
                self.tracer.arm()
        if self.tracer is not None:
            self.tracer.tick()
        if self.t_end is not None and (self.tracer is None or self.tracer.done):
            self.trainer.cfg.total_steps = state.step
        return state, metrics

    def _snap_grads(self, state) -> None:
        b1 = state.optimizer.defaults["betas"][0]
        out = {}
        for name, p in self.model.named_parameters():
            m = state.optimizer.state.get(p, {}).get("exp_avg")
            out[name] = float(m.norm()) / (1.0 - b1) if m is not None else 0.0
        self.snap.grad_norms = out

    def _snap_change(self) -> None:
        with torch.no_grad():
            self.snap.change_norms = {n: float((p.float() - self.weights[n]).norm())
                                      for n, p in self.model.named_parameters()}
        self.weights = None  # the reference makes its own from the seed

    # ---- window -----------------------------------------------------------
    def window(self, seconds: float, trace_dir: Optional[str] = None) -> None:
        """Drive the trainer for ``seconds``; with ``trace_dir``, go on under
        the profiler for the mix's ``trace_seconds``."""
        self.tracer = (Tracer(trace_dir, float(self.mix["trace_seconds"]), lambda: self.trainer.state.step)
                       if trace_dir else None)
        self.start_step = self.trainer.state.step
        self.trainer.cfg.total_steps = 10**9
        self.history_from = len(self.trainer.history)
        self.t0 = time.perf_counter()
        self.stop_at = self.t0 + seconds
        self.trainer.run()
        if self.tracer is not None:
            self.tracer.finish()
        self.window_s = self.t_end - self.t0

    def attempted_failed(self):
        hist = self.trainer.history[self.history_from:self.history_from + self.steps]
        bad = sum(1 for h in hist if not (np.isfinite(h["loss_total"]) and h["grads_finite"] > 0))
        return self.steps, bad

    def end_to_end(self) -> Dict[str, float]:
        """The mix's ``rate_metric``: samples of the window's steps over its seconds."""
        return {self.mix["rate_metric"]: self.steps * self.batch / self.window_s}

    def readings(self) -> Readings:
        window_steps = range(self.start_step, self.start_step + self.steps)
        if self.image:
            per_size = {s: flops.train_step_flops(self.cfg, self.batch, s) for s in self.sizes}
            total = sum(per_size[self.step_size[i]] for i in window_steps)
        else:
            total = flops.train_step_flops(self.cfg, self.batch) * self.steps
        host = [ms for t, ms in self.batch_ms if self.t0 <= t <= self.t_end]
        spans = self.spans.read()
        spans["train.batch_host"] = host
        counts = {"work": self.steps, "window_s": self.window_s, "flops": total,
                  "compute": self.mix.get("peak", self.mix["compute"])}
        tracer = self.tracer
        return Readings(spans, counts, tracer.trace if tracer else None, tracer.work if tracer else 0)

    def release(self) -> None:
        self.spans.remove_hooks()
        self.trainer = self.model = self._step = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ---- comparison -------------------------------------------------------
    def reference_inputs(self):
        """The checked steps' batches, draws and dropout masks, made anew from the seed."""
        m, dev = self.cfg["model"], self.device
        batches, draws, keeps = [], [], []
        for i in range(self.checked):
            rows = self.rows[i]
            b = {"vox": torch.as_tensor(self.shapes.voxels[rows], device=dev).float()[:, None]}
            if self.image:
                b["images"] = torch.as_tensor(generators.image_of(self.renders, rows, self.step_size[i]), device=dev)
            if m["category_dim"]:
                b["category_onehot"] = torch.eye(m["category_dim"], device=dev)[self.shapes.labels[rows]]
            if m["inst_dim"]:
                b["inst_onehot"] = torch.eye(m["inst_dim"], device=dev)[self.shapes.insts[rows]]
            batches.append(b)
            draws.append(generators.step_draws(self.cfg, self.batch, self.seed, i % self.pool, dev))
            gen = torch.Generator(device=dev).manual_seed(generators.dropout_seed(self.seed, i % self.pool))
            from perfbench.reference import model as ref

            keeps.append(ref.dropout_keeps(m, self.batch, gen, dev))
        return batches, draws, keeps

    def reference(self, precision: str = "f32", skip_rows: Optional[int] = None) -> dict:
        from perfbench.reference import model as ref
        from perfbench.reference import train as ref_train

        with no_tf32():
            if precision == "tf32":  # the witness: every convolution in TF32, as cuDNN may run them
                torch.backends.cudnn.allow_tf32 = True
            P0 = generators.weights(ref.param_spec(self.cfg["model"]), self.seed, self.device)
            batches, draws, keeps = self.reference_inputs()
            return ref_train.run_steps(P0, self.cfg, batches, draws, keeps, float(self.mix["learning_rate"]),
                                       precision, skip_rows)

    def check(self):
        """(numbers compared, the reference's run): the program's first steps against the reference's."""
        ref = self.reference()
        return judge.train_numbers(dataclasses.asdict(self.snap), ref), ref
