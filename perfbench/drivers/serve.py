"""The window driver of serving mixes (traffic ``kind`` "serve").

Set-up builds the port's packed-IO serving program over the seeded weights
(``serving/export.py::make_packed_infer``, the model cast to the mix's
compute dtype as ``cli/serve.py --bf16`` casts it) behind
``serving/batcher.py::MicroBatcher`` at the mix's batch, wait and batches in
flight, and starts the closed loop: ``outstanding`` clients, each sending its
next request from its future's done callback, with no think time, so that
as many requests are outstanding at all times. Each request is one packed grid from a seeded pool of shapes and a
latent mask whose missing share is drawn from the mix's rates. The loop
runs through set-up's warm requests into the window without a pause; the
window counts the requests that complete in it and times each from its
``submit`` to its future's result. Afterwards the loop stops and every
outstanding request is waited for.
"""

from __future__ import annotations

import gc
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench import flops, generators, judge
from perfbench.drivers.common import EventSpans, Readings, Tracer, build_model, load_weights, no_tf32

ORDER = 1 << 16  # the request stream repeats its (shape, mask) draws after this many requests


class Driver:
    def __init__(self, cell, seed: int, device, faults=()):
        self.cell, self.seed, self.device = cell, int(seed), torch.device(device)
        self.cfg, self.mix = cell.config, cell.traffic
        self.faults = set(faults)
        self.batch = int(self.mix["batch"])
        self.spans = EventSpans(enabled=False)
        self.tracer: Optional[Tracer] = None
        self._lock = threading.Lock()
        self.t_submit: Dict[int, float] = {}
        self.t_done: Dict[int, float] = {}
        self.errors: Dict[int, BaseException] = {}
        self.kept: Dict[int, dict] = {}

    # ---- set-up -----------------------------------------------------------
    def setup(self, trace: bool = False) -> None:
        from anytime3d_tpu_torch.serving.batcher import MicroBatcher
        from anytime3d_tpu_torch.serving.export import make_packed_infer

        m, dev, mix = self.cfg["model"], self.device, self.mix
        self.marks = [("start", time.perf_counter())]
        d = m["decoder"]["output_shape"][0]
        self.shapes = generators.make_shapes(int(mix["pool"]), d, m["category_dim"], m["inst_dim"] or 10,
                                             self.seed, dev)
        n = len(self.shapes.labels)
        self.packed = np.packbits(self.shapes.voxels.reshape(n, -1), axis=1)
        mask_dim = m["z_category_dim"] or m["z_inst_dim"]
        self.masks, _ = generators.missing_masks(int(mix["pool"]), mask_dim, mix["missing_rates"], self.seed)
        r = generators.rng(self.seed, 5)
        self.order_shape = r.integers(0, n, ORDER)
        self.order_mask = r.integers(0, len(self.masks), ORDER)
        self.keep = r.random(ORDER) < float(mix["keep_share"])

        self.marks.append(("data", time.perf_counter()))
        model, _, weights = build_model(self.cfg, self.seed, dev, None)
        load_weights(model, weights)
        del weights
        self.marks.append(("weights", time.perf_counter()))
        if mix["compute"] == "bf16":
            model = model.to(torch.bfloat16)
        self.model = model
        infer = make_packed_infer(model, (d, d, d, 1))
        self.marks.append(("program", time.perf_counter()))
        self.spans = EventSpans(enabled=trace)

        def infer_fn(x, mask):
            with self.spans.span("serve.batch_device"):
                out = infer(x, mask)
            return self._plant(out)

        self.batcher = MicroBatcher(infer_fn, self.batch, (self.packed.shape[1],), mask_dim,
                                    max_wait_s=float(mix["max_wait_ms"]) / 1e3, input_dtype=np.uint8,
                                    max_in_flight=int(mix["max_in_flight"]), device=dev)
        self.marks.append(("model", time.perf_counter()))
        self._stop = threading.Event()
        self._next = 0
        for _ in range(int(mix["outstanding"])):
            self._submit()
        warm = int(mix["warm_requests"])
        while len(self.t_done) < warm:
            time.sleep(0.002)
        self.marks.append(("warm requests", time.perf_counter()))
        self.spans.clear()

    def _plant(self, out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The planted faults, applied where the answers are produced."""
        if "category" in self.faults:
            out["category"] = (out["category"] + 1) % self.cfg["model"]["category_dim"]
        if "rows" in self.faults:
            out = {k: v.roll(1, dims=0) for k, v in out.items()}
        if "bits" in self.faults:
            bits = out["pred_packed"].clone()
            bits[:, bits.shape[1] // 2] ^= 0xFF
            out["pred_packed"] = bits
        return out

    def _submit(self) -> None:
        """Send the next request of the stream, unless the loop is stopping."""
        with self._lock:
            if self._stop.is_set():
                return
            k = self._next
            self._next += 1
            self.t_submit[k] = time.perf_counter()
        j = k % ORDER
        fut = self.batcher.submit(self.packed[self.order_shape[j]], self.masks[self.order_mask[j]])
        fut.add_done_callback(lambda f, k=k: self._resolved(k, f))

    def _resolved(self, k: int, fut) -> None:
        """A request's answer: its time, its answer where the stream keeps it, and the client's next request."""
        t = time.perf_counter()
        exc = fut.exception()
        with self._lock:
            self.t_done[k] = t
            if exc is not None:
                self.errors[k] = exc
            elif self.keep[k % ORDER]:
                self.kept[k] = fut.result()
        self._submit()

    # ---- window -----------------------------------------------------------
    def window(self, seconds: float, trace_dir: Optional[str] = None) -> None:
        """Keep the loop going for ``seconds``; with ``trace_dir``, go on
        under the profiler for the mix's ``trace_seconds``; then stop it and
        wait for every outstanding request."""
        self.tracer = (Tracer(trace_dir, float(self.mix["trace_seconds"]), lambda: self.batcher.batches_run)
                       if trace_dir else None)
        self.spans.clear()
        self.batches0 = self.batcher.batches_run
        self.t0 = time.perf_counter()
        self.t1 = self.t0 + seconds
        while (now := time.perf_counter()) < self.t1:
            time.sleep(min(0.01, self.t1 - now))
        self.batches1 = self.batcher.batches_run
        self.spans.enabled = False
        if self.tracer is not None:
            self.tracer.arm()
            while not self.tracer.done:
                time.sleep(0.01)
                self.tracer.tick()
            self.tracer.finish()
        self._stop.set()
        deadline = time.perf_counter() + 60.0
        while len(self.t_done) < len(self.t_submit) and time.perf_counter() < deadline:
            time.sleep(0.005)
        self.batcher.close()
        self.window_s = self.t1 - self.t0
        with self._lock:
            self.in_window = sorted(k for k, t in self.t_done.items() if self.t0 <= t <= self.t1)
        self.never = len(self.t_submit) - len(self.t_done)

    def latencies_ms(self) -> List[float]:
        return [(self.t_done[k] - self.t_submit[k]) * 1e3 for k in self.in_window]

    def attempted_failed(self):
        return len(self.in_window) + self.never, sum(1 for k in self.in_window if k in self.errors) + self.never

    def end_to_end(self) -> Dict[str, float]:
        return {"serve_shapes_per_s": len(self.in_window) / self.window_s}

    def readings(self) -> Readings:
        batches = self.batches1 - self.batches0
        spans = self.spans.read()
        spans["serve.latency"] = self.latencies_ms()
        counts = {"work": batches, "requests": len(self.in_window), "window_s": self.window_s,
                  "flops": flops.serve_batch_flops(self.cfg, self.batch) * batches, "compute": self.mix["compute"]}
        tracer = self.tracer
        return Readings(spans, counts, tracer.trace if tracer else None, tracer.work if tracer else 0)

    def release(self) -> None:
        self.batcher = self.model = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ---- comparison -------------------------------------------------------
    def sample(self) -> List[int]:
        """The checked requests: drawn from the seed among those completed in the window whose answers were kept."""
        pool = [k for k in self.in_window if k in self.kept]
        r = generators.rng(self.seed, 6)
        n = min(int(self.mix["checked_requests"]), len(pool))
        return sorted(r.choice(pool, size=n, replace=False).tolist()) if n else []

    def inputs(self, ids: List[int]):
        j = [k % ORDER for k in ids]
        vox = torch.as_tensor(self.shapes.voxels[self.order_shape[j]], device=self.device).float()[:, None]
        mask = torch.as_tensor(self.masks[self.order_mask[j]], device=self.device)
        return vox, mask

    def judge_answers(self, ids: List[int], answers: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """The compared numbers of ``answers`` (``category``, ``z_mean``,
        ``bits`` (B, N)) to the requests ``ids``, judged by the float32 reference."""
        from perfbench.reference import model as ref
        from perfbench.reference import serve as ref_serve

        worst = {"category_gap": 0.0, "latent_gap": 0.0, "voxel_gap": 0.0}
        with no_tf32(), torch.no_grad():
            P = generators.weights(ref.param_spec(self.cfg["model"]), self.seed, self.device)
            means = ref_serve.prior_means(P, self.cfg["model"])
            for lo in range(0, len(ids), self.batch):
                sl = slice(lo, lo + self.batch)
                vox, mask = self.inputs(ids[sl])
                z_ref = ref_serve.latent(P, self.cfg["model"], vox)
                cat = answers["category"][sl].to(self.device)
                exp = ref_serve.expected(P, self.cfg["model"], z_ref, means, mask, cat)
                gaps = {
                    "category_gap": judge.category_gaps(z_ref, means, mask, cat),
                    "latent_gap": judge.latent_gaps(answers["z_mean"][sl].to(self.device).float(), exp["z"]),
                    "voxel_gap": judge.voxel_gaps(answers["bits"][sl].to(self.device), exp["logits"]),
                }
                for name, v in gaps.items():
                    worst[name] = max(worst[name], float(v.max()))
        return worst

    def served_answers(self, ids: List[int]) -> Dict[str, torch.Tensor]:
        got = [self.kept[k] for k in ids]
        return {"category": torch.as_tensor(np.stack([g["category"] for g in got])),
                "z_mean": torch.as_tensor(np.stack([g["z_mean"] for g in got])),
                "bits": judge.unpack_bits(np.stack([g["pred_packed"] for g in got]))}

    def control_answers(self, ids: List[int], precision: str = "fp8") -> Dict[str, torch.Tensor]:
        """What the reference at ``precision`` answers to ``ids``: the control."""
        from perfbench.reference import model as ref
        from perfbench.reference import serve as ref_serve

        parts = []
        with no_tf32(), torch.no_grad():
            P = generators.weights(ref.param_spec(self.cfg["model"]), self.seed, self.device)
            for lo in range(0, len(ids), self.batch):
                vox, mask = self.inputs(ids[lo:lo + self.batch])
                parts.append(ref_serve.served_like(P, self.cfg["model"], vox, mask, precision))
        return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}

    def check(self):
        ids = self.sample()
        if not ids:  # nothing to judge: every limited number reads as missing
            return {}, None
        return self.judge_answers(ids, self.served_answers(ids)), None
