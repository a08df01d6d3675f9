"""Where the time of one train step goes on the card.

    python -m anytime3d_tpu_torch.cli.profile [--f32] [--out profile.json]

Builds the ``modelnet_nolbo`` trainer as ``cli.train`` does (synthetic data,
packed batches of 32, bfloat16 compute unless ``--f32``) and, after a warm-up,
prints for one configuration:

- the step by stage, CUDA events around each: host->device copy, forward
  (with the encoder and the decoder inside it), backward, and the guarded
  Adam update;
- device time by kernel name over a few steps, from ``torch.profiler``, with
  the device's busy share of the window, and the ``conv_k2`` kernels (any
  kernel with that in its name) listed apart;
- the host's time to make one batch.

Every line carries the card's name and power limit. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time


def main(argv=None):
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from anytime3d_tpu_torch.cli import train as cli_train
    from anytime3d_tpu_torch.train.step import apply_gradients_if_finite, compute_losses

    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--f32", action="store_true", help="float32 compute instead of bfloat16")
    p.add_argument("--rows", type=int, default=30, help="kernels listed")
    p.add_argument("--out", default=None, help="write the numbers as JSON here")
    args = p.parse_args(argv)
    batch_size, steps, profiled_steps = 32, 10, 3
    if not torch.cuda.is_available():
        raise SystemExit("profile: needs a CUDA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()

    train_args = ["--config", "modelnet_nolbo", "--data", "synthetic", "--packed", "--batch-size", str(batch_size)]
    trainer, _ = cli_train.build_trainer(cli_train.parse_args(train_args + ([] if args.f32 else ["--bf16"])))
    model, state, loss_cfg = trainer.model, trainer.state, trainer.loss_cfg
    generator = torch.Generator(device=trainer.device).manual_seed(0)
    label = f"B={batch_size} {'f32' if args.f32 else 'bf16'} 64^3 [{card}]"

    t0 = time.perf_counter()
    host_batches = [trainer.batch_fn(i) for i in range(4)]
    host_ms = (time.perf_counter() - t0) / 4 * 1e3
    print(f"host: making one batch {host_ms:.2f} ms {label}", flush=True)

    marks: list = []

    def mark(name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks.append((name, e))

    for module, name in ((model.encoder3d, "encoder"), (model.decoder, "decoder")):
        module.register_forward_pre_hook(lambda m, a, n=name: mark(n + ":in"))
        module.register_forward_hook(lambda m, a, o, n=name: mark(n + ":out"))

    def one_step(host_batch):
        """``make_train_step``'s body, with an event at every stage boundary."""
        mark("start")
        batch = trainer.to_device(host_batch)
        mark("copied")
        total, metrics = compute_losses(model, loss_cfg, batch, generator)
        mark("forward")
        names, params = zip(*model.named_parameters())
        grads = dict(zip(names, torch.autograd.grad(total, params)))
        mark("backward")
        apply_gradients_if_finite(state, grads, metrics)
        mark("updated")

    for i in range(3):  # warm-up: cuDNN picks its algorithms, the allocator fills its pools
        one_step(host_batches[i % 4])
    torch.cuda.synchronize()
    spans = {k: [] for k in ("copy", "forward", "encoder", "decoder", "backward", "update", "step")}
    for i in range(steps):
        marks.clear()
        one_step(host_batches[i % 4])
        torch.cuda.synchronize()
        ev = dict(marks)
        for key, a, b in (("copy", "start", "copied"), ("forward", "copied", "forward"),
                          ("encoder", "encoder:in", "encoder:out"), ("decoder", "decoder:in", "decoder:out"),
                          ("backward", "forward", "backward"), ("update", "backward", "updated"),
                          ("step", "start", "updated")):
            spans[key].append(ev[a].elapsed_time(ev[b]))
    stage_ms = {k: float(np.median(v)) for k, v in spans.items()}
    print("stages, median ms of %d steps: " % steps + ", ".join(f"{k} {v:.3f}" for k, v in stage_ms.items())
          + f" {label}", flush=True)

    marks.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(profiled_steps):
            one_step(host_batches[i % 4])
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        # kernel rows only: operator rows and annotated ranges repeat their kernels' device time
        if (e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                and not getattr(e, "is_user_annotation", False)):
            rows.append((e.key, e.self_device_time_total / 1e3 / profiled_steps, e.count / profiled_steps))
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    print(f"profiler: device busy {busy_ms:.3f} ms a step of a {window_ms / profiled_steps:.3f} ms window "
          f"({100 * busy_ms * profiled_steps / window_ms:.1f}%) {label}", flush=True)
    for name, ms, count in rows[: args.rows]:
        print(f"  {ms:9.3f} ms {100 * ms / busy_ms:5.1f}% x{count:6.1f}  {name[:110]}", flush=True)
    # the package's own kernels, wherever they rank: FFMA and tensor-core forward, dx, dw and dw's reduce
    own = [r for r in rows if "conv_k2" in r[0]]
    print(f"conv_k2 kernels: {sum(r[1] for r in own):.3f} ms a step ({100 * sum(r[1] for r in own) / busy_ms:.1f}% "
          f"of busy) {label}", flush=True)
    for name, ms, count in own:
        print(f"  {ms:9.3f} ms x{count:6.1f}  {name[:110]}", flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": card, "batch_size": batch_size, "dtype": "f32" if args.f32 else "bf16",
                       "host_batch_ms": host_ms, "stage_ms": stage_ms, "device_busy_ms_per_step": busy_ms,
                       "window_ms_per_step": window_ms / profiled_steps,
                       "kernels": [{"name": n, "ms_per_step": ms, "calls_per_step": c} for n, ms, c in rows]}, fh, indent=1)


if __name__ == "__main__":
    main()
