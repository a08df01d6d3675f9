"""Where the time of one train step and of one served batch goes on the card.

    python -m anytime3d_tpu_torch.cli.profile [--config pascal_nolbo] [--f32] [--out profile.json]

Builds the trainer of ``--config`` (default ``modelnet_nolbo``) as
``cli.train`` does (synthetic data, batches of 32, bfloat16 compute unless
``--f32``; voxel configs packed, image configs on bench.py's 96x128 images
with packed-blocked targets) and, after a warm-up, prints for one
configuration:

- the step by stage, CUDA events around each: host->device copy, forward
  (with the encoder, the image backbone and head for an image config, and
  the decoder inside it), backward, and the guarded Adam update;
- device time by kernel name over a few steps, from ``torch.profiler``, with
  the device's busy share of the window, and the ``conv_k2`` kernels (any
  kernel with that in its name) listed apart;
- the host's time to make one batch;
- one served batch of 8 (``make_infer_fn``, the model cast to the compute
  dtype; 64^3 grids, or 64x64 images): encoder and decoder spans and its
  kernels the same way.

Every line carries the card's name and power limit. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import copy
import json
import time

from anytime3d_tpu_torch.utils.timing import card_line, kernel_rows


def main(argv=None):
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from anytime3d_tpu_torch.cli import train as cli_train
    from anytime3d_tpu_torch.data.modelnet import SyntheticImageObjectLoader
    from anytime3d_tpu_torch.models.configs import REGISTRY
    from anytime3d_tpu_torch.serving.export import make_infer_fn
    from anytime3d_tpu_torch.train.step import apply_gradients_if_finite, compute_losses

    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default="modelnet_nolbo", choices=sorted(REGISTRY))
    p.add_argument("--f32", action="store_true", help="float32 compute instead of bfloat16")
    p.add_argument("--rows", type=int, default=30, help="kernels listed")
    p.add_argument("--out", default=None, help="write the numbers as JSON here")
    args = p.parse_args(argv)
    batch_size, steps, profiled_steps = 32, 10, 3
    if not torch.cuda.is_available():
        raise SystemExit("profile: needs a CUDA GPU")
    card = card_line()

    train_args = ["--config", args.config, "--data", "synthetic", "--packed", "--batch-size", str(batch_size)]
    trainer, _ = cli_train.build_trainer(cli_train.parse_args(train_args + ([] if args.f32 else ["--bf16"])))
    model, state, loss_cfg = trainer.model, trainer.state, trainer.loss_cfg
    cfg = model.config
    image = cfg.encoder == "image"
    if image:  # bench.py's image step: 96x128 images, the voxel target packed in the decoder's blocked order
        loader = SyntheticImageObjectLoader(num_samples=256, dim=cfg.decoder.output_shape[0],
                                            num_classes=cfg.category_dim or 40, num_inst=cfg.inst_dim or 10)
        trainer.batch_fn = cli_train.build_batch_fn(loader, cfg, batch_size, packed=True, native=True,
                                                    image_size=(128, 96))
    # the served model, copied before the train model gets its hooks; cast as cli.serve --bf16 casts it
    serve_model = copy.deepcopy(model).to(torch.float32 if args.f32 else torch.bfloat16)
    generator = torch.Generator(device=trainer.device).manual_seed(0)
    shape = "96x128 images -> 64^3" if image else "64^3"
    label = f"{args.config} B={batch_size} {'f32' if args.f32 else 'bf16'} {shape} [{card}]"

    t0 = time.perf_counter()
    host_batches = [trainer.batch_fn(i) for i in range(4)]
    host_ms = (time.perf_counter() - t0) / 4 * 1e3
    print(f"host: making one batch {host_ms:.2f} ms {label}", flush=True)

    marks: list = []

    def mark(name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks.append((name, e))

    def hook_spans(net) -> None:
        """Events at the encoder's entry and exit and the decoder's."""
        first, last = (net.backbone, net.head) if image else (net.encoder3d, net.encoder3d)
        first.register_forward_pre_hook(lambda m, a: mark("encoder:in"))
        last.register_forward_hook(lambda m, a, o: mark("encoder:out"))
        net.decoder.register_forward_pre_hook(lambda m, a: mark("decoder:in"))
        net.decoder.register_forward_hook(lambda m, a, o: mark("decoder:out"))

    hook_spans(model)

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
    rows = kernel_rows(prof, profiled_steps)
    busy_ms = sum(r[1] for r in rows)
    print(f"profiler: device busy {busy_ms:.3f} ms a step of a {window_ms / profiled_steps:.3f} ms window "
          f"({100 * busy_ms * profiled_steps / window_ms:.1f}%) {label}", flush=True)
    print_kernels(rows, busy_ms, args.rows, label)

    # one served batch of 8
    hook_spans(serve_model)
    infer = make_infer_fn(serve_model)
    item = (64, 64, 3) if image else cfg.decoder.output_shape
    x = torch.rand((8, *item), generator=torch.Generator().manual_seed(1)).to(trainer.device)
    if not image:
        x = (x > 0.7).float()
    mask = torch.ones((8, cfg.z_category_dim or cfg.z_inst_dim), device=trainer.device)
    for _ in range(3):
        infer(x, mask)
    serve_spans = {k: [] for k in ("encoder", "decoder", "batch")}
    for _ in range(steps):
        marks.clear()
        mark("start")
        infer(x, mask)
        mark("end")
        torch.cuda.synchronize()
        ev = dict(marks)
        for key, a, b in (("encoder", "encoder:in", "encoder:out"), ("decoder", "decoder:in", "decoder:out"),
                          ("batch", "start", "end")):
            serve_spans[key].append(ev[a].elapsed_time(ev[b]))
    serve_ms = {k: float(np.median(v)) for k, v in serve_spans.items()}
    serve_label = f"{args.config} served batch of 8 {'f32' if args.f32 else 'bf16'} " \
                  f"{'64x64 images' if image else '64^3'} [{card}]"
    print("served batch, median ms of %d: " % steps + ", ".join(f"{k} {v:.3f}" for k, v in serve_ms.items())
          + f" {serve_label}", flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(profiled_steps):
            infer(x, mask)
        torch.cuda.synchronize()
    serve_rows = kernel_rows(prof, profiled_steps)
    serve_busy = sum(r[1] for r in serve_rows)
    print(f"profiler: served batch busy {serve_busy:.3f} ms {serve_label}", flush=True)
    print_kernels(serve_rows, serve_busy, args.rows, serve_label)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": card, "config": args.config, "batch_size": batch_size,
                       "dtype": "f32" if args.f32 else "bf16", "host_batch_ms": host_ms, "stage_ms": stage_ms,
                       "device_busy_ms_per_step": busy_ms, "window_ms_per_step": window_ms / profiled_steps,
                       "kernels": [{"name": n, "ms_per_step": ms, "calls_per_step": c} for n, ms, c in rows],
                       "serve_ms": serve_ms, "serve_busy_ms": serve_busy,
                       "serve_kernels": [{"name": n, "ms": ms, "calls": c} for n, ms, c in serve_rows]}, fh, indent=1)


def print_kernels(rows: list, busy_ms: float, top: int, label: str) -> None:
    """The ``top`` longest kernels, then the package's own (``conv_k2``:
    FFMA and tensor-core forward, dx, dw and dw's reduce) wherever they rank."""
    for name, ms, count in rows[:top]:
        print(f"  {ms:9.3f} ms {100 * ms / busy_ms:5.1f}% x{count:6.1f}  {name[:110]}", flush=True)
    own = [r for r in rows if "conv_k2" in r[0]]
    print(f"conv_k2 kernels: {sum(r[1] for r in own):.3f} ms ({100 * sum(r[1] for r in own) / busy_ms:.1f}% "
          f"of busy) {label}", flush=True)
    for name, ms, count in own:
        print(f"  {ms:9.3f} ms x{count:6.1f}  {name[:110]}", flush=True)


if __name__ == "__main__":
    main()
