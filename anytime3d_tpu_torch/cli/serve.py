"""Serving CLI: stand up the HTTP inference endpoint.

    python -m anytime3d_tpu_torch.cli.serve --artifact model.pt2 [--mask-dim 64] [--item-bytes 32768]
    python -m anytime3d_tpu_torch.cli.serve --config modelnet_nolbo [--checkpoint dir | --weights params.npz]

Counterpart of ``anytime3d_tpu/cli/serve.py``, in two modes:

- ``--artifact``: serve an exported program (``cli.export`` or
  ``serving/export.py::export_infer``) by its own input signature: a
  program that takes uint8 (B, N/8) bits takes the packed requests, one that
  takes float (B, D, H, W, 1) grids or (B, H, W, 3) images (an image
  config's ``cli.export``) the raw ``input`` requests. Its batch
  is the program's; ``--batch-size``, ``--mask-dim`` and ``--item-bytes``,
  where given, are checked against it. (The JAX command serves every
  artifact as packed, so the float artifact its own export writes cannot be
  served; that is not copied.)
- ``--config``: build the model, with ``--checkpoint`` (a checkpoint of
  ``cli.train --save-path``), ``--weights`` (flax params as a flat ``.npz``
  keyed by '/'-joined flax paths, ``convert.load_flax_npz``) or seeded random
  weights (``--seed``), and serve its packed-IO program (voxel configs; an
  image config is served from its exported artifact). A config without a
  category prior (``modelnet_vae``, ``modelnet_ae``, ``ae3d`` and their
  ``_dr`` forms) is served with no class: its replies carry no
  ``category`` and its missing latent dims take 0; to classify, export it
  with ``cli.export --prior-means`` and serve the artifact.

The device defaults to ``cuda``; when CUDA is absent the command fails rather
than serve from the CPU. ``--port 0`` binds an ephemeral port; the line
``serving ... on <host>:<port>`` names it. The endpoint protocol is in
``serving/server.py``.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    from anytime3d_tpu_torch.models.configs import REGISTRY

    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--artifact", default=None, help="an exported serving program")
    p.add_argument("--config", default="modelnet_nolbo", choices=sorted(REGISTRY))
    p.add_argument("--checkpoint", default=None, help="checkpoint directory of cli.train --save-path")
    p.add_argument("--weights", default=None, help="flax params as a flat .npz")
    p.add_argument("--batch-size", type=int, default=None, help="default 8, or the artifact's batch")
    p.add_argument("--dim", type=int, default=64, help="edge of the served voxel grid (--config)")
    p.add_argument("--mask-dim", type=int, default=None, help="latent mask width, checked against the artifact")
    p.add_argument("--item-bytes", type=int, default=None, help="packed item length, checked against the artifact")
    p.add_argument("--port", type=int, default=8731)
    p.add_argument("--host", default="127.0.0.1",
                   help="bind address (default loopback; the endpoint is unauthenticated)")
    p.add_argument("--max-wait-ms", type=float, default=2.0, help="how long a batch waits to fill")
    p.add_argument("--bf16", action="store_true", help="compute in bfloat16 (--config)")
    p.add_argument("--seed", type=int, default=0, help="seed of the random weights")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def _from_artifact(args, device):
    """(infer_fn, item_shape, input_dtype, mask_dim, batch) of an exported program, checked against the flags."""
    import numpy as np
    import torch

    from anytime3d_tpu_torch.serving.export import load_infer

    if args.checkpoint or args.weights or args.bf16:
        raise SystemExit("--artifact holds its weights and dtype: drop --checkpoint, --weights and --bf16")
    with open(args.artifact, "rb") as fh:
        fn = load_infer(fh.read())
    if fn.device.type != device.type:
        raise SystemExit(f"{args.artifact} was exported for {fn.device}, not --device {device}")
    if fn.mask_shape is None:
        raise SystemExit(f"{args.artifact} takes one input (a detector program, export_detector): the HTTP server "
                         "serves (x, mask) programs only")
    batch, mask_dim = fn.input_shape[0], fn.mask_shape[1]
    if fn.input_dtype == torch.uint8:
        if len(fn.input_shape) != 2:
            raise SystemExit(f"{args.artifact}: uint8 input {fn.input_shape} is no (B, N/8) bit array")
        item_shape, dtype = fn.input_shape[1:], np.uint8
        if args.item_bytes is not None and args.item_bytes != item_shape[0]:
            raise SystemExit(f"--item-bytes {args.item_bytes}, but {args.artifact} takes {item_shape[0]} bytes")
    else:
        item_shape, dtype = fn.input_shape[1:], np.float32
        if args.item_bytes is not None:
            raise SystemExit(f"{args.artifact} takes float items {item_shape}, not packed items: drop --item-bytes")
    for flag, want, have in (("--mask-dim", args.mask_dim, mask_dim), ("--batch-size", args.batch_size, batch)):
        if want is not None and want != have:
            raise SystemExit(f"{flag} {want}, but {args.artifact} takes {have}")
    return fn, item_shape, dtype, mask_dim, batch


def _from_config(args, device):
    """(infer_fn, item_shape, input_dtype, mask_dim, batch) of the config's packed-IO program."""
    import numpy as np
    import torch

    from anytime3d_tpu_torch.convert import load_flax_npz
    from anytime3d_tpu_torch.models.configs import REGISTRY
    from anytime3d_tpu_torch.models.mmvae import MultiModalVAE
    from anytime3d_tpu_torch.serving.export import make_packed_infer
    from anytime3d_tpu_torch.train.checkpoint import restore_params

    cfg = REGISTRY[args.config]()
    if cfg.encoder != "voxel":
        raise SystemExit(f"packed-IO serving needs a voxel-encoder config; serve {args.config} from "
                         f"cli.export's artifact with --artifact")
    d = args.dim
    if cfg.decoder.output_shape != (d, d, d, 1):
        raise SystemExit(f"{args.config} serves {cfg.decoder.output_shape} grids, not {d}^3")
    model = MultiModalVAE(cfg, generator=torch.Generator().manual_seed(args.seed))
    if args.weights:
        model.load_state_dict(load_flax_npz(args.weights))
    if args.checkpoint:
        model.load_state_dict(restore_params(args.checkpoint, model.state_dict()))
    if args.bf16:
        model = model.to(torch.bfloat16)
    model = model.to(device)
    mask_dim = cfg.z_category_dim or cfg.z_inst_dim
    for flag, want, have in (("--mask-dim", args.mask_dim, mask_dim), ("--item-bytes", args.item_bytes, d**3 // 8)):
        if want is not None and want != have:
            raise SystemExit(f"{flag} {want}, but {args.config} takes {have}")
    return make_packed_infer(model, (d, d, d, 1)), (d**3 // 8,), np.uint8, mask_dim, args.batch_size or 8


def build_server(args):
    """The ``InferenceServer`` that ``main`` serves and a line that describes it, from parsed arguments."""
    import numpy as np
    import torch

    from anytime3d_tpu_torch.serving.server import InferenceServer

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but CUDA is not available (pass --device cpu to serve from the CPU)")
    if args.checkpoint and args.weights:
        raise SystemExit("pass --checkpoint or --weights, not both")
    fn, item_shape, dtype, mask_dim, batch = (_from_artifact if args.artifact else _from_config)(args, device)
    server = InferenceServer(fn, item_shape, mask_dim, batch_size=batch, max_wait_s=args.max_wait_ms / 1e3,
                             device=device, input_dtype=dtype)
    what = args.artifact or args.config
    io = f"item {item_shape[0]} B packed" if dtype is np.uint8 else f"item {tuple(item_shape)} float"
    return server, f"{what} ({device}, {io}, mask {mask_dim}, batch {batch})"


def main(argv=None):
    import signal
    import sys
    import threading

    args = parse_args(argv)
    server, what = build_server(args)
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(0))  # a terminated server closes its batcher
    try:
        port = server.serve(args.port, background=True, host=args.host)
        print(f"serving {what} on {args.host}:{port}", flush=True)
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        server.close()


if __name__ == "__main__":
    main()
