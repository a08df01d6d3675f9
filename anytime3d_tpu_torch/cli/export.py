"""Export CLI: write a model's serving program as one artifact.

    python -m anytime3d_tpu_torch.cli.export --config modelnet_nolbo --ckpt ckpt/ --batch-size 8 --out model.pt2
    python -m anytime3d_tpu_torch.cli.export --config pascal_nolbo --image-size 64 --out image.pt2
    python -m anytime3d_tpu_torch.cli.export --config modelnet_ae --ckpt ckpt/ --prior-means v.npy --out ae.pt2

Counterpart of ``anytime3d_tpu/cli/export.py``. The artifact is the
float-input program that the JAX command writes: ``x`` float32 (B, D, H, W,
1), or (B, S, S, 3) images for an image config (``--image-size`` S), and
``mask`` float32 (B, z_cat_dim) in; ``category``, ``z_mean``,
``z_log_var`` and ``pred`` out (``serving/export.py::export_infer``), weights
and class anchors baked in on ``--device``, which defaults to ``cuda``; when
CUDA is absent the command fails rather than export for the CPU. ``--bf16``
casts the model to bfloat16 first. ``--ckpt`` takes a checkpoint of
``cli.train --save-path``; without it the model holds seeded random weights
(``--seed``). The class anchors are the category prior's means; a model
without one (the VAE, AE and ``kitti_inst_only`` configs) takes them from
``--prior-means``, a (K, z_cat_dim) ``.npy`` such as ``cli.evaluate
--latents-out`` writes, or has none: its program then returns no
``category`` and fills missing latent dims with 0. Serve the artifact with
``cli.serve --artifact``, or load it with ``serving.export.load_infer`` under
the torch version that wrote it.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    import time

    import numpy as np
    import torch

    from anytime3d_tpu_torch.models.configs import REGISTRY
    from anytime3d_tpu_torch.models.mmvae import MultiModalVAE
    from anytime3d_tpu_torch.serving.export import export_infer
    from anytime3d_tpu_torch.train.checkpoint import restore_params

    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", required=True, choices=sorted(REGISTRY))
    p.add_argument("--ckpt", default=None, help="checkpoint directory (omit: seeded random weights)")
    p.add_argument("--batch-size", type=int, default=8, help="the program's one batch shape")
    p.add_argument("--image-size", type=int, default=64, help="square image size of image configs")
    p.add_argument("--no-correction", action="store_true", help="skip the masked-latent prior fill")
    p.add_argument("--prior-means", default=None,
                   help=".npy of (K, z_cat_dim) class anchors (cli.evaluate --latents-out) for the VAE/AE variants")
    p.add_argument("--out", required=True)
    p.add_argument("--bf16", action="store_true", help="cast the model to bfloat16")
    p.add_argument("--seed", type=int, default=0, help="seed of the random weights")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but CUDA is not available (pass --device cpu to export for the CPU)")
    cfg = REGISTRY[args.config]()
    prior_means = None
    if args.prior_means:
        prior_means = np.load(args.prior_means)
        z_cat_dim = cfg.z_category_dim or cfg.z_inst_dim
        if prior_means.ndim != 2 or prior_means.shape[1] != z_cat_dim:
            raise SystemExit(f"--prior-means {args.prior_means}: shape {prior_means.shape}, expected (K, {z_cat_dim})")
    model = MultiModalVAE(cfg, generator=torch.Generator().manual_seed(args.seed))
    if args.ckpt:
        model.load_state_dict(restore_params(args.ckpt, model.state_dict()))
    if args.bf16:
        model = model.to(torch.bfloat16)
    model = model.to(device)
    if cfg.encoder == "image":
        shape = (args.batch_size, args.image_size, args.image_size, 3)
    else:
        shape = (args.batch_size, *cfg.decoder.output_shape)
    t0 = time.perf_counter()
    data = export_infer(model, shape, correction=not args.no_correction, prior_means=prior_means)
    with open(args.out, "wb") as f:
        f.write(data)
    print(f"wrote {args.out}: {len(data)} bytes, input {shape} float32 on {device}, "
          f"{'bfloat16' if args.bf16 else 'float32'} compute, exported in {time.perf_counter() - t0:.1f} s")
    return data


if __name__ == "__main__":
    main()
