"""Evaluation CLI: the anytime missing-rate sweep and a PR curve, per-class
latents, or reconstruction dumps.

    python -m anytime3d_tpu_torch.cli.evaluate --config modelnet_nolbo [--ckpt dir | --weights params.npz] [--bf16]

Counterpart of ``anytime3d_tpu/cli/evaluate.py``. By default it prints the
sweep table (metrics per missing rate, uncorrected and corrected) as JSON,
then the decode threshold of best IoU on one batch's posterior-mean
reconstruction; a model without a category prior (the VAE, AE and
``kitti_inst_only`` configs) has no class anchors for the sweep and raises
``ValueError``, as the JAX command does. ``--latents-out f.npy`` writes the
per-class mean latents (``category_vectors``) instead, for any config: the
anchors that ``cli.export --prior-means`` bakes into such a model's serving
program (its batches carry the class labels; the JAX command's omit them
for a model without a category prior or width and fail there). ``--dump
dir/`` writes GT and decoded grids per missing rate (``evaluation/dump.py``).

``--ckpt`` restores the parameters of a checkpoint of ``cli.train
--save-path`` (``train/checkpoint.py``); ``--weights`` takes flax params as a
flat ``.npz`` (``convert.load_flax_npz``); without either the model holds
seeded random weights (``--seed``). ``--data synthetic`` evaluates on
procedural voxels (the eval split of ``cli.train``), a path on the eval
split ``cli.train`` reads there (the ModelNet test shards, the Pascal3D val
crops, or the KITTI val crops with ``--cad-path``), sent as packed bits, the
config rebuilt at a dataset's class count as ``cli.train`` rebuilds it; an
image config's images are ``--image-size`` pixels square (64 by default). The device defaults to ``cuda``; when
CUDA is absent the command fails rather than run on the CPU.
"""

from __future__ import annotations

import argparse
import json


def parse_args(argv=None):
    from anytime3d_tpu_torch.models.configs import REGISTRY

    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", required=True, choices=sorted(REGISTRY))
    p.add_argument("--weights", default=None, help="flax params as a flat .npz")
    p.add_argument("--ckpt", default=None, help="a checkpoint directory of cli.train --save-path")
    p.add_argument("--seed", type=int, default=0, help="seed of the random weights")
    p.add_argument("--data", default="synthetic",
                   help="'synthetic', or a ModelNet (voxel configs), Pascal3D (image configs) or KITTI path")
    p.add_argument("--cad-path", default=None, help="CAD voxel dir (KITTI configs)")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--batches", type=int, default=8)
    p.add_argument("--rates", default="0.3,0.5,0.7,0.9")
    p.add_argument("--image-size", type=int, default=64, help="side of the square renders an image config reads")
    p.add_argument("--latents-out", default=None, help="write per-class mean latents (category_vectors) to .npy")
    p.add_argument("--dump", default=None, help="dump GT/pred voxel grids per missing rate to this dir")
    p.add_argument("--bf16", action="store_true", help="bfloat16 compute dtype (float32 parameters)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    import numpy as np
    import torch

    from anytime3d_tpu_torch.cli.train import build_batch_fn, build_loaders, dataset_variant
    from anytime3d_tpu_torch.convert import load_flax_npz
    from anytime3d_tpu_torch.data.prefetch import to_device
    from anytime3d_tpu_torch.evaluation.dump import dump_reconstructions
    from anytime3d_tpu_torch.evaluation.protocols import category_vectors, missing_rate_sweep, pr_curve
    from anytime3d_tpu_torch.models.configs import REGISTRY
    from anytime3d_tpu_torch.models.mmvae import MultiModalVAE
    from anytime3d_tpu_torch.train.checkpoint import restore_params
    from anytime3d_tpu_torch.train.step import materialize_batch

    args = parse_args(argv)
    if args.ckpt and args.weights:
        raise SystemExit("pass --ckpt or --weights, not both")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but CUDA is not available (pass --device cpu to evaluate on the CPU)")
    cfg = REGISTRY[args.config]()
    _, loader = build_loaders(args, cfg)
    cfg, _ = dataset_variant(args.config, cfg, None, loader)
    model = MultiModalVAE(cfg, generator=torch.Generator().manual_seed(args.seed),
                          dtype=torch.bfloat16 if args.bf16 else torch.float32)
    if args.weights:
        model.load_state_dict(load_flax_npz(args.weights))
    if args.ckpt:
        model.load_state_dict(restore_params(args.ckpt, model.state_dict()))
    model = model.to(device).eval()
    image_size = (args.image_size, args.image_size) if cfg.encoder == "image" else None
    batch_fn = build_batch_fn(loader, cfg, args.batch_size, packed=True, native=True if device.type == "cuda" else None,
                              image_size=image_size, category=True if args.latents_out else None)

    if args.latents_out:
        vecs = category_vectors(model, batch_fn, num_classes=cfg.category_dim or 40, num_batches=args.batches)
        np.save(args.latents_out, vecs)
        print(f"wrote {vecs.shape} category vectors to {args.latents_out}")
        return vecs

    rates = [float(r) for r in args.rates.split(",")]
    if args.dump:
        paths = dump_reconstructions(model, batch_fn(0), args.dump, rates=rates)
        print(f"dumped reconstructions for rates {rates} to {args.dump}")
        return paths

    table = missing_rate_sweep(model, batch_fn, rates=rates, num_batches=args.batches)
    print(json.dumps({str(k): v for k, v in table.items()}, indent=2))

    with torch.no_grad():  # the posterior-mean reconstruction, in the model's layout
        batch, blocked_in, blocked_out = materialize_batch(model, to_device(batch_fn(0), device))
        pred = model.decode(model.encode(batch["input"], blocked_input=blocked_in).mean, blocked_output=blocked_out)
    curve = pr_curve(batch["target"], pred)
    best = int(curve["iou"].argmax())
    print(f"best decode threshold {curve['threshold'][best]:.2f} iou {curve['iou'][best]:.4f}")
    return table, curve


if __name__ == "__main__":
    main()
