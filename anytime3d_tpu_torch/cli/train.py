"""Training CLI.

    python -m anytime3d_tpu_torch.cli.train --config modelnet_nolbo --data synthetic --packed --bf16
    python -m anytime3d_tpu_torch.cli.train --config modelnet_nolbo --data <modelnet dir> --save-path ckpt/

``--data synthetic`` trains on procedural voxels; a path trains on the
pre-voxelized ModelNet shards under it (``<path>/32to64_4rot_64sqr/{train,test}``,
every shard present) and evaluates on its test split (``--swap-splits``:
the other way round). ``--save-path`` checkpoints the full train state
(parameters, Adam state, step) every ``--save-every`` steps and at the end;
``--load-path`` resumes from such a checkpoint. The device defaults to
``cuda``; when CUDA is absent the command fails rather than train on the
CPU. ``--bf16`` computes in bfloat16 with float32 parameters, losses and
optimizer. Batches are made on a prefetch thread two steps ahead; on CUDA,
``--packed`` batches of a blocked-IO model are packed by the native packer,
and the run fails if ``g++`` cannot build it. Each eval reports the losses, P/R and the anytime
protocol's metrics at missing rate 0.5 (``anytime_*``).
"""

from __future__ import annotations

import argparse

import numpy as np


def build_batch_fn(loader, model_cfg, batch_size: int = 32, packed: bool = False, native=None):
    """Adapt a loader of modelnet-style dict batches (``input_images``,
    ``class_list``, ``inst_list``) to the train step's batch dict of numpy
    arrays. ``packed`` ships the voxels as bits, pre-ordered in the blocked
    layout when the model reads it, so the device unpacks with no relayout;
    ``native`` is ``pack_voxels_blocked``'s choice of packer."""
    from anytime3d_tpu_torch.data.packing import pack_voxels, pack_voxels_blocked
    from anytime3d_tpu_torch.models.mmvae import blocked_io_block

    block = blocked_io_block(model_cfg)

    def batch_fn(_it: int):
        b = loader.getNextBatch(batch_size)
        if not isinstance(b, dict):
            raise NotImplementedError("not ported yet: the tuple batches of the image loaders")
        if not packed:
            out = {"input": np.asarray(b["input_images"], np.float32)}
        elif block is not None:
            out = {"input_packed_blocked": pack_voxels_blocked(b["input_images"], block, native)}
        else:
            out = {"input_packed": pack_voxels(b["input_images"])}
        if model_cfg.prior_category is not None or model_cfg.category_dim:
            out["category_onehot"] = np.asarray(b["class_list"], np.float32)
        if model_cfg.inst_dim:
            out["inst_onehot"] = np.asarray(b["inst_list"], np.float32)
        return out

    return batch_fn


def build_loaders(args, model_cfg):
    """(train, eval) loaders: procedural shapes for ``--data synthetic``, else
    the ModelNet train and test shards under the path (every shard present)."""
    from anytime3d_tpu_torch.data.modelnet import ModelNetLoader, SyntheticVoxelLoader

    if args.data != "synthetic":
        if model_cfg.encoder != "voxel" or "kitti" in args.config:
            raise NotImplementedError("not ported yet (A14/A15): the Pascal3D and KITTI loaders")
        return (ModelNetLoader(args.data, "train", partial_num=None),
                ModelNetLoader(args.data, "test", partial_num=None))
    n_cls = model_cfg.category_dim if model_cfg.category_dim else 40
    n_inst = model_cfg.inst_dim if model_cfg.inst_dim else 10
    dim = model_cfg.decoder.output_shape[0]
    return (
        SyntheticVoxelLoader(num_samples=1024, dim=dim, num_classes=n_cls, num_inst=n_inst),
        SyntheticVoxelLoader(num_samples=256, dim=dim, num_classes=n_cls, num_inst=n_inst, seed=1),
    )


def build_trainer(args):
    """The model, its train state and the ``Trainer`` that ``main`` runs, from parsed arguments."""
    import torch

    from anytime3d_tpu_torch.models import configs
    from anytime3d_tpu_torch.models.mmvae import MultiModalVAE
    from anytime3d_tpu_torch.train.state import create_train_state
    from anytime3d_tpu_torch.train.trainer import Trainer, TrainerConfig

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but CUDA is not available (pass --device cpu to train on the CPU)")
    model_cfg, loss_cfg = configs.variant(args.config)
    model = MultiModalVAE(model_cfg, generator=torch.Generator().manual_seed(0),
                          dtype=torch.bfloat16 if args.bf16 else torch.float32).to(device)
    loader, eval_loader = build_loaders(args, model_cfg)
    if args.swap_splits:
        loader, eval_loader = eval_loader, loader
    native = True if device.type == "cuda" else None  # on the card the native packer or nothing
    trainer = Trainer(
        model,
        create_train_state(model, learning_rate=args.learning_rate),
        build_batch_fn(loader, model_cfg, args.batch_size, args.packed, native),
        loss_config=loss_cfg,
        eval_batch_fn=build_batch_fn(eval_loader, model_cfg, args.batch_size, args.packed, native),
        config=TrainerConfig(total_steps=args.steps, eval_every=args.eval_every, save_every=args.save_every,
                             save_path=args.save_path, load_path=args.load_path, jsonl_path=args.jsonl),
    )
    return trainer, loader


def parse_args(argv=None):
    from anytime3d_tpu_torch.models.configs import REGISTRY

    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", required=True, choices=sorted(REGISTRY))
    p.add_argument("--data", default="synthetic", help="'synthetic' or a ModelNet dataset path")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--learning-rate", type=float, default=1e-4)
    p.add_argument("--jsonl", default=None, help="append one JSON line of metrics per logged step")
    p.add_argument("--eval-every", type=int, default=200)
    p.add_argument("--save-path", default=None, help="checkpoint directory of the full train state")
    p.add_argument("--load-path", default=None, help="resume from this checkpoint directory")
    p.add_argument("--save-every", type=int, default=1000)
    p.add_argument("--swap-splits", action="store_true", help="train on the eval split and evaluate on train")
    p.add_argument("--bf16", action="store_true", help="bfloat16 compute dtype (float32 parameters)")
    p.add_argument("--packed", action="store_true", help="bit-pack voxel batches host->device (32x less transfer)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    trainer, loader = build_trainer(parse_args(argv))
    trainer.run(epoch_fn=lambda: loader.epoch)
    print("\ndone; final metrics:", {k: round(v, 4) for k, v in trainer.logger.means().items()})
    return trainer


if __name__ == "__main__":
    main()
