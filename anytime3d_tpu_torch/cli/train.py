"""Training CLI.

    python -m anytime3d_tpu_torch.cli.train --config modelnet_nolbo --data synthetic --packed --bf16
    python -m anytime3d_tpu_torch.cli.train --config modelnet_nolbo --data <modelnet dir> --save-path ckpt/
    python -m anytime3d_tpu_torch.cli.train --config pascal_nolbo --bf16 --image-size 64 [--multi-scale 64,96]
    python -m anytime3d_tpu_torch.cli.train --config pascal_nolbo --data <Pascal3D dir> --bf16
    python -m anytime3d_tpu_torch.cli.train --config kitti_inst_only --data <KITTI dir> --cad-path <CAD/car> --bf16

``--data synthetic`` trains on procedural voxels, or for an image config
(``pascal_*``, ``kitti_*``) on their renders at ``--image-size`` (square;
``--multi-scale`` walks a list of square sizes three steps each, in an order
reshuffled every round; image batches ship dense voxel targets, as in the JAX
command, and ``--packed`` concerns voxel configs only). A path trains a voxel
config on the pre-voxelized ModelNet shards under it
(``<path>/32to64_4rot_64sqr/{train,test}``, every shard present) and
evaluates on its test split (``--swap-splits``: the other way round); an image
config on the Pascal3D crops under it (``Pascal3DSingleObjectLoader``, train
and val splits), or for a ``kitti`` config on the KITTI crops under it with
the CAD voxels of ``--cad-path`` (``KittiSingleObjectLoader``). Where a
dataset defines another class count than the config's ``category_dim``, the
config is rebuilt at the dataset's. ``--save-path`` checkpoints the full train state
(parameters, Adam state, step) every ``--save-every`` steps and at the end;
``--load-path`` resumes from such a checkpoint. The device defaults to
``cuda``; when CUDA is absent the command fails rather than train on the
CPU. ``--bf16`` computes in bfloat16 with float32 parameters, losses and
optimizer. Batches are made on a prefetch thread two steps ahead; on CUDA,
``--packed`` batches of a blocked-IO model are packed by the native packer,
and the run fails if ``g++`` cannot build it. Each eval reports the losses, P/R and the anytime
protocol's metrics at missing rate 0.5 (``anytime_*``).

``--mesh`` trains data-parallel, one process a device: start one process a
device with ``COORDINATOR_ADDRESS`` (host:port of rank 0),
``NUM_PROCESSES`` and ``PROCESS_ID`` set (``parallel/multihost.py``); without
them the run is one rank. The ranks join over NCCL on CUDA (gloo with
``--device cpu``), each makes the same global batch of ``--batch-size``
and keeps its rows, and each step equals the single-device step on the
global batch.
"""

from __future__ import annotations

import argparse

import numpy as np


def build_batch_fn(loader, model_cfg, batch_size: int = 32, packed: bool = False, native=None, image_size=None,
                   multi_scale=None, category=None):
    """Adapt a loader to the train step's batch dict of numpy arrays: the
    modelnet-style dict batches (``input_images``, ``class_list``,
    ``inst_list``), the Pascal-style 6-tuples ``(inst, cls, sin, cos,
    images, voxels)`` of the image loaders and the KITTI 5-tuples ``(inst,
    sin, cos, images, voxels)``, which carry no class. ``packed`` ships the voxels as
    bits, pre-ordered in the blocked layout where the model reads it (the
    input of a blocked-IO model, the target of a blocked-tail decoder), so
    the device unpacks with no relayout; ``native`` is
    ``pack_voxels_blocked``'s choice of packer. Image loaders are asked for
    ``image_size`` = (cols, rows), or with ``multi_scale``, a list of (rows,
    cols, batch), for the size and batch of ``multi_scale_schedule``. Spans:
    ``batch.load`` (the loader's batch), ``batch.pack`` (the packer, or the
    float32 casts of dense grids, and the one-hots)."""
    from anytime3d_tpu_torch.data.packing import pack_voxels, pack_voxels_blocked
    from anytime3d_tpu_torch.models.mmvae import blocked_io_block, decoder_blocked_block
    from anytime3d_tpu_torch.train.trainer import multi_scale_schedule
    from anytime3d_tpu_torch.utils.profiling import span

    block, dec_block = blocked_io_block(model_cfg), decoder_blocked_block(model_cfg)
    wants_category = model_cfg.prior_category is not None or model_cfg.category_dim
    if category is not None:
        wants_category = category

    def batch_fn(it: int):
        size, bs = image_size, batch_size
        if multi_scale:
            rows, cols, bs = multi_scale_schedule(multi_scale, it)
            size = (cols, rows)
        with span("batch.load"):
            b = loader.getNextBatch(bs) if size is None else loader.getNextBatch(bs, imageSize=size)
        with span("batch.pack"):
            return _pack(b)

    def _pack(b):
        if isinstance(b, dict):
            if not packed:
                out = {"input": np.asarray(b["input_images"], np.float32)}
            elif block is not None:
                out = {"input_packed_blocked": pack_voxels_blocked(b["input_images"], block, native)}
            else:
                out = {"input_packed": pack_voxels(b["input_images"])}
            cls, inst = b["class_list"], b["inst_list"]
        else:
            if len(b) == 5:
                inst, _sin, _cos, images, voxels = b
                cls = None
            elif len(b) == 6:
                inst, cls, _sin, _cos, images, voxels = b
            else:
                raise ValueError(f"loader tuples of {len(b)}: the Pascal loader's are 6, the KITTI loader's 5")
            out = {"input": np.asarray(images)}
            if not packed:
                out["target"] = np.asarray(voxels, np.float32)
            elif dec_block is not None:
                out["target_packed_blocked"] = pack_voxels_blocked(voxels, dec_block, native)
            else:
                out["target_packed"] = pack_voxels(voxels)
        if wants_category and cls is not None:
            out["category_onehot"] = np.asarray(cls, np.float32)
        if model_cfg.inst_dim:
            out["inst_onehot"] = np.asarray(inst, np.float32)
        return out

    return batch_fn


def build_loaders(args, model_cfg):
    """(train, eval) loaders: procedural shapes (rendered to images for an
    image config) for ``--data synthetic``; else the ModelNet train and test
    shards under the path (every shard present) for a voxel config, the
    KITTI train and val crops with ``--cad-path``'s CAD voxels for a
    ``kitti`` config, and the Pascal3D train and val crops for another
    image config."""
    from anytime3d_tpu_torch.data.kitti import KittiSingleObjectLoader
    from anytime3d_tpu_torch.data.modelnet import ModelNetLoader, SyntheticImageObjectLoader, SyntheticVoxelLoader
    from anytime3d_tpu_torch.data.pascal3d import Pascal3DSingleObjectLoader

    if args.data != "synthetic":
        if "kitti" in args.config:
            cad = getattr(args, "cad_path", None)
            if cad is None:
                raise SystemExit("KITTI configs need --cad-path (64^3 CAD .npy dir)")
            return KittiSingleObjectLoader(args.data, cad, "train"), KittiSingleObjectLoader(args.data, cad, "val")
        if model_cfg.encoder == "image":
            return Pascal3DSingleObjectLoader(args.data, "train"), Pascal3DSingleObjectLoader(args.data, "val")
        return (ModelNetLoader(args.data, "train", partial_num=None),
                ModelNetLoader(args.data, "test", partial_num=None))
    n_cls = model_cfg.category_dim if model_cfg.category_dim else 40
    n_inst = model_cfg.inst_dim if model_cfg.inst_dim else 10
    dim = model_cfg.decoder.output_shape[0]
    make = SyntheticImageObjectLoader if model_cfg.encoder == "image" else SyntheticVoxelLoader
    return (
        make(num_samples=1024, dim=dim, num_classes=n_cls, num_inst=n_inst),
        make(num_samples=256, dim=dim, num_classes=n_cls, num_inst=n_inst, seed=1),
    )


def dataset_variant(name: str, model_cfg, loss_cfg, loader):
    """``(model_cfg, loss_cfg)`` of ``name`` at the class count of
    ``loader``'s ``class_index`` where it has one that differs from the
    config's ``category_dim`` (a Pascal3D subset), else as given."""
    from anytime3d_tpu_torch.models import configs

    n_data_cls = len(getattr(loader, "class_index", ()) or ())
    if n_data_cls and model_cfg.category_dim and n_data_cls != model_cfg.category_dim:
        print(f"dataset defines {n_data_cls} classes (config default {model_cfg.category_dim}) — resizing")
        return configs.variant(name, category_dim=n_data_cls)
    return model_cfg, loss_cfg


def build_trainer(args):
    """The model, its train state and the ``Trainer`` that ``main`` runs, from parsed arguments."""
    import torch

    from anytime3d_tpu_torch.models import configs
    from anytime3d_tpu_torch.models.mmvae import MultiModalVAE
    from anytime3d_tpu_torch.train.state import create_train_state
    from anytime3d_tpu_torch.train.trainer import Trainer, TrainerConfig

    from anytime3d_tpu_torch.parallel import make_mesh, mesh_device

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but CUDA is not available (pass --device cpu to train on the CPU)")
    if args.mesh:  # join the ranks first: on CUDA each takes its own device
        device = mesh_device(make_mesh(device=device))
    model_cfg, loss_cfg = configs.variant(args.config)
    loader, eval_loader = build_loaders(args, model_cfg)
    if args.swap_splits:
        loader, eval_loader = eval_loader, loader
    model_cfg, loss_cfg = dataset_variant(args.config, model_cfg, loss_cfg, loader)
    model = MultiModalVAE(model_cfg, generator=torch.Generator().manual_seed(0),
                          dtype=torch.bfloat16 if args.bf16 else torch.float32).to(device)
    native = True if device.type == "cuda" else None  # on the card the native packer or nothing
    image = model_cfg.encoder == "image"
    # image batches ship dense targets, as the JAX command sends them
    packed = args.packed and not image
    size = (args.image_size, args.image_size) if image else None
    schedule = None
    if args.multi_scale and image:
        schedule = [(int(s), int(s), args.batch_size) for s in args.multi_scale.split(",")]
    trainer = Trainer(
        model,
        create_train_state(model, learning_rate=args.learning_rate),
        build_batch_fn(loader, model_cfg, args.batch_size, packed, native, size, schedule),
        loss_config=loss_cfg,
        eval_batch_fn=build_batch_fn(eval_loader, model_cfg, args.batch_size, packed, native, size),
        config=TrainerConfig(total_steps=args.steps, eval_every=args.eval_every, save_every=args.save_every,
                             save_path=args.save_path, load_path=args.load_path, jsonl_path=args.jsonl,
                             use_mesh=args.mesh),
    )
    return trainer, loader


def parse_args(argv=None):
    from anytime3d_tpu_torch.models.configs import REGISTRY

    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", required=True, choices=sorted(REGISTRY))
    p.add_argument("--data", default="synthetic",
                   help="'synthetic', or a ModelNet (voxel configs), Pascal3D (image configs) or KITTI path")
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
    p.add_argument("--image-size", type=int, default=64, help="square image size of image configs")
    p.add_argument("--multi-scale", default=None,
                   help="comma list of square image sizes, e.g. '64,96': the multi-scale schedule of image configs")
    p.add_argument("--cad-path", default=None, help="CAD voxel dir (KITTI configs; Pascal uses --data's CAD/)")
    p.add_argument("--mesh", action="store_true",
                   help="data parallel over every rank of the run, one process a device (see above)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    trainer, loader = build_trainer(parse_args(argv))
    trainer.run(epoch_fn=lambda: loader.epoch)
    print("\ndone; final metrics:", {k: round(v, 4) for k, v in trainer.logger.means().items()})
    return trainer


if __name__ == "__main__":
    main()
