"""Backbone-pretraining CLI: a Darknet classifier trained on class labels.

    python -m anytime3d_tpu_torch.cli.pretrain --data synthetic [--backbone darknet19] [--bf16]
        [--image-size 224] [--batch-size 64] [--steps 1000] [--save-path ckpt/]
    python -m anytime3d_tpu_torch.cli.pretrain --data <dir of one subdirectory a class> --bf16

Counterpart of ``anytime3d_tpu/cli/pretrain.py``, with its flags and
``--device`` (``cuda`` by default; the command fails without CUDA rather
than train on the CPU). ``--data synthetic`` trains on renders of the
procedural shapes (``SyntheticImageObjectLoader``, 1024 samples of 32^3,
``--num-classes`` classes, 10 by default) at ``--image-size`` squared and
evaluates on 256 more (seed 1) every ``--eval-every`` steps, through the
shared train loop (prefetch, checkpoints, NaN restarts). ``--data <dir>``
trains on an ImageNet-layout tree (``ImagenetLoader``: one subdirectory a
class, augmented crops), evaluates on the same loader (the reference
pretrainer has no held-out split) and takes the class count from it unless
``--num-classes`` is given. The checkpoint's ``backbone`` loads into any
image model of the same backbone with
``train/checkpoint.py::graft_submodule(state, path, "backbone")``.
``--mesh`` trains data-parallel, one process a device, as ``cli.train
--mesh`` does (the ranks join through ``COORDINATOR_ADDRESS``,
``NUM_PROCESSES`` and ``PROCESS_ID``; without them the run is one rank).
"""

from __future__ import annotations

import argparse

import numpy as np


def build_batch_fn(loader, batch_size: int, image_size: int):
    """``batch_fn(step)`` of ``{"images": (B, S, S, 3) float32, "labels": (B, K) one-hot}``
    from the synthetic loader's 6-tuples or the ImageNet loader's ``(images, labels)``."""
    size = (image_size, image_size)

    def batch_fn(_it: int):
        b = loader.getNextBatch(batch_size, imageSize=size)
        images, labels = b if len(b) == 2 else (b[4], b[1])
        return {"images": np.asarray(images, np.float32), "labels": np.asarray(labels, np.float32)}

    return batch_fn


def build_trainer(args):
    """(trainer, loader) from parsed arguments."""
    import torch

    from anytime3d_tpu_torch.data.imagenet import ImagenetLoader
    from anytime3d_tpu_torch.data.modelnet import SyntheticImageObjectLoader
    from anytime3d_tpu_torch.models.classifier import Classifier, ClassifierConfig
    from anytime3d_tpu_torch.train.classifier_step import (
        ClassifierLossConfig,
        make_classifier_eval_step,
        make_classifier_train_step,
    )
    from anytime3d_tpu_torch.train.state import create_train_state
    from anytime3d_tpu_torch.train.trainer import Trainer, TrainerConfig

    from anytime3d_tpu_torch.parallel import make_mesh, mesh_device

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but CUDA is not available (pass --device cpu to train on the CPU)")
    if args.data == "synthetic":
        n_cls = args.num_classes or 10
        loader = SyntheticImageObjectLoader(num_samples=1024, dim=32, num_classes=n_cls)
        eval_loader = SyntheticImageObjectLoader(num_samples=256, dim=32, num_classes=n_cls, seed=1)
    else:
        loader = eval_loader = ImagenetLoader(args.data)
        n_cls = args.num_classes or loader.class_num
    mesh = make_mesh(device=device) if args.mesh else None
    if mesh is not None:  # on CUDA each rank takes its own device
        device = mesh_device(mesh)
    model = Classifier(ClassifierConfig(num_classes=n_cls, backbone=args.backbone),
                       generator=torch.Generator().manual_seed(0),
                       dtype=torch.bfloat16 if args.bf16 else torch.float32).to(device)
    loss_cfg = ClassifierLossConfig()
    trainer = Trainer(
        model,
        create_train_state(model, learning_rate=args.learning_rate),
        build_batch_fn(loader, args.batch_size, args.image_size),
        eval_batch_fn=build_batch_fn(eval_loader, args.batch_size, args.image_size),
        config=TrainerConfig(total_steps=args.steps, eval_every=args.eval_every, save_every=args.save_every,
                             save_path=args.save_path, load_path=args.load_path, jsonl_path=args.jsonl,
                             use_mesh=args.mesh),
        step_fn=make_classifier_train_step(model, loss_cfg, mesh=mesh),
        eval_fn=make_classifier_eval_step(model, loss_cfg, mesh=mesh),
    )
    return trainer, loader


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data", default="synthetic", help="'synthetic' or an ImageNet-layout directory")
    p.add_argument("--backbone", default="darknet19", choices=("darknet19", "darknet53", "darknet53tiny"))
    p.add_argument("--num-classes", type=int, default=None, help="defaults to the dataset's class count")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--learning-rate", type=float, default=1e-4)
    p.add_argument("--save-path", default=None, help="checkpoint directory of the full train state")
    p.add_argument("--load-path", default=None, help="resume from this checkpoint directory")
    p.add_argument("--jsonl", default=None, help="append one JSON line of metrics per logged step")
    p.add_argument("--save-every", type=int, default=1000)
    p.add_argument("--eval-every", type=int, default=200)
    p.add_argument("--bf16", action="store_true", help="bfloat16 compute dtype (float32 parameters)")
    p.add_argument("--mesh", action="store_true", help="data parallel over every rank of the run, one process a device")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    trainer, loader = build_trainer(parse_args(argv))
    trainer.run(epoch_fn=lambda: loader.epoch)
    print("\ndone; final metrics:", {k: round(v, 4) for k, v in trainer.logger.means().items()})
    return trainer


if __name__ == "__main__":
    main()
