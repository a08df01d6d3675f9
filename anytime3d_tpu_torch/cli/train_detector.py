"""Training CLI of the multi-object detector-reconstructor.

    python -m anytime3d_tpu_torch.cli.train_detector --data synthetic [--bf16] [--steps 1000]
        [--image-size COLS ROWS] [--grid-size COLS ROWS] [--voxel-dim 32] [--max-objects 3]
        [--max-detections 16] [--save-path ckpt/]

Trains ``DetectorReconstructor`` (Darknet19, the 1024-wide grid head, 5
predictors a cell, z = 16 with log-variance, the pixel-shuffle decoder at
``--voxel-dim``) with ``train/detector_step.py`` through the shared train
loop (prefetch, checkpoints, NaN restarts), then evaluates detection on 2
more batches. ``--data synthetic`` trains on synthetic multi-object scenes
(``SyntheticMultiObjectLoader``), a path on the Pascal3D train split under
it (``Pascal3DMultiObjectLoader``: the images holding a car, at
``--image-size`` on a ``--grid-size`` grid; its CAD voxels are 64^3, so
``--voxel-dim 64``). Counterpart of ``anytime3d_tpu/cli/train_detector.py``, with its
flags, and ``--max-objects``, ``--max-detections`` (the JAX CLI's fixed
3 and 16 by default; the reference-scale run takes 6 and 32) and
``--device`` (``cuda`` by default; the command fails without CUDA rather
than train on the CPU). Training batches travel as uint8 images and
bit-packed voxels. ``--mesh`` trains data-parallel, one process a device,
as ``cli.train --mesh`` does; the detection eval then runs on each rank's
model, which every rank holds whole.
"""

from __future__ import annotations

import argparse

import numpy as np


def build_batch_fn(loader, batch_size: int, max_slots: int):
    """``batch_fn(step)`` of collated multi-object batches (numpy): float
    images and voxels, what ``evaluate_detector`` reads."""
    from anytime3d_tpu_torch.data.collate import collate_multiobject

    def batch_fn(_it: int):
        images, targets, voxel_lists = loader.getNextBatch(batch_size)
        return collate_multiobject(images, targets, voxel_lists, max_slots=max_slots)

    return batch_fn


def transfer_forms(batch: dict) -> dict:
    """A collated batch as the trainer ships it to the device: uint8 images
    (truncated from [0, 1]) and ``voxels_packed`` bits (B, S, N/8), 32x
    smaller than the float voxels. The train step unpacks both."""
    from anytime3d_tpu_torch.data.packing import pack_voxels

    b = dict(batch)
    vox = b.pop("voxels")
    b["voxels_packed"] = pack_voxels(vox.reshape(vox.shape[0] * vox.shape[1], -1)).reshape(
        vox.shape[0], vox.shape[1], -1)
    b["images"] = (np.clip(b["images"], 0.0, 1.0) * 255).astype(np.uint8)
    return b


def detector_config(voxel_dim: int, max_detections: int = 16):
    """The CLI's model: the default ``DetectorConfig`` with a pixel-shuffle
    decoder to ``voxel_dim``^3 (three stride-2 stages from 32^3 up, two below)."""
    from anytime3d_tpu_torch.models.detector import DetectorConfig
    from anytime3d_tpu_torch.nn.autoencoder3d import Decoder3DConfig

    n_strides = 3 if voxel_dim >= 32 else 2
    decoder = Decoder3DConfig(
        input_dim=16,
        output_shape=(voxel_dim, voxel_dim, voxel_dim, 1),
        filter_nums=(128, 64, 32)[:n_strides] + (1,),
        filter_sizes=(4,) * (n_strides + 1),
        strides=(1,) + (2,) * n_strides,
    )
    return DetectorConfig(decoder=decoder, max_detections=max_detections)


def build_trainer(args):
    """(trainer, loader) from parsed arguments. The trainer ships
    ``transfer_forms`` batches."""
    import torch

    from anytime3d_tpu_torch.data.modelnet import SyntheticMultiObjectLoader
    from anytime3d_tpu_torch.data.pascal3d import Pascal3DMultiObjectLoader
    from anytime3d_tpu_torch.models.detector import DetectorReconstructor
    from anytime3d_tpu_torch.train.detector_step import DetectorLossConfig, make_detector_train_step
    from anytime3d_tpu_torch.train.state import create_train_state
    from anytime3d_tpu_torch.train.trainer import Trainer, TrainerConfig

    from anytime3d_tpu_torch.parallel import make_mesh, mesh_device

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but CUDA is not available (pass --device cpu to train on the CPU)")
    image_size, grid_size = tuple(args.image_size), tuple(args.grid_size)
    if args.data == "synthetic":
        loader = SyntheticMultiObjectLoader(num_samples=1024, dim=args.voxel_dim, image_size=image_size,
                                            grid_size=grid_size, max_objects=args.max_objects)
    else:
        loader = Pascal3DMultiObjectLoader(args.data, "train", image_size=image_size, grid_size=grid_size)
        dims = {v.shape[1] for v in loader.cad_shapes.values()}
        if dims != {args.voxel_dim}:
            raise SystemExit(f"the dataset's CAD voxels are {sorted(dims)}^3: pass --voxel-dim {min(dims)}")
    mesh = make_mesh(device=device) if args.mesh else None
    if mesh is not None:  # on CUDA each rank takes its own device
        device = mesh_device(mesh)
    model = DetectorReconstructor(detector_config(args.voxel_dim, args.max_detections),
                                  generator=torch.Generator().manual_seed(0),
                                  dtype=torch.bfloat16 if args.bf16 else torch.float32).to(device)
    batch_fn = build_batch_fn(loader, args.batch_size, args.max_slots)
    trainer = Trainer(
        model,
        create_train_state(model, learning_rate=args.learning_rate),
        lambda it: transfer_forms(batch_fn(it)),
        config=TrainerConfig(total_steps=args.steps, save_every=args.save_every, save_path=args.save_path,
                             load_path=args.load_path, jsonl_path=args.jsonl, use_mesh=args.mesh),
        step_fn=make_detector_train_step(model, DetectorLossConfig(), mesh=mesh),
    )
    return trainer, loader


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data", default="synthetic", help="'synthetic' or a Pascal3D dataset path")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--image-size", type=int, nargs=2, default=(128, 96), metavar=("COLS", "ROWS"))
    p.add_argument("--grid-size", type=int, nargs=2, default=(4, 3), metavar=("COLS", "ROWS"))
    p.add_argument("--voxel-dim", type=int, default=32)
    p.add_argument("--max-slots", type=int, default=8)
    p.add_argument("--max-objects", type=int, default=3, help="objects a synthetic scene holds at most")
    p.add_argument("--max-detections", type=int, default=16, help="K, the detections a frame keeps")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--learning-rate", type=float, default=1e-4)
    p.add_argument("--save-path", default=None)
    p.add_argument("--load-path", default=None)
    p.add_argument("--jsonl", default=None)
    p.add_argument("--save-every", type=int, default=1000)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--mesh", action="store_true", help="data parallel over every rank of the run, one process a device")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    """Train, then evaluate detection on 2 more batches of the training loader,
    as the JAX CLI does. Returns ``(trainer, detection metrics)``."""
    from anytime3d_tpu_torch.evaluation.detection import evaluate_detector

    args = parse_args(argv)
    trainer, loader = build_trainer(args)
    trainer.run(epoch_fn=lambda: loader.epoch)
    print("\ndone; final metrics:", {k: round(v, 4) for k, v in trainer.logger.means().items()})
    det = evaluate_detector(trainer.model, build_batch_fn(loader, args.batch_size, args.max_slots), num_batches=2)
    print("detection eval:", {k: round(v, 4) for k, v in det.items()})
    return trainer, det


if __name__ == "__main__":
    main()
