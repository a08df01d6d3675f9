"""Smoke run of the PyTorch port (``anytime3d_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; fails at once without them. Phases, in
order, any failure ending the run with a non-zero exit:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compile the ``conv_k2`` CUDA kernels (forward, dx, dw, each as an
   FFMA kernel and as a bfloat16 tensor-core kernel; the forward, dx and dw
   of narrow outputs also as halo-box kernels, on ``mma.sync`` in bfloat16
   and on FFMA in float32) from ``anytime3d_tpu_torch/kernels/csrc``;
3. kernel check: ``conv_k2``, ``conv_k2_dx`` and ``conv_k2_dw`` against their
   plain versions at the flagship stages (16^3): at B=8, the served batch, in
   float32 with TF32 off and in bfloat16, and at B=32, the train step's
   shapes, in both types (cli/train.py computes in float32 unless --bf16);
   each timed with CUDA events beside its plain version and
   beside the one library call that computes the same function (cuDNN
   through ``F.conv3d``, ``torch.nn.grad.conv3d_input`` and
   ``conv3d_weight``), and set against its bound on this card. In bfloat16
   all three must take the tensor-core kernels (``design`` "wgmma"), in
   float32 the FFMA ones; the tensor-core kernels and their plain versions
   are also held against a float64 product of the same operands, dw must
   give the same bits twice, and three bfloat16 shapes off the main path are
   checked, one with a plan (8^3), one without (the FFMA kernels) and one with
   a narrow plan (the narrow forward, dx and dw);
4. full-width slice: ``modelnet_nolbo`` (64^3 voxels, z=64, 40 classes) from
   seeded weights, a batch of 8 seeded occupancy grids with full, partial and
   empty latent masks through ``make_packed_infer`` on the card, held against
   the same weights run on the CPU (float32) and against itself in bfloat16;
   then a few bfloat16 batches served through ``make_packed_infer``, counts
   reset just before: 4 launches a batch, all on the tensor-core forward;
5. train slice: one full-width float32 train step (losses, gradients, the
   guarded Adam update) on the card at a batch of 4 against the same on the CPU, from the same weights, batch and
   injected random draws: every loss term, every leaf's gradient,
   ``grads_finite``;
6. serve: ``InferenceServer`` on an ephemeral port, batch 8, answering HTTP
   requests from 8 client threads; the launch counts are reset just before
   and read just after, and ``conv_k2`` must show 4 per served batch;
7. anytime slice: the anytime protocol (``anytime/engine.py::anytime_eval``)
   on full-width ``modelnet_nolbo`` from seeded weights, a packed-blocked
   batch of 8, in float32 on the card against the same on the CPU with the
   same injected draws, at missing rates 0.0 and 0.5: equal category
   accuracies, loss terms and P/R within tolerance; then in bfloat16 on the
   card against the card's float32. 4 forward launches per clean batch and 6
   per masked one (2 in the encoder head, 2 in each decode's tail), on the
   FFMA kernels in float32 and the tensor-core ones in bfloat16;
8. anytime timing, B=32, bfloat16, packed-blocked synthetic batches (the
   native packer): ``anytime_eval`` at missing 0.5 and 0.0, a
   ``missing_rate_sweep`` over 0.3/0.5/0.7/0.9 (counts reset just before and
   read just after: 6 launches a batch, all on the tensor cores) and a
   ``pr_curve`` with the acceptance tail on one batch's decode, timed;
9. train run: the trainer ``cli/train.py`` builds for ``--config
   modelnet_nolbo --data synthetic --packed --bf16`` at B=32, a few tens of
   steps and one eval, with the trainer's default prefetch depth (2: batches
   made and copied on a worker thread) and the native packer; counts reset
   just before and read just after: 4 forward, 3 dx and 4 dw launches per
   step, 4 forward per eval step and 6 for its anytime pass, every one of
   them on the tensor-core kernels; every train and eval batch through the
   native packer; every metric finite, the ``anytime_*`` metrics present, the
   loss falling, ``grads_finite`` 1; step time, host wall per step and peak
   memory printed; then as many steps again at prefetch depth 0, its host
   wall per step printed beside;
10. lifecycle, on the ModelNet fixtures (``tests/fixtures/modelnet``, 64^3)
   at full width: ``cli/train.py --data <fixtures> --packed --bf16`` at B=4,
   6 steps, checkpoints every 3 and at the end (4 / 3 / 4 launches a step and
   4 + 6 for the eval, all on the tensor cores; the checkpoint's bytes, the
   save's snapshot and commit and the restore timed); the restored state
   equal to the trainer's, bit for bit; ``cli/evaluate.py --ckpt`` equal to
   the trainer's model; one step from the restored state and one from the
   trainer's on the same batch and generator (equal metrics, parameters
   within ``LIFE_TOL_PARAM``); ``cli/export.py`` (f32, float input) and
   ``export_infer`` (bf16, packed) loaded with ``load_infer`` and held to the
   eager program, 4 launches a batch (FFMA in f32, tensor cores in bf16),
   timed beside it; ``cli/serve.py --artifact`` (bf16 packed) in a
   subprocess on an ephemeral port answering HTTP requests, beside
   ``cli/serve.py --checkpoint --bf16`` (the eager ``make_packed_infer``) in
   another, both started and warmed up at once, then each timed alone, every
   reply's class equal to the other server's; the phase's wall time printed;
11. image: full-width ``pascal_nolbo`` (Darknet19 -> category + instance
   latent -> the 64^3 blocked decoder, whose tail runs the k=2 stages 128 ->
   512 and 512 -> 64) from seeded weights on rendered images
   (``SyntheticImageObjectLoader``): served at batch 2 on the card in float32
   against the CPU, one float32 train step at B=2 against the CPU (every
   loss, every gradient leaf) and ``anytime_eval`` at B=4, missing 0.5, with
   injected draws against the CPU (equal accuracies, ``acc_inst`` among
   them); a served batch of 8 at 64x64 in float32 and bfloat16, timed, 2
   launches a batch (FFMA, tensor cores); ``cli/train.py``'s trainer in
   bfloat16 at B=32 on 96x128 images (bench.py's shape) with packed-blocked
   targets, 24 steps from a 256-shape loader (the render cache warm after 8):
   2 / 2 / 2 launches a step, all on the tensor cores, a finite loss, device
   time, host wall and peak memory printed, the host's batch cold and cached
   and the prefetcher's pinned staging under a changing shape timed;
   ``anytime_eval`` at B=32, 64x64, bfloat16, masked and clean, timed (4 and
   2 launches); ``export_infer`` of the float32 image program loaded and held
   to the eager one (2 launches a batch); the phase's wall time printed;
12. detector: ``conv_k2``, dx and dw at the detector decoder's final conv (32
   decodes of 32^3, C=32 -> N=8: no wgmma plan; all three on the narrow
   kernels, on ``mma.sync`` in bfloat16 and on FFMA in float32) against their
   plain versions (the narrow kernels and their plain versions also against a
   float64 product; dw the same bits twice), timed beside cuDNN and their
   bound, and the narrow forward at the scene pass's 1024 decodes; the
   reference-scale detector-reconstructor (Darknet19,
   the 4 x 1024 grid head, 5 predictors of 49 channels, the pixel-shuffle
   decoder to 64^3, K=32) from seeded weights on one 416x416 rendered frame,
   float32 on the card against the CPU: the grid fields, ``detect`` (equal
   ``valid``, boxes within 1e-4), the K slots' shapes and
   ``scene_reconstruction`` (poses, projected corners, ``valid``); the served
   frame, ``export_detector`` in float32 and bfloat16 loaded with
   ``load_infer`` and held to the eager program, 50 frames under
   ``torch.cuda.set_sync_debug_mode("error")`` with 1 launch a frame (narrow
   in both types), timed by events with the host's share; the scene pass at its
   defaults in bfloat16 (1024 decodes, 1 narrow launch), timed, with the lifting and its batched SVD
   timed alone; one float32 train step at B=2 against the CPU (every loss
   term, every gradient leaf, ``grads_finite``; the forward, dx and dw
   narrow); ``cli/train_detector.py``'s
   trainer at the reference scale (bfloat16, B=8, 13x13 grid, up to 6
   objects, packed voxels, uint8 frames), 24 steps, 1 / 1 / 1 launches a
   step (all three narrow), device time, host wall, the host's batch and peak memory printed;
   ``evaluate_detector`` on 2 batches, timed; the bfloat16 step, then the
   default trainer's float32 step at B=8 (1 / 1 / 1 narrow launches a step),
   profiled by kernel; the phase's wall time printed;
13. stem kernels: ``conv_k2`` and dw at the classic encoder's space-to-depth(2)
   stem (32^3, C=8 -> N=64: no wgmma or narrow plan, the FFMA kernels) at B=8
   and B=32 in float32 and bfloat16, against their plain versions and a
   float64 product, timed beside cuDNN and their bound (rows of the
   ``kernels`` line);
14. variants (``phase_variants``): the other ``REGISTRY`` names at full width
   from seeded weights. Each distinct model (``modelnet_vae``,
   ``modelnet_ae``, ``ae3d``, ``modelnet_nolbo_acc``, ``pascal_vae``,
   ``pascal_ae``, ``pascal_nolbo_acc``, ``kitti_inst_only``; a `_dr` name
   builds its base's model): one float32 encode + decode of 2 items on the
   card against the CPU, its ``conv_k2`` launches counted (4, 4, 4, 2, 2, 2,
   0, 2). ``cli/train.py``'s trainer, bf16, B=32, packed synthetic batches,
   ``VARIANT_TRAIN_STEPS`` steps each of ``modelnet_vae_dr``, ``modelnet_ae``,
   ``ae3d``, ``modelnet_nolbo_acc`` (packed-blocked IO through the
   phase-equivalent decoder), ``pascal_ae_dr`` and ``kitti_inst_only`` (the
   image phase's 96x128 images, packed-blocked targets): device ms a step,
   host wall, peak memory, finite losses and gradients, launches 4 / 3 / 4,
   2 / 1 / 2 or 2 / 2 / 2 a step on the tensor cores. A bf16 B=32 train step
   of ``modelnet_nolbo`` in three layouts no name uses
   (``benchmarks/quality_parity.py``'s ``classic`` and ``blocked_dynfix``,
   and the classic encoder on the s2d(2) stem, 1 / 0 / 1 FFMA launches a
   step), device ms each. Serving without class priors: ``modelnet_vae``
   over HTTP with the zero fill (no ``category`` in any reply, empty masks
   read back as zeros; 4 launches a batch); ``cli.evaluate --config
   modelnet_ae --latents-out`` -> ``cli.export --prior-means`` (the artifact
   held to the eager program with the same anchors, 4 launches a batch) ->
   ``cli.serve --artifact`` in a subprocess (float requests, every reply's
   ``category`` that of the in-process program); ``anytime_eval`` at B=32,
   bf16, with those anchors, masked and clean (6 and 4 launches), device ms.
   The phase's wall time printed;
15. pretraining and streaming (``phase_pretrain_stream``): ``cli/pretrain.py``'s
   ``main`` at full width (darknet19 classifier, 224x224, B=64, bf16, 16
   steps and one eval, ``--save-path``; no ``conv_k2`` launch: its convs are
   2-D), device ms a step, host wall, images/s, peak memory, the step alone
   on the card and its host enqueue, the loader's batch cold and cached; the
   trained classifier's f32 logits on the card against the CPU; its
   ``backbone`` grafted into a fresh ``pascal_nolbo`` (``graft_submodule``,
   held bit for bit, every other tensor untouched) and 4 bf16 steps at B=32
   on 64x64 images (2 / 2 / 2 ``wgmma`` launches a step); the structural
   instance shapes (``SyntheticVoxelLoader(structural_inst=True)`` at 64^3,
   every part voxelized natively, none in NumPy), their build time a grid,
   and 10 bf16 steps of ``modelnet_nolbo`` on them at B=32 (4 / 3 / 4); the
   streaming ``AnytimeReconstructor`` on full-width ``modelnet_nolbo`` in
   f32, 32 objects x 8 masked views (``encode_observation``,
   ``observe_stream``, ``classify``, ``correct``, ``decode``,
   ``observe_decoded``; 16 + 2 + 16 FFMA launches), the first 4 objects held
   to the CPU (beliefs, labels, decodes), each call timed. The phase's wall
   time printed;
16. the real-image data path (``phase_real_data``) on the repo's fixtures:
   (a) every fixture PNG read by ``cv2.imread`` on the card's host (the
   loaders' ``imread_color``), each held to the sha256 the CPU tests record
   (``FIXTURE_PNG_SHA256``), the host ms of a read (the fixtures; VOC- and
   KITTI-sized frames written here), which ``cv2``, PIL and ``g++`` are
   there, and whether this ``cv2`` gives the bits of the photometric
   jitter's ``cv2`` calls that the CPU tests saw (``CV2_DIGESTS``: the HSV
   round trip over every colour and the two blurs); (b) the native warp built on this host against its
   NumPy twin on a 375x500 and a 375x1242 frame (within ``AUG_TWIN_TOL``),
   then ms a crop to 64^2 and a frame to 416^2, with and without the
   photometric jitter, none of them on the NumPy twin; (c) ``pascal_nolbo``
   through ``cli/train.py --data tests/fixtures/pascal3d`` (``category_dim``
   resized to the fixture's 2 classes): one f32 step of the full-width model
   on the val crops card against CPU (every loss term and gradient leaf, the
   image phase's tolerances), then ``REAL_STEPS`` bf16 steps at B=32 on
   64x64 crops with packed-blocked targets (2 / 2 / 2 ``wgmma`` launches a
   step); (d) ``kitti_inst_only`` through ``cli/train.py --data
   tests/fixtures/kitti --cad-path``, ``REAL_KITTI_STEPS`` bf16 steps at
   B=32 (2 / 2 / 2); (e) the detector through ``cli/train_detector.py --data
   tests/fixtures/pascal3d`` at 416x416 on a 13x13 grid, B=8, bf16 (1 / 1 / 1
   narrow launches a step), then ``evaluate_detector`` on 2 batches; (f)
   darknet19 pretraining through ``cli/pretrain.py --data`` on an
   ImageNet-layout tree of the fixture PNGs, B=64 at 224^2, bf16; each loop
   with its step alone on the card, the host's enqueue of one, the host wall
   a step, images/s, the loader's batch cold and warm, and which side bounds
   it; (g) ``kmeans_sincos`` and ``orientation_anchors`` (k=30, 1000
   iterations, 8192 seeded Euler triples) card against CPU: assignments
   equal, centres within ``KMEANS_TOL``, each fit's host wall. The phase's
   wall time printed;
17. the mapping geometry and data parallelism (``phase_mapping_dp``): (a)
   ``evaluation/viz.py::draw_scene`` on ``viz_scene()``, its sha256 held to
   the one the CPU tests pin (``VIZ_SHA256``), then on phase 12's f32 scene
   pass, the host ms of a draw; (b) bundle adjustment, P=32 poses, L=8192
   landmarks, f32 on the card: the first step's residuals, Jacobians and
   reduced system against the CPU (``GEOM_TOL``) and its float64 update
   (1e-9), then a 10-step ``solve`` whose mse must fall 20x, ms a step; (c)
   the pose graph, N=64, E=192: the first step against the CPU, 10 steps
   whose cost must fall, ms a step; (d) Harris keypoints (256), descriptors
   and matches on a 375x1242 frame and its shifted copy, card against CPU
   (keypoints and matches equal), ms each; (e) ``two_view_pose`` of 512
   seeded correspondences: R and t against the truth and the CPU, ms; (f)
   ``cli/train.py --mesh`` at one rank (NCCL) against the same run without
   it, ``MESH_STEPS`` bf16 steps at B=32 with cuDNN deterministic: every
   logged metric equal bit for bit, 4 / 3 / 4 ``wgmma`` launches a step,
   the step's device ms beside, the gradient all-reduce's ms in f32 and
   bf16; ``make_train_step_dp`` at one rank against the plain step fed its
   gradients rounded to bf16 (parameters and metrics bit for bit); (g)
   ``fuse_sequence_sharded`` and ``observe_stream(mesh=)`` against
   ``fuse_sequence``; (h) ``cli/pretrain.py --mesh`` and
   ``cli/train_detector.py --mesh`` 2 steps each (the detector 1 / 1 / 1
   narrow launches a step). The process group is destroyed at the end; the
   phase's wall time printed;
18. the ``mid_blocked`` layout (``phase_mid_blocked``): full-width
   ``modelnet_nolbo`` with ``mid_blocked`` on its encoder and decoder (blocked
   head, two folded encoder stages at 8^3 and 4^3, two middle decoder stages
   as k=2 convs and depth-to-space, blocked tail): an f32 served batch of 8
   (8 FFMA launches, 3 of them with the depth split since PR 19; timed on the
   card alone and by the profiler's busy time) and an f32 train step at B=2
   (8 / 7 / 8, 4 forwards and 4 dx split) on the card against the CPU; bf16
   served batches (8 ``wgmma`` launches each, timed beside the default
   layout's 4); ``cli/train.py``'s trainer, bf16, B=32, packed batches,
   ``MID_TRAIN_STEPS`` steps at 8 / 7 / 8 ``wgmma`` launches a step (2 dw a
   step on persistent blocks), then as many of the default layout (4 / 3 /
   4), each step's device ms and host wall; ``conv_k2``, dx and dw at the four
   new stages (8^3 1024 -> 256 and 256 -> 1024, 4^3 2048 -> 512 and 512 ->
   2048, whose boxes span whole batch items) at B=32 in bf16 and f32 and the
   4^3 ones and 8^3 1024 -> 256 at B=8 in both types, against their plain
   versions (bf16 also float64 products), timed by events and on the card
   alone beside cuDNN's k=2 call and their bound, the bf16 forward and dx also
   on the other tile height (the same bits), the split forward and dx against
   their plans unsplit (bf16 and f32), the persistent dw against the grid
   kernel; the cuDNN k=4 s=2 conv or transposed conv
   each stage replaces, beside the stage's ``mid_blocked`` layer, forward
   and forward + backward (a record); ``SubpixelDeconv3D`` at 16^3, 64 -> 64,
   against its plain version and ``ConvTransposeEquiv3D`` on the same weight;
   a bf16 step with ``create_train_state(flat_opt=True)`` beside the per-leaf
   Adam (one update from the same gradients compared, the update alone and
   the step timed). The phase's wall time printed;
19. tensor parallelism (``phase_tensor_parallel``): (a) ``conv_k2``, dx and dw
   at the four shard shapes of the flagship's k=2 stages over a model axis of
   2 (16^3, 64 -> 256, 512 -> 64, 128 -> 256, 512 -> 32) at B=32 in bfloat16
   and float32, against their plain versions (bf16 ``wgmma`` ones also
   against float64), timed by events and on the card alone beside cuDNN's
   k=2 call and their bound, each row with its route (512 -> 32 has no
   tensor-core plan: in bfloat16 its forward and dw walk C in chunks of 64
   on the narrow kernels, its dx takes the chunked dx on the tensor cores; in
   float32 its forward walks C in chunks of 16 on FFMA, dx and dw keep the
   FFMA GEMM); (b) full-
   width ``modelnet_nolbo`` over a ("data", "model") mesh of 1 x 2 as two
   processes on this one card (``python3 chip_smoke.py --tp-rank <dir>``
   each, ``initialize(backend="gloo")`` on the card's tensors, the model
   sharded by ``parallel.parallelize``): the f32 step at B=8 against the
   1-rank step run here first on the same weights, batch and draws (metrics
   and parameters after Adam at ``dryrun_multichip``'s tolerances, the
   gathered gradients within ``TP_TOL_GRAD_REL`` of each leaf's largest
   entry; both ranks' gathered parameters the same bits), then
   ``TP_WARMUP`` + ``TP_STEPS`` bf16 steps at B=32 (4 / 3 / 4 launches a
   step a rank, 3 / 2 / 3 of them ``wgmma``), each rank's device ms, host
   wall and peak memory, the model axis's all-reduces timed over
   ``TP_PROBE_STEPS`` more steps, beside the 1-rank bf16 step. Both ranks
   share one card's SMs and gloo stages through host memory: the phase shows
   correctness at full width and the shard kernels' own times, not a
   two-card step's. A rank that fails fails the run. The phase's wall time
   printed.

The last two lines of standard output are a JSON object of kernel results
and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import base64
import collections
import concurrent.futures
import copy
import dataclasses
import http.client
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import torch.nn.functional as F  # noqa: E402

from anytime3d_tpu_torch.anytime.engine import anytime_eval  # noqa: E402
from anytime3d_tpu_torch.cli import train as cli_train  # noqa: E402
from anytime3d_tpu_torch.data.imagenet import ImagenetLoader  # noqa: E402
from anytime3d_tpu_torch.data.modelnet import SyntheticImageObjectLoader, SyntheticVoxelLoader  # noqa: E402
from anytime3d_tpu_torch.data.pascal3d import Pascal3DMultiObjectLoader  # noqa: E402
from anytime3d_tpu_torch.data.packing import (  # noqa: E402
    pack_voxels,
    pack_voxels_blocked,
    pack_voxels_device,
    unpack_voxels,
)
from anytime3d_tpu_torch.data.prefetch import to_device  # noqa: E402
from anytime3d_tpu_torch.evaluation.protocols import missing_rate_sweep, pr_curve  # noqa: E402
from anytime3d_tpu_torch.kernels import build  # noqa: E402
from anytime3d_tpu_torch.kernels.conv_k2 import (  # noqa: E402
    chunked_dx_plan,
    conv_k2,
    conv_k2_dw,
    conv_k2_dw_reference,
    conv_k2_dx,
    conv_k2_dx_reference,
    conv_k2_reference,
    ffma_dw_fitted,
    ffma_split,
    narrow_dw_plan,
    narrow_plan,
    wgmma_plan,
    wide_plan,
)
from anytime3d_tpu_torch.kernels.conv_k4s2 import conv_k4s2, lowering_plans  # noqa: E402
from anytime3d_tpu_torch.models import configs  # noqa: E402
from anytime3d_tpu_torch.models.configs import REGISTRY  # noqa: E402
from anytime3d_tpu_torch.models.mmvae import MultiModalVAE  # noqa: E402
from anytime3d_tpu_torch.nn.blocks import depth_to_space3d  # noqa: E402
from anytime3d_tpu_torch.serving.export import make_infer_fn, make_packed_infer  # noqa: E402
from anytime3d_tpu_torch.serving.server import InferenceServer  # noqa: E402
from anytime3d_tpu_torch.train.state import create_train_state  # noqa: E402
from anytime3d_tpu_torch.train.step import apply_gradients_if_finite, compute_losses, materialize_batch  # noqa: E402
from anytime3d_tpu_torch.utils.timing import (  # noqa: E402
    busy_ms,
    card_line,
    cuda_ms,
    device_ms,
    host_enqueue_ms,
    kernel_rows,
    profile_rows,
)

BATCH = 8
TRAIN_BATCH = 32
TRAIN_SLICE_BATCH = 4  # the float32 step that is also run on the CPU
TRAIN_STEPS = 40
TRAIN_WARMUP = 5  # steps left out of the step time
GRID = 16  # the flagship k=2 stages run at 16^3
FLAGSHIP_K2 = [(64, 512), (512, 128), (128, 512), (512, 64)]  # (C, N): encoder head, decoder tail
# (label, batch, dtype) of the kernel check: the served batch and the train step's shapes, in both types
KERNEL_CASES = [("b8_f32", BATCH, torch.float32), ("b8_bf16", BATCH, torch.bfloat16),
                ("b32_bf16", TRAIN_BATCH, torch.bfloat16), ("b32_f32", TRAIN_BATCH, torch.float32)]
SEED = 0
N_REQUESTS = 1024  # p99 then has 10 samples beyond it
N_CLIENTS = 8

# Published dense peaks of one H100 SXM (NVIDIA's data sheet), for the bounds:
# device memory 3.35 TB/s; 989 TFLOP/s in bf16 on the tensor cores; 67 TFLOP/s
# in float32 outside them (the float32 comparisons here are true float32).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# Tolerances, each with its reason.
# f32 kernel vs cuDNN f32 (TF32 off): only the summation order differs; at
# depth <= 4096 with O(1) outputs that is ~1e-5, so 1e-4 leaves 10x room.
K2_TOL_F32 = 1e-4
# bf16: both sides read the same bf16 operands and round an f32 sum once to
# bf16 (2^-8 relative); allow 2 ulps at the largest output.
K2_TOL_BF16_REL = 2.0**-7
# dw is an f32 sum of up to 131072 products on both sides, taken in another
# order; relative to the largest entry of dw. For the FFMA kernel.
K2_TOL_DW_REL = 1e-5
# dw on the tensor cores, and its plain version, each against the float64 sum
# of the same bf16 products, relative to the largest entry: see
# K2_TOL_DW_F64_NOTE. Kernel against plain version: twice that.
K2_TOL_DW_F64_REL = 1e-4
K2_TOL_DW_F64_NOTE = ("the products of bf16 operands are exact in f32; the tensor cores add them to the f32 "
                      "accumulator 16 deep at a time without rounding to nearest, a chain of up to 1024 such adds "
                      "a split (1024 * 2^-24 = 6e-5 at worst), where fmaf rounds each add")
# the f32 forward and dx, kernel and plain version, against the float64 product
# of the same f32 operands: f32 sums of at most 256 products (2^-24 each add),
# relative to the largest entry
K2_TOL_F32_F64_REL = 1e-5
SERVE_BF16_BATCHES = 5
# train step, card f32 vs CPU f32 of the same weights, batch and draws: the
# loss terms are sums of 262144 voxel terms a sample (summation order); the
# gradients go back through ~20 layers, relative to each leaf's largest entry.
TRAIN_TOL_LOSS_REL = 1e-4
TRAIN_TOL_GRAD_REL = 1e-3
# card f32 vs CPU f32 of the same weights: summation order again, over ~20
# layers with depths up to 32768 (the final k=4 conv); values are O(1).
SLICE_TOL_F32 = 1e-3
# pred_packed bits may flip only where pred lies within rounding of 0.5.
SLICE_BITS_TOL = 1e-4
# card bf16 vs card f32: bf16 keeps 8 bits of mantissa through every layer.
SLICE_TOL_BF16_Z = 0.05  # times max(1, max |z_mean|)
SLICE_TOL_BF16_PRED = 0.05
ANYTIME_BATCH = 8  # the anytime slice, card against CPU
ANYTIME_RATES = (0.0, 0.5)
SWEEP_RATES = (0.3, 0.5, 0.7, 0.9)
SWEEP_BATCHES = 8
PR_ACCEPTANCE_DIV = 10
# anytime eval, card f32 vs CPU f32 of the same weights, batch and draws: each
# loss is a mean of 262144-voxel sums (summation order); P and R count voxels
# against 0.5, and a voxel within rounding of it moves them by ~1e-5
ANYTIME_TOL_LOSS_REL = 1e-4
ANYTIME_TOL_PR = 1e-3
# card bf16 vs card f32: bf16 keeps 8 bits of mantissa through ~20 layers (the
# serving slice's decode differs by up to SLICE_TOL_BF16_PRED), which moves the
# focal loss by a few parts in a thousand and flips voxels near 0.5
ANYTIME_TOL_BF16_LOSS_REL = 0.05
ANYTIME_TOL_BF16_PR = 0.02
FIXTURES = os.path.join(REPO, "tests", "fixtures", "modelnet")  # 5 train and 5 test shapes, 64^3, 40 classes
LIFE_BATCH = 4
LIFE_STEPS = 6
LIFE_SAVE_EVERY = 3
# one step from the restored state against one from the trainer's: the same
# forward (equal metrics); cuDNN's bf16 weight gradient of the k=4 convs may
# sum in another order, which moves an Adam update (at most lr = 1e-4) by far
# less than 1% of it
LIFE_TOL_PARAM = 1e-6
ARTIFACT_BATCHES = 5
ARTIFACT_REQUESTS = 256
LIFE_SERVE_START_S = 300  # the subprocess loads torch and the artifact
# exported program vs the eager one: the same ops on the same weights, so the
# same numbers unless cuDNN picks another algorithm in the other caller; f32:
# summation order only; bf16: two ulps (2^-7) of the largest entry
EXPORT_TOL_F32 = 1e-5
EXPORT_TOL_BF16 = 2.0**-7
IMAGE_SIZE = 64  # (rows = cols) of the image phase's served and evaluated batches
IMAGE_BENCH = (96, 128)  # (rows, cols) of bench.py's image train step
IMAGE_TRAIN_STEPS = 24
IMAGE_TRAIN_SAMPLES = 256  # 8 batches of 32: the render cache is warm from step 8
IMAGE_HOST_LAST = 16  # host wall a step over the last 16 steps (all cached)
IMAGE_SLICE_BATCH = 2  # served and trained on the card and the CPU
IMAGE_ANYTIME_BATCH = 4
# the variants phase: each distinct model of the other REGISTRY names with the forward launches of one encode +
# decode (the blocked head's 2, the blocked tail's 2), then the names trained with their launches a step
VARIANT_MODELS = {"modelnet_vae": 4, "modelnet_ae": 4, "ae3d": 4, "modelnet_nolbo_acc": 2, "pascal_vae": 2,
                  "pascal_ae": 2, "pascal_nolbo_acc": 0, "kitti_inst_only": 2}
VARIANT_TRAIN = {"modelnet_vae_dr": (4, 3, 4), "modelnet_ae": (4, 3, 4), "ae3d": (4, 3, 4),
                 "modelnet_nolbo_acc": (2, 1, 2), "pascal_ae_dr": (2, 2, 2), "kitti_inst_only": (2, 2, 2)}
VARIANT_SLICE_BATCH = 2
VARIANT_TRAIN_STEPS = 20
VARIANT_LAYOUT_STEPS = 3  # timed, after one warm-up step
VARIANT_ARTIFACT_REQUESTS = 8  # float-input requests (262144 floats of JSON each) to the exported AE
# layouts of modelnet_nolbo that no REGISTRY name uses (benchmarks/quality_parity.py's classic and
# blocked_dynfix, and the classic encoder on an s2d(2) stem), with their launches a step and whether on wgmma
# layout: ((forward, dx, dw) launches a step, all on the tensor cores, (forward, dx, dw) of them narrow, forwards
# of them on the wide plan): the s2d(2) stem's bf16 forward on the wide plan (the chunked dx's kernel run
# forward; conv_k2_wide), its bf16 dw on the dw-only narrow plan (N = 64; conv_k2_dw_wide)
VARIANT_LAYOUTS = {"classic": ((0, 0, 0), False, (0, 0, 0), 0), "blocked_dynfix": ((4, 3, 4), True, (0, 0, 0), 0),
                   "classic_s2d2": ((1, 0, 1), False, (0, 0, 1), 1)}
STEM_K2 = (32, 8, 64)  # grid, C, N of the s2d(2) stem: 64^3 x 1 folded to 32^3 x 8, 8 -> 64
# (grid, C, N) of the flagship encoder's stride-2 k=4 stages, lowered onto conv_k2's tensor-core kernels
# (kernels/conv_k4s2.py), and the batches they are checked and timed at
K4S2_STAGES = [(16, 128, 256), (8, 256, 512)]
K4S2_BATCHES = [32]
# phase 15: pretraining, the graft, structural shapes, the streaming reconstructor
PRETRAIN_BATCH, PRETRAIN_SIZE, PRETRAIN_STEPS = 64, 224, 16  # cli/pretrain.py's batch and size
PRETRAIN_SLICE_BATCH = 2  # the f32 classifier forward also run on the CPU
PRETRAIN_LOADER_BATCHES = 4  # timed cold, then again cached
GRAFT_STEPS = 3  # timed, after one warm-up step
STRUCT_SAMPLES = 128  # structural grids at 64^3: 40 classes x 10 instances, the pairs these samples draw
STRUCT_STEPS = 10
STREAM_OBJECTS, STREAM_VIEWS = 32, 8
STREAM_CPU_OBJECTS = 4  # the objects also streamed on the CPU
STEM_CASES = [("stem_b8_f32", 8, torch.float32), ("stem_b8_bf16", 8, torch.bfloat16),
              ("stem_b32_f32", 32, torch.float32), ("stem_b32_bf16", 32, torch.bfloat16)]
# phase 16: the real-image data path. sha256 of each fixture PNG as cv2.imread(path, IMREAD_COLOR) gives it
# (tests/test_torch_augment.py holds the port's imread_color to these on the CPU)
FIXTURE_PNG_SHA256 = {
    "tests/fixtures/kitti/training/image_2/000000.png": "d3c67cb468304cd944a4e38daf144e683dcada8b3f53554e7174d67c7f2f0a25",
    "tests/fixtures/kitti/training/image_2/000001.png": "fc01367c49c5b014bb829f4379fe086a7985004532f180a87157af24af35f266",
    "tests/fixtures/pascal3d/Images/car_a.png": "1b8c89b758380957a7c17cf08ff17cf842940f7925395330b59bb34d0369bb02",
    "tests/fixtures/pascal3d/Images/car_d.png": "cd91670bb99a1cc93e5b4f4157d04ef52a06097b58ccf089eef7532ff9c4b0c3",
    "tests/fixtures/pascal3d/Images/chair_c.png": "cbd8fec3ab196f211c3f02be29732b0ff96888069b476e7c1f9b5ee1fe815e93",
}


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this run needs a CUDA GPU")
    card = card_line()
    print(card, flush=True)
    print(f"device: {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    # every f32 comparison below is against true f32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return card


def phase_build() -> None:
    t0 = time.perf_counter()
    lib = build.build("conv_k2")
    build.load("conv_k2")
    print(f"build: {lib} in {time.perf_counter() - t0:.1f} s", flush=True)
    print((lib.parent / "build.log").read_text().strip(), flush=True)


def reset_counts() -> None:
    conv_k2.launches = conv_k2.launches_dx = conv_k2.launches_dw = 0
    conv_k2.launches_wgmma = conv_k2.launches_dx_wgmma = conv_k2.launches_dw_wgmma = 0
    conv_k2.launches_narrow = conv_k2.launches_dx_narrow = conv_k2.launches_dw_narrow = 0
    conv_k2.launches_split = conv_k2.launches_dx_split = 0
    conv_k2.launches_dw_wide = 0
    conv_k2.launches_ffma_split = conv_k2.launches_dx_ffma_split = conv_k2.launches_dw_persistent = 0
    conv_k2.launches_chunked = conv_k2.launches_dw_chunked = 0
    conv_k2.launches_dx_chunked = conv_k2.launches_chunked_f32 = 0
    conv_k2.launches_wide = conv_k2.launches_dw_ffma_fit = 0
    conv_k4s2.launches = conv_k4s2.launches_dx = conv_k4s2.launches_dw = 0


def read_counts() -> dict:
    """Launches since ``reset_counts``: every launch by kernel, under
    ``*_wgmma`` those of them that took the tensor-core kernels and under
    ``*_narrow`` those that took the narrow ones; under ``*_split`` the
    tensor-core forward and dx launches that split their depth, under
    ``conv_k2_split_reduce`` the reduces of their partials (one each, which
    the same call into the library launches after the split kernel), under
    ``conv_k2_dw_wide`` the narrow dw launches on the dw-only plan (N = 64),
    under ``*_ffma_split`` the float32 FFMA forward and dx launches that split
    their depth (each with the reduce of its partials), under
    ``conv_k2_dw_persistent`` the tensor-core dw launches on the persistent
    kernel, under ``conv_k2_chunked`` / ``conv_k2_dw_chunked`` the narrow
    forward and dw launches whose plan walks C in chunks (the tensor-parallel
    shard 512 -> 32), under ``conv_k2_chunked_f32`` the float32 ones of those
    forwards, under ``conv_k2_dx_chunked`` the dx launches on the chunked dx
    (that shard's bfloat16 dx, also under ``conv_k2_dx_narrow``), under
    ``conv_k2_wide`` the forward launches on the wide plan (the s2d(2) stem's
    bfloat16 forward), under ``conv_k2_dw_ffma_fit`` the FFMA dw launches on a
    tile fitted to a narrow side (N <= 32 or 8C <= 64); under ``conv_k4s2``,
    ``conv_k4s2_dx`` and ``conv_k4s2_dw`` the lowered stride-2 k=4 conv's
    launches (``kernels/conv_k4s2.py``)."""
    return {"conv_k2": conv_k2.launches, "conv_k2_dx": conv_k2.launches_dx, "conv_k2_dw": conv_k2.launches_dw,
            "conv_k2_wgmma": conv_k2.launches_wgmma, "conv_k2_dx_wgmma": conv_k2.launches_dx_wgmma,
            "conv_k2_dw_wgmma": conv_k2.launches_dw_wgmma, "conv_k2_narrow": conv_k2.launches_narrow,
            "conv_k2_dx_narrow": conv_k2.launches_dx_narrow, "conv_k2_dw_narrow": conv_k2.launches_dw_narrow,
            "conv_k2_split": conv_k2.launches_split, "conv_k2_dx_split": conv_k2.launches_dx_split,
            "conv_k2_split_reduce": conv_k2.launches_split + conv_k2.launches_dx_split,
            "conv_k2_dw_wide": conv_k2.launches_dw_wide, "conv_k2_ffma_split": conv_k2.launches_ffma_split,
            "conv_k2_dx_ffma_split": conv_k2.launches_dx_ffma_split,
            "conv_k2_dw_persistent": conv_k2.launches_dw_persistent, "conv_k2_chunked": conv_k2.launches_chunked,
            "conv_k2_dw_chunked": conv_k2.launches_dw_chunked, "conv_k2_dx_chunked": conv_k2.launches_dx_chunked,
            "conv_k2_chunked_f32": conv_k2.launches_chunked_f32, "conv_k2_wide": conv_k2.launches_wide,
            "conv_k2_dw_ffma_fit": conv_k2.launches_dw_ffma_fit, "conv_k4s2": conv_k4s2.launches,
            "conv_k4s2_dx": conv_k4s2.launches_dx, "conv_k4s2_dw": conv_k4s2.launches_dw}


def expect_counts(what: str, forward: int, dx: int, dw: int, tensor_cores: bool,
                  narrow: tuple[int, int, int] = (0, 0, 0), split: tuple[int, int] = (0, 0),
                  wide: int = 0, ffma_split: tuple[int, int] = (0, 0), persistent: int = 0,
                  chunked: tuple[int, int, int] = (0, 0, 0), wide_forward: int = 0, ffma_fit: int = 0,
                  k4s2: tuple[int, int, int] | None = None) -> dict:
    """Read the counts and hold them to ``forward`` / ``dx`` / ``dw`` launches,
    all of them on the tensor-core kernels or none of them, ``narrow``'s
    forward / dx / dw launches of them on the narrow kernels, ``wide`` of the
    narrow dw's on the dw-only plan, ``split``'s forward / dx launches of
    the tensor-core ones that split their depth, each with its reduce,
    ``ffma_split``'s forward / dx launches of the float32 FFMA ones that do
    (only the mid_blocked stages at 4^3 and 8^3 split), ``persistent`` of
    the tensor-core dw's on the persistent kernel (the mid_blocked stages),
    and ``chunked``'s forward / dx / dw launches of the narrow ones whose
    plan walks C in chunks (dx: the chunked dx; all in bfloat16: the float32
    ones run in phase 19 alone, which holds its counts to ``tp_expected``),
    ``wide_forward`` forward launches on the wide plan and ``ffma_fit`` FFMA
    dw launches on a tile fitted to a narrow side; where ``k4s2`` is given,
    also the lowered stride-2 k=4 conv's forward / dx / dw launches (else
    they are counted and returned, not held)."""
    counts = read_counts()
    want = {"conv_k2": forward, "conv_k2_dx": dx, "conv_k2_dw": dw,
            "conv_k2_wgmma": forward if tensor_cores else 0, "conv_k2_dx_wgmma": dx if tensor_cores else 0,
            "conv_k2_dw_wgmma": dw if tensor_cores else 0, "conv_k2_narrow": narrow[0],
            "conv_k2_dx_narrow": narrow[1], "conv_k2_dw_narrow": narrow[2], "conv_k2_split": split[0],
            "conv_k2_dx_split": split[1], "conv_k2_split_reduce": split[0] + split[1], "conv_k2_dw_wide": wide,
            "conv_k2_ffma_split": ffma_split[0], "conv_k2_dx_ffma_split": ffma_split[1],
            "conv_k2_dw_persistent": persistent, "conv_k2_chunked": chunked[0], "conv_k2_dx_chunked": chunked[1],
            "conv_k2_dw_chunked": chunked[2], "conv_k2_chunked_f32": 0, "conv_k2_wide": wide_forward,
            "conv_k2_dw_ffma_fit": ffma_fit}
    if k4s2 is not None:
        want |= {"conv_k4s2": k4s2[0], "conv_k4s2_dx": k4s2[1], "conv_k4s2_dw": k4s2[2]}
    if {k: v for k, v in counts.items() if k in want} != want:
        raise AssertionError(f"{what}: launches {counts}, expected {want}")
    return counts


def k4s2_lowered(batch: int) -> int:
    """How many of the flagship encoder's stride-2 k=4 stages ``Conv3d``
    lowers onto the tensor-core kernels at ``batch`` in bfloat16 on this
    card (``kernels/conv_k4s2.py::lowering_plans``): each a forward, dx and
    dw launch of a train step, a forward of an encode."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sum(lowering_plans((batch, n, n, n, C), N, 4, 2, torch.bfloat16, "cuda", sms) is not None
               for n, C, N in K4S2_STAGES)


def k2_bound_ms(kernel: str, batch: int, C: int, N: int, dtype: torch.dtype, grid: int = GRID) -> tuple[float, str]:
    """The least time the card could take for one stage on a ``grid``^3 grid:
    the larger of its bytes (each input read once, each output written once)
    over the memory rate and its operations over the peak rate of its type.
    A tap that falls off the grid is no work: each axis has 2*grid - 1 (row,
    tap) pairs in it."""
    rows = batch * grid**3
    item = torch.empty((), dtype=dtype).element_size()
    flops = 2.0 * batch * (2 * grid - 1) ** 3 * C * N
    if kernel == "conv_k2_dw":  # reads x and g, writes dw in float32
        nbytes = rows * (C + N) * item + 8 * C * N * 4
    else:  # reads x (or g) and w, writes y (or dx)
        nbytes = rows * (C + N) * item + 8 * C * N * item
    t_bytes, t_flops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_flops) * 1e3, "bytes" if t_bytes > t_flops else "operations"


def split_reduce_plain(part: torch.Tensor) -> torch.Tensor:
    """The plain version of the split forward's reduce: the f32 partials
    [splits, ...] added in ascending order, rounded once to bfloat16."""
    total = part[0].clone()
    for z in range(1, part.shape[0]):
        total += part[z]
    return total.to(torch.bfloat16)


def float64_forward(x: torch.Tensor, w: torch.Tensor, chunk: int = 64) -> torch.Tensor:
    """``conv_k2(x, w)`` as a float64 product of the same operands, tap by
    tap, ``chunk`` batch items at a time (the scene pass's x is 2.1 GB in
    bf16)."""
    B, D, H, W, C = x.shape
    w64 = w.double().reshape(8, C, -1)
    out = []
    for i in range(0, B, chunk):
        xp = F.pad(x[i:i + chunk].double(), (0, 0) + (0, 1) * 3)
        out.append(sum(xp[:, t >> 2:(t >> 2) + D, (t >> 1) & 1:((t >> 1) & 1) + H, t & 1:(t & 1) + W] @ w64[t]
                       for t in range(8)))
    return torch.cat(out)


def float64_products(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor) -> dict:
    """``conv_k2(x, w)``, dx of (g, w) and dw of (x, g) as float64 products of
    the same operands, tap by tap: what every kernel and plain version
    approximates. Keyed by kernel."""
    B, D, H, W, C = x.shape
    N = w.shape[-1]
    xp, gp = F.pad(x.double(), (0, 0) + (0, 1) * 3), F.pad(g.double(), (0, 0) + (1, 0) * 3)
    w64, g64 = w.double().reshape(8, C, N), g.double().flatten(0, 3)
    dx, dw = torch.zeros(B * D * H * W, C, dtype=torch.float64, device=x.device), []
    for t in range(8):
        tz, ty, tx = t >> 2, (t >> 1) & 1, t & 1
        dw.append(xp[:, tz:tz + D, ty:ty + H, tx:tx + W].flatten(0, 3).T @ g64)
        # g shifted down by the tap: the padded copy read one short of it
        dx += gp[:, 1 - tz:1 - tz + D, 1 - ty:1 - ty + H, 1 - tx:1 - tx + W].flatten(0, 3) @ w64[t].T
    return {"conv_k2": float64_forward(x, w, chunk=B), "conv_k2_dx": dx.reshape(B, D, H, W, C),
            "conv_k2_dw": torch.stack(dw).reshape(2, 2, 2, C, N)}


def check_kernel(kernel: str, label: str, run, plain, exact: torch.Tensor | None, want: str) -> dict:
    """Launch ``run`` once, hold it against ``plain`` with the tolerance of its
    design and dtype, and hold the design the launch took to ``want`` ("wgmma",
    "persistent" (the tensor-core dw on persistent blocks), "narrow",
    "chunked" (the narrow forward or dw that walks C in chunks, or the
    chunked dx), "wide" (the forward on the wide plan, the chunked dx's
    kernel run forward),
    "ffma_split" (the float32 FFMA forward or dx with its depth split),
    "ffma_fit" (the FFMA dw on a tile fitted to a narrow side) or
    "ffma"). With ``exact`` (a float64 product) the tensor-core and narrow
    kernels and their plain versions are also held against it; dw and the
    chunked and wide kernels must give the same bits twice (a chunked dx that
    freed a halo stage too early gave other bits at most launches)."""
    # the first whose counter moved: a narrow dw on the dw-only plan also moves conv_k2_dw_wide
    designs = ("persistent", "ffma_split", "wgmma", "chunked", "narrow", "wide", "ffma_fit")

    def launched(design: str) -> int:
        return sum(n for name, n in read_counts().items() if name.endswith(f"_{design}"))

    before = {d: launched(d) for d in designs}
    out, ref = run(), plain()
    torch.cuda.synchronize()
    design = next((d for d in designs if launched(d) > before[d]), "ffma")
    if design != want:
        raise AssertionError(f"{kernel} {label}: took the {design} kernel, expected {want}")
    if out.shape != ref.shape or out.dtype != ref.dtype:
        raise AssertionError(f"{kernel} {label}: {out.shape}/{out.dtype} vs {ref.shape}/{ref.dtype}")
    err = float((out.float() - ref.float()).abs().max())
    top = float(ref.float().abs().max())
    if kernel == "conv_k2_dw":
        tol = (2 * K2_TOL_DW_F64_REL if design in ("wgmma", "persistent") else K2_TOL_DW_REL) * top
    else:
        tol = K2_TOL_F32 if ref.dtype == torch.float32 else K2_TOL_BF16_REL * top
    line = f"{kernel} {label} [{design}]: max_abs_err {err:.3e} (tol {tol:.3e})"
    if not err <= tol:
        raise AssertionError(f"{line}: the kernel disagrees with its plain version")
    if design not in ("ffma", "ffma_split") and exact is not None:
        err_k, err_p = (float((t.double() - exact).abs().max()) for t in (out, ref))
        top64 = float(exact.abs().max())
        if kernel == "conv_k2_dw":
            tol64 = K2_TOL_DW_F64_REL * top64
        elif out.dtype == torch.float32:
            tol64 = K2_TOL_F32_F64_REL * top64
        else:  # the f32 sum rounded once to bf16: half an ulp of the largest output, and the sum's own error
            tol64 = (2.0**-8 + K2_TOL_DW_F64_REL) * top64
        line += (f"; against float64 (largest entry {top64:.3e}): kernel {err_k:.3e} ({err_k / top64:.2e} rel), "
                 f"plain {err_p:.3e} ({err_p / top64:.2e} rel), tol {tol64:.3e}")
        if not (err_k <= tol64 and err_p <= tol64):
            raise AssertionError(f"{line}: off the float64 product")
    if kernel == "conv_k2_dw" or design in ("chunked", "wide"):
        same = bool(torch.equal(out, run()))
        line += f"; same bits twice: {same}"
        if not same:
            raise AssertionError(f"{line}: {kernel} differs between two calls")
    print(line, flush=True)
    return {"design": design, "max_abs_err": err}


def k2_runs(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor) -> dict:
    """(kernel, plain version, library call) of each kernel on these operands;
    the library calls' operands are laid out once, outside any timing."""
    x_ncdhw, g_ncdhw = x.permute(0, 4, 1, 2, 3), g.permute(0, 4, 1, 2, 3)
    x_pad = F.pad(x_ncdhw, (0, 1) * 3)
    w_oidhw = w.permute(4, 3, 0, 1, 2).contiguous()
    return {
        "conv_k2": (lambda: conv_k2(x, w), lambda: conv_k2_reference(x, w),
                    lambda: F.conv3d(x_pad, w_oidhw)),
        "conv_k2_dx": (lambda: conv_k2_dx(g, w), lambda: conv_k2_dx_reference(g, w),
                       lambda: torch.nn.grad.conv3d_input(x_pad.shape, w_oidhw, g_ncdhw)),
        "conv_k2_dw": (lambda: conv_k2_dw(x, g), lambda: conv_k2_dw_reference(x, g),
                       lambda: torch.nn.grad.conv3d_weight(x_pad, w_oidhw.shape, g_ncdhw)),
    }


def k2_operands(gen: torch.Generator, shape: tuple, C: int, N: int, dtype: torch.dtype):
    dev = torch.device("cuda")
    x = torch.randn(*shape, C, generator=gen).to(dev, dtype)
    w = (torch.randn(2, 2, 2, C, N, generator=gen) / math.sqrt(8 * C)).to(dev, dtype)
    g = torch.randn(*shape, N, generator=gen).to(dev, dtype)
    return x, w, g


def phase_kernels(card: str) -> dict:
    """Forward, dx and dw against their plain versions at the flagship stages,
    for every case of ``KERNEL_CASES``. Returns ``{kernel: {case: numbers}}``:
    times and bounds summed over the stages (dx has three: the first stage's
    input is data), the error the largest over them, the design they took."""
    gen = torch.Generator().manual_seed(SEED)
    keys = ("ms", "plain_ms", "library_ms", "bound_ms")
    res = {k: {case: dict.fromkeys(keys, 0.0) | {"max_abs_err": 0.0, "bound_by": set(), "design": set()}
               for case, _, _ in KERNEL_CASES} for k in ("conv_k2", "conv_k2_dx", "conv_k2_dw")}
    print(f"dw on the tensor cores is held to {K2_TOL_DW_F64_REL} of the largest entry of the float64 sum: "
          f"{K2_TOL_DW_F64_NOTE}", flush=True)
    with torch.inference_mode():
        for case, batch, dtype in KERNEL_CASES:
            for stage, (C, N) in enumerate(FLAGSHIP_K2):
                x, w, g = k2_operands(gen, (batch, GRID, GRID, GRID), C, N, dtype)
                exact = float64_products(x, w, g) if dtype == torch.bfloat16 else {}
                for kernel, (run, plain, library) in k2_runs(x, w, g).items():
                    if kernel == "conv_k2_dx" and stage == 0:
                        continue
                    label = f"{case} {GRID}^3 {C}->{N}"
                    # every flagship stage has a plan: bf16 on the tensor cores, forward, dx and dw
                    want = "wgmma" if dtype == torch.bfloat16 else "ffma"
                    checked = check_kernel(kernel, label, run, plain, exact.get(kernel), want)
                    # plain, kernel, kernel, plain: both sides see the same card state
                    p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(run), cuda_ms(run), cuda_ms(plain)
                    ms, plain_ms, library_ms = (k1 + k2) / 2, (p1 + p2) / 2, cuda_ms(library)
                    bound_ms, bound_by = k2_bound_ms(kernel, batch, C, N, dtype)
                    tflops = 2 * batch * GRID**3 * 8 * C * N / (ms * 1e-3) / 1e12
                    print(f"{kernel} {label} [{checked['design']}]: kernel {ms:.4f} ms ({tflops:.2f} TFLOP/s) "
                          f"plain {plain_ms:.4f} ms library {library_ms:.4f} ms bound {bound_ms:.4f} ms ({bound_by}) "
                          f"[{card}]", flush=True)
                    r = res[kernel][case]
                    r["max_abs_err"] = max(r["max_abs_err"], checked["max_abs_err"])
                    r["bound_by"].add(bound_by)
                    r["design"].add(checked["design"])
                    for key, v in zip(keys, (ms, plain_ms, library_ms, bound_ms)):
                        r[key] += v
                del exact
        # off the main path, bfloat16: a shape with a wgmma plan (8^3), one with none (ragged grid, N = 24: its dw on
        # the FFMA tile fitted to N <= 32) and one with a narrow plan (a whole-grid box of 210 rows): the design of
        # forward, dx and dw each
        for shape, C, N, designs in (((3, 8, 8, 8), 64, 64, ("wgmma",) * 3),
                                     ((2, 5, 6, 7), 16, 24, ("ffma", "ffma", "ffma_fit")),
                                     ((3, 5, 6, 7), 16, 16, ("narrow",) * 3)):
            assert (wgmma_plan(*shape, C, N) is not None) == (designs[0] == "wgmma")
            assert (narrow_plan(*shape, C, N) is not None) == (designs[0] == "narrow")
            label = f"off the main path {shape} {C}->{N}"
            x, w, g = k2_operands(gen, shape, C, N, torch.bfloat16)
            exact = float64_products(x, w, g)
            for (kernel, (run, plain, _)), want in zip(k2_runs(x, w, g).items(), designs):
                check_kernel(kernel, label, run, plain, exact[kernel], want)
    for kernel, cases in res.items():
        for case, r in cases.items():
            r["bound_by"] = "operations" if "operations" in r["bound_by"] else "bytes"
            (r["design"],) = r["design"]  # one design for all stages of a case
            print(f"{kernel} {case} [{r['design']}], sum over its stages: kernel {r['ms']:.4f} ms plain "
                  f"{r['plain_ms']:.4f} ms library {r['library_ms']:.4f} ms bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']}) [{card}]", flush=True)
    return res


def kernel_entries(res: dict, serve_counts: dict, train_counts: dict, anytime_counts: dict, life_counts: dict,
                   artifact_counts: dict, image_counts: dict, detector_counts: dict, variant_counts: dict,
                   stream_counts: dict, real_counts: dict, mapping_counts: dict, mid_counts: dict,
                   tp_counts: dict) -> list:
    """The ``kernels`` JSON entries. The headline numbers of each kernel are
    at the shapes its main path gives it: the served batch in float32 for the
    forward, the train step's (B=32, bfloat16) for dx and dw; ``cases`` holds
    every case measured, with the design it took (``ffma``, ``wgmma`` or
    ``narrow``). Every
    number but ``bound_ms`` was measured in this run. ``launches`` sums
    the served runs, the train run, the anytime sweep, the lifecycle's train,
    restored and evaluate runs, its exported programs' batches, the image
    phase's runs, the detector phase's, the variants phase's, the
    pretraining and streaming phase's (the graft's steps, the structural
    train run, the streaming reconstructor), the real-data phase's (the
    f32 step, the Pascal3D, KITTI and detector train runs), the mapping and
    data-parallel phase's (the train runs with and without ``--mesh``, the
    explicit DP step and its reference, the detector's ``--mesh`` run) and the
    ``mid_blocked`` phase's (its served batches and train runs, the default
    layout's beside them, the flat-optimizer steps) and the tensor-parallel
    phase's (its 1-rank f32 and bf16 steps, and both model ranks' f32 and
    bf16 steps, on the shard shapes);
    ``launches_wgmma`` is the part of
    them that took the tensor-core kernels, ``launches_narrow`` the part that
    took the narrow kernels (the detector's final conv, all three in both
    types), ``launches_split`` the tensor-core forward and dx launches that
    split their depth. Two entries of this PR's kernels stand beside the
    three: ``conv_k2_split_reduce``, the reduce of the split forward's and
    dx's partials (headline: the served batch's 4^3 2048 -> 512, B=8), and
    ``conv_k2_dw_wide``, the narrow dw's N = 64 instance on the dw-only plan
    (headline: the s2d(2) stem at B=32, bf16); and two of PR 19's:
    ``conv_k2_ffma_split``, the float32 FFMA forward and dx with their depth
    split and the reduce of their partials (headline: the f32 served batch's
    4^3 2048 -> 512 forward, B=8; ``launches`` its forward and dx launches),
    and ``conv_k2_dw_persistent``, the bf16 dw on persistent blocks (headline:
    4^3 2048 -> 512 at B=8). ``launches_ffma_split`` on the forward and dx and
    ``launches_persistent`` on dw count those launches of each;
    ``launches_chunked`` on the forward and dw the narrow launches whose plan
    walks C in chunks (the tensor-parallel shard 512 -> 32, part of
    ``launches_narrow``), on dx its launches on the chunked dx. And two
    more: ``conv_k2_dx_chunked``, the chunked dx on the tensor cores
    (headline: that shard's bf16 dx at B=32), and ``conv_k2_chunked_f32``,
    the float32 forward that walks C in chunks of 16 (headline: that shard's
    f32 forward at B=32). And two more: ``conv_k2_wide``, the bf16 forward of
    a narrow input and a wide output on the chunked dx's kernel run forward
    (headline: the s2d(2) stem at B=32), and ``conv_k2_dw_ffma_fit``, the FFMA
    dw on a tile fitted to a narrow side (headline: that shard's f32 dw at
    B=32; the stem's f32 dw among its cases). And three of the lowered
    stride-2 k=4 conv (``kernels/conv_k4s2.py``), which replace no TPU kernel
    (the JAX package leaves the conv to XLA): ``conv_k4s2``, ``conv_k4s2_dx``
    and ``conv_k4s2_dw`` (headline: the flagship encoder's 16^3 -> 8^3 128 ->
    256 at B=32, bf16)."""
    paths = (serve_counts, train_counts, anytime_counts, life_counts, artifact_counts, image_counts, detector_counts,
             variant_counts, stream_counts, real_counts, mapping_counts, mid_counts, tp_counts)
    names = ("serve", "train", "anytime", "lifecycle", "artifact", "image", "detector", "variants", "pretrain_stream",
             "real_data", "mapping_dp", "mid_blocked", "tensor_parallel")
    replaces = {"conv_k2": "anytime3d_tpu/kernels/conv_k2.py:156",
                "conv_k2_dx": "anytime3d_tpu/kernels/conv_k2.py:178",
                "conv_k2_dw": "anytime3d_tpu/kernels/conv_k2.py:184",
                # the split forward's and dx's reduce: the forward's sum (and dx's), split over blocks
                "conv_k2_split_reduce": "anytime3d_tpu/kernels/conv_k2.py:156",
                "conv_k2_dw_wide": "anytime3d_tpu/kernels/conv_k2.py:184",
                "conv_k2_ffma_split": "anytime3d_tpu/kernels/conv_k2.py:156",
                "conv_k2_dw_persistent": "anytime3d_tpu/kernels/conv_k2.py:184",
                "conv_k2_dx_chunked": "anytime3d_tpu/kernels/conv_k2.py:178",
                "conv_k2_chunked_f32": "anytime3d_tpu/kernels/conv_k2.py:156",
                "conv_k2_wide": "anytime3d_tpu/kernels/conv_k2.py:156",
                "conv_k2_dw_ffma_fit": "anytime3d_tpu/kernels/conv_k2.py:184",
                # no TPU kernel: XLA's conv of the voxel encoder's stride-2 stages
                **dict.fromkeys(("conv_k4s2", "conv_k4s2_dx", "conv_k4s2_dw"),
                                "none (XLA's nn.Conv, anytime3d_tpu/nn/blocks.py:111)")}
    # the case of the headline numbers: the shapes its main path gives each kernel
    heads = {"conv_k2": "b8_f32", "conv_k2_dx": "b32_bf16", "conv_k2_dw": "b32_bf16",
             "conv_k2_split_reduce": "mid_b8_bf16_4cubed 4^3 2048->512", "conv_k2_dw_wide": "stem_b32_bf16",
             "conv_k2_ffma_split": "conv_k2 mid_b8_f32_4cubed 4^3 2048->512",
             "conv_k2_dw_persistent": "mid_b8_bf16_4cubed 4^3 2048->512",
             "conv_k2_dx_chunked": f"tp_b32_bf16 {GRID}^3 512->32",
             "conv_k2_chunked_f32": f"tp_b32_f32 {GRID}^3 512->32", "conv_k2_wide": "stem_b32_bf16",
             "conv_k2_dw_ffma_fit": f"tp_b32_f32 {GRID}^3 512->32",
             **dict.fromkeys(("conv_k4s2", "conv_k4s2_dx", "conv_k4s2_dw"), "b32_16")}
    sources = {"conv_k2_dw_wide": "anytime3d_tpu_torch/kernels/csrc/conv_k2_narrow.cuh",
               "conv_k2_dw_persistent": "anytime3d_tpu_torch/kernels/csrc/conv_k2_wgmma.cuh",
               "conv_k2_dx_chunked": "anytime3d_tpu_torch/kernels/csrc/conv_k2_chunked_dx.cuh",
               "conv_k2_chunked_f32": "anytime3d_tpu_torch/kernels/csrc/conv_k2_narrow.cuh",
               "conv_k2_wide": "anytime3d_tpu_torch/kernels/csrc/conv_k2_chunked_dx.cuh",
               **dict.fromkeys(("conv_k4s2", "conv_k4s2_dx", "conv_k4s2_dw"),
                               "anytime3d_tpu_torch/kernels/csrc/conv_k2_wgmma.cuh")}
    # the counters of an entry's launches: its own, but the split FFMA's are its forward's and its dx's
    counted = {"conv_k2_ffma_split": ("conv_k2_ffma_split", "conv_k2_dx_ffma_split")}
    entries = []
    for kernel, cases in res.items():
        entry = {
            "name": kernel,
            "route": "cuda",
            "source": sources.get(kernel, "anytime3d_tpu_torch/kernels/csrc/conv_k2.cu"),
            "replaces": replaces[kernel],
            "launches": sum(c[k] for c in paths for k in counted.get(kernel, (kernel,))),
            **{f"launches_{name}": sum(c[k] for k in counted.get(kernel, (kernel,)))
               for name, c in zip(names, paths)},
            **cases[heads[kernel]],
            "cases": cases,
        }
        if kernel in ("conv_k2", "conv_k2_dx", "conv_k2_dw"):
            entry |= {"source_wgmma": "anytime3d_tpu_torch/kernels/csrc/conv_k2_wgmma.cuh",
                      "launches_wgmma": sum(c[f"{kernel}_wgmma"] for c in paths),
                      "source_narrow": "anytime3d_tpu_torch/kernels/csrc/conv_k2_narrow.cuh",
                      "launches_narrow": sum(c[f"{kernel}_narrow"] for c in paths)}
        if kernel in ("conv_k2", "conv_k2_dx"):  # the tensor-core and the FFMA launches that split their depth
            entry["launches_split"] = sum(c[f"{kernel}_split"] for c in paths)
            entry["launches_ffma_split"] = sum(c[f"{kernel}_ffma_split"] for c in paths)
        if kernel == "conv_k2_dw":  # the tensor-core dw launches on persistent blocks
            entry["launches_persistent"] = sum(c["conv_k2_dw_persistent"] for c in paths)
        if kernel in ("conv_k2", "conv_k2_dx", "conv_k2_dw"):  # the launches that walk in chunks
            entry["launches_chunked"] = sum(c[f"{kernel}_chunked"] for c in paths)
        entries.append(entry)
    return entries


def synthetic_grids(n: int, dim: int, seed: int) -> np.ndarray:
    """(n, dim, dim, dim, 1) float32 occupancy: one random ellipsoid each."""
    rng = np.random.default_rng(seed)
    g = np.indices((dim, dim, dim)).transpose(1, 2, 3, 0) + 0.5
    out = np.zeros((n, dim, dim, dim, 1), np.float32)
    for i in range(n):
        c = rng.uniform(0.35, 0.65, 3) * dim
        r = rng.uniform(0.12, 0.3, 3) * dim
        out[i, ..., 0] = (((g - c) / r) ** 2).sum(-1) <= 1.0
    return out


def latent_masks(n: int, dim: int, seed: int) -> np.ndarray:
    """Full masks for the first 3 items, random half for the next 3, empty for the rest."""
    rng = np.random.default_rng(seed)
    m = np.ones((n, dim), np.float32)
    m[3:6] = rng.uniform(size=(3, dim)) < 0.5
    m[6:] = 0.0
    return m


def phase_slice(cfg, device: torch.device, card: str) -> tuple[MultiModalVAE, dict]:
    """``cfg`` on ``device`` vs the CPU, f32 and bf16, then a short bf16 served
    run; returns the f32 device model and the bf16 run's launch counts."""
    item = cfg.decoder.output_shape
    z_dim = cfg.z_category_dim
    t0 = time.perf_counter()
    model_cpu = MultiModalVAE(cfg, generator=torch.Generator().manual_seed(SEED))
    model_gpu = copy.deepcopy(model_cpu).to(device)
    print(f"slice: modelnet_nolbo {sum(p.numel() for p in model_cpu.parameters())} params, "
          f"built in {time.perf_counter() - t0:.1f} s", flush=True)

    vox = synthetic_grids(BATCH, item[0], SEED)
    packed = torch.from_numpy(pack_voxels(vox))
    mask = torch.from_numpy(latent_masks(BATCH, z_dim, SEED))
    packed_gpu, mask_gpu = packed.to(device), mask.to(device)

    infer_packed = make_packed_infer(model_gpu, item)
    reset_counts()
    outs = [infer_packed(packed_gpu, mask_gpu) for _ in range(2)]
    card_out = {k: v.cpu() for k, v in outs[0].items()}
    counts = expect_counts("slice, f32", 4 * len(outs), 0, 0, tensor_cores=False, k4s2=(0, 0, 0))
    print(f"slice: conv_k2 launches {counts['conv_k2']} for {len(outs)} f32 batches", flush=True)

    with torch.inference_mode():
        x_cpu = unpack_voxels(packed, item)
        cpu = make_infer_fn(model_cpu)(x_cpu, mask)
        gpu = make_infer_fn(model_gpu)(x_cpu.to(device), mask_gpu)
    gpu = {k: v.cpu() for k, v in gpu.items()}
    for k, shape in (("z_mean", (BATCH, z_dim)), ("z_log_var", (BATCH, z_dim)), ("pred", (BATCH, *item))):
        if tuple(gpu[k].shape) != shape or not torch.isfinite(gpu[k]).all():
            raise AssertionError(f"slice {k}: shape {tuple(gpu[k].shape)} (want {shape}) or non-finite values")
    err_z = float((gpu["z_mean"] - cpu["z_mean"]).abs().max())
    err_pred = float((gpu["pred"] - cpu["pred"]).abs().max())
    bits_cpu = np.unpackbits(pack_voxels_device(cpu["pred"]).numpy())
    bits_gpu = np.unpackbits(card_out["pred_packed"].numpy())
    flips = int((bits_cpu != bits_gpu).sum())
    same_cat = bool(torch.equal(gpu["category"], cpu["category"]))
    same_packed_z = bool(torch.equal(card_out["z_mean"], gpu["z_mean"]))
    print(f"slice f32 card vs CPU: z_mean max_abs_err {err_z:.3e}, pred max_abs_err {err_pred:.3e} "
          f"(tol {SLICE_TOL_F32}), pred_packed bit flips {flips}/{bits_cpu.size}, category "
          f"card {gpu['category'].tolist()} cpu {cpu['category'].tolist()}, "
          f"pred mean {float(gpu['pred'].mean()):.4f} std {float(gpu['pred'].std()):.4f}, "
          f"occupied {float(bits_gpu.mean()):.4f}", flush=True)
    if not (err_z <= SLICE_TOL_F32 and err_pred <= SLICE_TOL_F32):
        raise AssertionError("slice: card f32 disagrees with the CPU")
    if not same_cat:
        raise AssertionError("slice: card and CPU pick different categories")
    if flips > SLICE_BITS_TOL * bits_cpu.size:
        raise AssertionError(f"slice: {flips} pred_packed bits differ from the CPU")
    if not same_packed_z:
        raise AssertionError("slice: make_packed_infer and make_infer_fn disagree on z_mean")
    if float(gpu["pred"].std()) < 1e-3:
        raise AssertionError("slice: pred is constant")

    model_bf16 = copy.deepcopy(model_cpu).to(torch.bfloat16).to(device)
    with torch.inference_mode():
        bf = {k: v.cpu() for k, v in make_infer_fn(model_bf16)(x_cpu.to(device), mask_gpu).items()}
    err_zb = float((bf["z_mean"] - gpu["z_mean"]).abs().max())
    err_pb = float((bf["pred"] - gpu["pred"]).abs().max())
    tol_zb = SLICE_TOL_BF16_Z * max(1.0, float(gpu["z_mean"].abs().max()))
    agree = int((bf["category"] == gpu["category"]).sum())
    print(f"slice bf16 vs f32 on the card: z_mean max_abs_err {err_zb:.3e} (tol {tol_zb:.3e}), "
          f"pred max_abs_err {err_pb:.3e} (tol {SLICE_TOL_BF16_PRED}), category agrees {agree}/{BATCH}",
          flush=True)
    if not (err_zb <= tol_zb and err_pb <= SLICE_TOL_BF16_PRED):
        raise AssertionError("slice: bf16 on the card strays from f32")

    # the serving path in bf16: every k=2 stage on the tensor-core forward
    infer_bf16 = make_packed_infer(model_bf16, item)
    infer_bf16(packed_gpu, mask_gpu)  # warm-up, not counted
    torch.cuda.synchronize()
    reset_counts()
    served = [infer_bf16(packed_gpu, mask_gpu) for _ in range(SERVE_BF16_BATCHES)]
    torch.cuda.synchronize()
    counts = expect_counts("bf16 served run", 4 * SERVE_BF16_BATCHES, 0, 0, tensor_cores=True,
                           k4s2=(k4s2_lowered(BATCH) * SERVE_BF16_BATCHES, 0, 0))
    z = served[-1]["z_mean"].float().cpu()
    if not (torch.isfinite(z).all() and float((z - gpu["z_mean"]).abs().max()) <= tol_zb):
        raise AssertionError("bf16 served run: z_mean strays from the f32 slice")
    ms16, ms32 = cuda_ms(lambda: infer_bf16(packed_gpu, mask_gpu)), cuda_ms(lambda: infer_packed(packed_gpu, mask_gpu))
    print(f"bf16 served run: {SERVE_BF16_BATCHES} batches of {BATCH} through make_packed_infer, launches {counts}; "
          f"device time per batch (CUDA events) bf16 {ms16:.3f} ms, f32 {ms32:.3f} ms [{card}]", flush=True)
    return model_gpu, counts


def phase_train_slice(cfg, device: torch.device, n: int = TRAIN_SLICE_BATCH,
                      launches: tuple[int, int, int] = (4, 3, 4), what: str = "train slice",
                      ffma_split: tuple[int, int] = (0, 0)) -> dict:
    """One full-width float32 train step on ``device`` against the same step on
    the CPU: same weights, same packed batch, same injected draws; ``n``
    items, ``launches`` forward / dx / dw on the card (FFMA), ``ffma_split``'s
    forward / dx of them with their depth split. Returns the card's launch
    counts."""
    loss_cfg = configs.loss_config("modelnet_nolbo")
    item = cfg.decoder.output_shape
    z_dim = cfg.z_category_dim
    rng = np.random.default_rng(SEED + 2)
    batch = {
        "input_packed_blocked": torch.from_numpy(pack_voxels_blocked(synthetic_grids(n, item[0], SEED + 2), 4)),
        "category_onehot": torch.from_numpy(np.eye(cfg.category_dim, dtype=np.float32)[rng.integers(0, cfg.category_dim, n)]),
    }
    draws = {
        "eps_inst": torch.from_numpy(rng.normal(size=(n, z_dim)).astype(np.float32)),
        "eps_prior_cat": torch.from_numpy(rng.normal(size=(n, z_dim)).astype(np.float32)),
        "coin": torch.tensor(True),  # the mixed branch: the prior sample reaches the decoder
        "take_prior": torch.from_numpy(rng.uniform(size=(n, z_dim)) < loss_cfg.mix_element_prob),
    }
    # dropout rate 0: the prior net's mask is the one draw that cannot be injected
    no_drop = dataclasses.replace(cfg, prior_category=dataclasses.replace(cfg.prior_category, dropout_rate=0.0))
    model_cpu = MultiModalVAE(no_drop, generator=torch.Generator().manual_seed(SEED))
    model_gpu = copy.deepcopy(model_cpu).to(device)
    results, counts = {}, {}
    for name, model, dev in (("card", model_gpu, device), ("cpu", model_cpu, torch.device("cpu"))):
        state = create_train_state(model)
        before = {k: p.detach().clone() for k, p in model.named_parameters()}
        t0 = time.perf_counter()
        if dev.type == "cuda":
            reset_counts()
        # make_train_step's body written out, to keep a copy of the gradients it hands to the optimizer
        total, metrics = compute_losses(model, loss_cfg, {k: v.to(dev) for k, v in batch.items()},
                                        draws={k: v.to(dev) for k, v in draws.items()})
        names, params = zip(*model.named_parameters())
        grads = dict(zip(names, torch.autograd.grad(total, params)))
        kept = {k: g.cpu().clone() for k, g in grads.items()}
        state, metrics = apply_gradients_if_finite(state, grads, metrics)
        metrics = {k: float(v) for k, v in metrics.items()}
        moved = max(float((p.detach() - before[k]).abs().max()) for k, p in model.named_parameters())
        results[name] = (metrics, kept, moved, state.step)
        print(f"{what} {name}: {time.perf_counter() - t0:.1f} s, {metrics}", flush=True)
        if dev.type == "cuda":
            counts = expect_counts(f"{what}, f32", *launches, tensor_cores=False, ffma_split=ffma_split)
    (m_gpu, g_gpu, moved_gpu, step_gpu), (m_cpu, g_cpu, _, _) = results["card"], results["cpu"]
    for k, v in m_cpu.items():
        if not (math.isfinite(m_gpu[k]) and abs(m_gpu[k] - v) <= TRAIN_TOL_LOSS_REL * abs(v) + 1e-6):
            raise AssertionError(f"{what}: {k} card {m_gpu[k]} vs CPU {v}")
    if m_gpu["grads_finite"] != 1.0 or step_gpu != 1 or not 0.0 < moved_gpu <= 1.01e-4:
        raise AssertionError(f"{what}: grads_finite {m_gpu['grads_finite']}, step {step_gpu}, moved {moved_gpu}")
    worst = ("", 0.0)
    for k, g in g_cpu.items():
        rel = float((g_gpu[k] - g).abs().max()) / float(g.abs().max())
        worst = max(worst, (k, rel), key=lambda kv: kv[1])
    print(f"{what} f32 card vs CPU: {len(g_cpu)} gradient leaves, largest error relative to its leaf's "
          f"largest entry {worst[1]:.3e} ({worst[0]}; tol {TRAIN_TOL_GRAD_REL}); largest parameter move "
          f"{moved_gpu:.3e} (Adam's first step is at most lr = 1e-4)", flush=True)
    if not worst[1] <= TRAIN_TOL_GRAD_REL:
        raise AssertionError(f"{what}: gradient of {worst[0]} off by {worst[1]} of its largest entry")
    return counts


def anytime_draws(n: int, z_dim: int, seed: int) -> dict:
    """``anytime_eval``'s three draws, from a numpy seed."""
    rng = np.random.default_rng(seed)
    return {"eps_cat": torch.from_numpy(rng.normal(size=(n, z_dim)).astype(np.float32)),
            "keep": torch.from_numpy(rng.uniform(size=(n, z_dim)) < 0.5),
            "eps_corr": torch.from_numpy(rng.normal(size=(n, z_dim)).astype(np.float32))}


def phase_anytime_slice(cfg, device: torch.device) -> None:
    """The anytime protocol at full width: card f32 against CPU f32, then card
    bf16 against card f32, on the same weights, packed-blocked batch and draws."""
    item = cfg.decoder.output_shape
    n = ANYTIME_BATCH
    rng = np.random.default_rng(SEED + 3)
    batch = {
        "input_packed_blocked": torch.from_numpy(pack_voxels_blocked(synthetic_grids(n, item[0], SEED + 3), 4,
                                                                     native=True)),
        "category_onehot": torch.from_numpy(np.eye(cfg.category_dim, dtype=np.float32)[rng.integers(0, cfg.category_dim, n)]),
    }
    draws = anytime_draws(n, cfg.z_category_dim, SEED + 3)
    model_cpu = MultiModalVAE(cfg, generator=torch.Generator().manual_seed(SEED))
    model_gpu = copy.deepcopy(model_cpu).to(device)
    model_bf16 = MultiModalVAE(cfg, dtype=torch.bfloat16)  # the trainer's form: f32 parameters, bf16 compute
    model_bf16.load_state_dict(model_cpu.state_dict())
    model_bf16 = model_bf16.to(device)
    on_card = {k: v.to(device) for k, v in batch.items()}
    draws_card = {k: v.to(device) for k, v in draws.items()}
    for rate in ANYTIME_RATES:
        runs = {}
        for label, model, b, d in (("card", model_gpu, on_card, draws_card), ("bf16", model_bf16, on_card, draws_card),
                                   ("cpu", model_cpu, batch, draws)):
            t0 = time.perf_counter()
            if label != "cpu":
                torch.cuda.synchronize()
                reset_counts()
            out = anytime_eval(model, b, missing_prob=rate, draws=d)
            runs[label] = {k: float(v) for k, v in out.items()}
            if label != "cpu":
                expect_counts(f"anytime {label} missing {rate}", 6 if rate else 4, 0, 0, tensor_cores=label == "bf16")
            print(f"anytime {label} missing {rate}: {time.perf_counter() - t0:.1f} s, {runs[label]}", flush=True)
        card, cpu, bf = runs["card"], runs["cpu"], runs["bf16"]
        want = {"acc_category", "loss_shape", "precision", "recall"}
        if rate:
            want |= {f"{k}_corrected" for k in want}
        if not set(card) == set(cpu) == set(bf) == want or not all(math.isfinite(v) for v in card.values()):
            raise AssertionError(f"anytime missing {rate}: outputs {sorted(card)} (want {sorted(want)}) or non-finite")
        worst = {}
        for k, v in cpu.items():
            if k.startswith("acc"):
                ok, ok_bf = card[k] == v, True  # bf16 may move a sample across a decision boundary: printed only
            elif k.startswith(("precision", "recall")):
                ok, ok_bf = abs(card[k] - v) <= ANYTIME_TOL_PR, abs(bf[k] - card[k]) <= ANYTIME_TOL_BF16_PR
            else:
                ok = abs(card[k] - v) <= ANYTIME_TOL_LOSS_REL * abs(v)
                ok_bf = abs(bf[k] - card[k]) <= ANYTIME_TOL_BF16_LOSS_REL * abs(card[k])
            worst[k] = (card[k] - v, bf[k] - card[k])
            if not ok:
                raise AssertionError(f"anytime missing {rate}: {k} card {card[k]} vs CPU {v}")
            if not ok_bf:
                raise AssertionError(f"anytime missing {rate}: {k} bf16 {bf[k]} vs f32 {card[k]}")
        print(f"anytime slice missing {rate}, B={n}: card f32 - CPU and card bf16 - card f32 by metric "
              + ", ".join(f"{k} {a:+.3e} / {b:+.3e}" for k, (a, b) in worst.items())
              + f" (tolerances: loss {ANYTIME_TOL_LOSS_REL} / {ANYTIME_TOL_BF16_LOSS_REL} relative, P/R "
              f"{ANYTIME_TOL_PR} / {ANYTIME_TOL_BF16_PR}, accuracies equal / printed)", flush=True)


def phase_anytime_timing(cfg, device: torch.device, card: str) -> dict:
    """The evaluation protocols at the quality gate's shapes: B=32, bf16
    compute, packed-blocked batches of the synthetic eval split. Returns the
    sweep's launch counts."""
    model = MultiModalVAE(cfg, generator=torch.Generator().manual_seed(SEED), dtype=torch.bfloat16).to(device)
    loader = SyntheticVoxelLoader(num_samples=256, dim=cfg.decoder.output_shape[0], num_classes=cfg.category_dim,
                                  seed=1)
    batch_fn = cli_train.build_batch_fn(loader, cfg, TRAIN_BATCH, packed=True, native=True)
    batch = to_device(batch_fn(0), device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    torch.cuda.synchronize()
    reset_counts()
    anytime_eval(model, batch, gen, missing_prob=0.5)
    anytime_eval(model, batch, gen)
    torch.cuda.synchronize()
    expect_counts("anytime, one masked and one clean batch", 6 + 4, 0, 0, tensor_cores=True)
    ms_masked = cuda_ms(lambda: anytime_eval(model, batch, gen, missing_prob=0.5), iters=10)
    ms_clean = cuda_ms(lambda: anytime_eval(model, batch, gen), iters=10)

    packs = pack_voxels_blocked.native_calls
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    table = missing_rate_sweep(model, batch_fn, SWEEP_RATES, num_batches=SWEEP_BATCHES)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    n_batches = len(SWEEP_RATES) * SWEEP_BATCHES
    counts = expect_counts("missing_rate_sweep", 6 * n_batches, 0, 0, tensor_cores=True)
    if pack_voxels_blocked.native_calls - packs != n_batches:
        raise AssertionError("missing_rate_sweep: a batch was not made by the native packer")
    for rate, row in table.items():
        if not (len(row) == 8 and all(math.isfinite(v) for v in row.values())):
            raise AssertionError(f"missing_rate_sweep at {rate}: {row}")

    with torch.no_grad():
        pred = anytime_eval(model, batch, gen, return_pred=True)["pred"]
        target = depth_to_space3d(materialize_batch(model, batch)[0]["target"], 4)
    curve = pr_curve(target, pred, acceptance_div=PR_ACCEPTANCE_DIV)
    ms_pr = cuda_ms(lambda: pr_curve(target, pred, acceptance_div=PR_ACCEPTANCE_DIV), iters=3, warmup=1)
    rows = 19 + PR_ACCEPTANCE_DIV
    if not (curve["iou"].shape == (rows,) and np.isfinite(curve["precision"]).all() and np.isfinite(curve["iou"]).all()):
        raise AssertionError(f"pr_curve: {curve}")
    best = int(curve["iou"][:19].argmax())
    print(f"anytime timing, B={TRAIN_BATCH} bf16 64^3: device time per eval batch (CUDA events, 10 calls) "
          f"anytime_eval at missing 0.5 {ms_masked:.3f} ms, at 0.0 {ms_clean:.3f} ms; missing_rate_sweep over "
          f"{SWEEP_RATES} x {SWEEP_BATCHES} batches (batch making included) {sweep_s:.3f} s wall, "
          f"{sweep_s / n_batches * 1e3:.2f} ms a batch, launches {counts}; pr_curve ({rows} rows, acceptance tail "
          f"{PR_ACCEPTANCE_DIV}) {ms_pr:.3f} ms, best threshold {curve['threshold'][best]:.2f} iou "
          f"{curve['iou'][best]:.4f} [{card}]", flush=True)
    print(f"anytime sweep (seeded weights, untrained): " + json.dumps({str(k): v for k, v in table.items()}), flush=True)
    return counts


def host_batch_ms(cfg, card: str) -> None:
    """The host's work for one train batch of ``TRAIN_BATCH``, mean of 4: the
    loader's gather and cast of the grids, then the native pack and the NumPy
    pack of the same grids (same bytes)."""
    loader = SyntheticVoxelLoader(num_samples=4 * TRAIN_BATCH, dim=cfg.decoder.output_shape[0],
                                  num_classes=cfg.category_dim, seed=2)
    t0 = time.perf_counter()
    grids = [loader.getNextBatch(TRAIN_BATCH)["input_images"] for _ in range(4)]
    t1 = time.perf_counter()
    native = [pack_voxels_blocked(g, 4, native=True) for g in grids]
    t2 = time.perf_counter()
    numpy_ = [pack_voxels_blocked(g, 4, native=False) for g in grids]
    t3 = time.perf_counter()
    if not all(np.array_equal(a, b) for a, b in zip(native, numpy_)):
        raise AssertionError("host batch: the native packer and NumPy disagree")
    print(f"host batch, B={TRAIN_BATCH} 64^3, mean of 4: loader gather and cast {(t1 - t0) / 4 * 1e3:.2f} ms, native "
          f"pack {(t2 - t1) / 4 * 1e3:.2f} ms, NumPy pack {(t3 - t2) / 4 * 1e3:.2f} ms (same bytes) [{card}]",
          flush=True)


def phase_train_run(card: str) -> dict:
    """The train CLI's path at full width: B=32, bfloat16 compute, packed
    synthetic batches, ``TRAIN_STEPS`` steps and one eval, at the trainer's
    default prefetch depth; then as many steps again at depth 0. Returns the
    launch counts of the first run."""
    t0 = time.perf_counter()
    args = cli_train.parse_args(["--config", "modelnet_nolbo", "--data", "synthetic", "--packed", "--bf16",
                                 "--batch-size", str(TRAIN_BATCH), "--steps", str(TRAIN_STEPS),
                                 "--eval-every", str(TRAIN_STEPS)])
    trainer, loader = cli_train.build_trainer(args)
    host_batch_ms(trainer.model.config, card)
    print(f"train run: model, optimizer and {loader.dataLength} + 256 synthetic shapes built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if trainer.cfg.prefetch_depth != 2:
        raise AssertionError(f"train run: the trainer's default prefetch depth is {trainer.cfg.prefetch_depth}")
    events, entries = [], []
    inner = trainer.step_fn

    def timed_step(*a, **kw):  # host clock at each step's start, CUDA events around its device work
        entries.append(time.perf_counter())
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = inner(*a, **kw)
        end.record()
        events.append((start, end))
        return out

    def timed_run(what: str) -> tuple[float, dict, int]:
        """Run the trainer to ``total_steps`` with the counts reset; returns
        the wall seconds, the launch counts and the native packer's calls,
        and prints where the run's wall went outside the steady steps."""
        events.clear()
        entries.clear()
        n_eval, packs = len(trainer.eval_history), pack_voxels_blocked.native_calls
        numpy_packs = pack_voxels_blocked.numpy_calls
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        trainer.run(epoch_fn=lambda: loader.epoch)
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        wall = t_end - t0
        print("", flush=True)  # end the logger's carriage-return line
        warm = np.diff(np.asarray(entries[: TRAIN_WARMUP + 1])) * 1e3
        print(f"{what}: wall {wall * 1e3:.1f} ms = before the first step {(entries[0] - t0) * 1e3:.1f} ms + steps "
              f"0..{TRAIN_WARMUP - 1} {', '.join(f'{v:.1f}' for v in warm)} ms + steps {TRAIN_WARMUP}.."
              f"{TRAIN_STEPS - 2} {(entries[-1] - entries[TRAIN_WARMUP]) * 1e3:.1f} ms + the last step, the eval "
              f"and the prefetcher's close {(t_end - entries[-1]) * 1e3:.1f} ms", flush=True)
        if len(trainer.eval_history) != n_eval + 1 or trainer.aborted_nan:
            raise AssertionError(f"{what}: {len(trainer.eval_history) - n_eval} evals, aborted {trainer.aborted_nan}")
        # 4 / 3 / 4 a step, 4 an eval step and 6 its anytime pass; bf16: all on the tensor cores
        counts = expect_counts(what, 4 * TRAIN_STEPS + 4 + 6, 3 * TRAIN_STEPS, 4 * TRAIN_STEPS, tensor_cores=True)
        native = pack_voxels_blocked.native_calls - packs
        if native != TRAIN_STEPS + 1 or pack_voxels_blocked.numpy_calls != numpy_packs:
            raise AssertionError(f"{what}: {native} of {TRAIN_STEPS + 1} batches packed natively, "
                                 f"{pack_voxels_blocked.numpy_calls - numpy_packs} in NumPy")
        return wall, counts, native

    def host_ms() -> np.ndarray:
        """Host wall between the starts of consecutive steps after the warm-up (no eval between them)."""
        return np.diff(np.asarray(entries[TRAIN_WARMUP:])) * 1e3

    trainer.step_fn = timed_step
    torch.cuda.reset_peak_memory_stats()
    wall, counts, native = timed_run("train run")
    peak = torch.cuda.max_memory_allocated()
    if trainer.state.step != TRAIN_STEPS or len(trainer.history) != TRAIN_STEPS:
        raise AssertionError(f"train run: {trainer.state.step} steps, {len(trainer.history)} logged")
    for row in trainer.history + trainer.eval_history:
        if not all(math.isfinite(v) for v in row.values()):
            raise AssertionError(f"train run: non-finite metric in {row}")
    anytime_keys = {k for k in trainer.eval_history[0] if k.startswith("anytime_")}
    if not {"anytime_acc_category", "anytime_acc_category_corrected", "anytime_loss_shape_corrected"} <= anytime_keys:
        raise AssertionError(f"train run: the eval has no anytime metrics ({sorted(trainer.eval_history[0])})")
    if any(row["grads_finite"] != 1.0 for row in trainer.history):
        raise AssertionError("train run: a step's gradients were not finite")
    first = trainer.history[0]["loss_total"]
    last = float(np.mean([row["loss_total"] for row in trainer.history[-5:]]))
    if not last < first:
        raise AssertionError(f"train run: loss_total did not fall ({first} -> mean of last 5 {last})")
    step_ms = np.asarray([a.elapsed_time(b) for a, b in events[TRAIN_WARMUP:]])
    host2 = host_ms()
    voxels = TRAIN_BATCH * math.prod(trainer.model.config.decoder.output_shape)
    print(f"train run: {TRAIN_STEPS} steps at B={TRAIN_BATCH}, bf16 compute, 64^3: loss_total {first:.1f} -> {last:.1f} "
          f"(mean of the last 5), eval {trainer.eval_history[0]}", flush=True)
    print(f"train run, prefetch depth 2: device time per step (CUDA events, steps {TRAIN_WARMUP}..{TRAIN_STEPS - 1}) "
          f"median {np.median(step_ms):.2f} ms, min {step_ms.min():.2f}, max {step_ms.max():.2f} "
          f"({voxels / np.median(step_ms) * 1e3:.3e} voxels/s); host wall per step, start to start, steps "
          f"{TRAIN_WARMUP}..{TRAIN_STEPS - 1}, median {np.median(host2):.2f} ms (min {host2.min():.2f}, max "
          f"{host2.max():.2f}); whole run (warm-up, batch making, a metrics fetch every step, the eval) "
          f"{wall / TRAIN_STEPS * 1e3:.2f} ms a step; {native} batches by the native packer; peak memory allocated "
          f"{peak / 2**30:.2f} GiB; launches {counts} [{card}]", flush=True)

    trainer.cfg.prefetch_depth = 0  # as many steps again, batches made between steps
    trainer.cfg.total_steps = 2 * TRAIN_STEPS
    wall0, _, _ = timed_run("train run, prefetch depth 0")
    step_ms0, host0 = np.asarray([a.elapsed_time(b) for a, b in events[TRAIN_WARMUP:]]), host_ms()
    print(f"train run, prefetch depth 0 (steps {TRAIN_STEPS}..{2 * TRAIN_STEPS - 1}): device time per step median "
          f"{np.median(step_ms0):.2f} ms; host wall per step, start to start, median {np.median(host0):.2f} ms "
          f"(min {host0.min():.2f}, max {host0.max():.2f}); whole run {wall0 / TRAIN_STEPS * 1e3:.2f} ms a step "
          f"[{card}]", flush=True)
    return counts


def serve_requests(n_requests: int, dim: int, z_dim: int, seed: int):
    """Packed grids and latent masks of ``n_requests`` requests: request i
    sends grid i % 64 and a full, partial or empty mask in turn."""
    grids = pack_voxels(synthetic_grids(64, dim, seed))
    rng = np.random.default_rng(seed)
    masks = np.ones((n_requests, z_dim), np.float32)
    masks[1::3] = rng.uniform(size=masks[1::3].shape) < 0.5
    masks[2::3] = 0.0
    return grids, masks


def http_load(port: int, grids: np.ndarray, masks: np.ndarray) -> tuple[np.ndarray, list, float, dict]:
    """``len(masks)`` requests to ``/infer`` from ``N_CLIENTS`` closed-loop
    threads; returns the latencies (s), the replies, the wall seconds and
    ``/healthz`` after the run. Fails on any client error."""
    n = len(masks)
    latencies = np.zeros(n)
    replies: list = [None] * n
    errors: list = []

    def client(idx: list) -> None:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        try:
            for i in idx:
                body = json.dumps({"voxels_packed_b64": base64.b64encode(grids[i % len(grids)].tobytes()).decode(),
                                   "mask": masks[i].tolist()})
                t = time.perf_counter()
                conn.request("POST", "/infer", body, {"Content-Type": "application/json"})
                resp = conn.getresponse()
                data = resp.read()
                latencies[i] = time.perf_counter() - t
                if resp.status != 200:
                    raise RuntimeError(f"request {i}: HTTP {resp.status} {data[:200]!r}")
                replies[i] = json.loads(data)
        except Exception as e:  # noqa: BLE001 — handed to the main thread
            errors.append(e)
        finally:
            conn.close()

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(list(range(c, n, N_CLIENTS)),)) for c in range(N_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"serve: client failures {errors!r}")
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", "/healthz")
    health = json.loads(conn.getresponse().read())
    conn.close()
    return latencies, replies, wall, health


def check_replies(what: str, replies: list, cfg, item_bytes: int, classes: int | None = None) -> None:
    """Every reply holds exactly ``category`` (an int below ``classes``,
    default the config's class count; ``classes=0``: a program without class
    anchors, whose replies hold no ``category``), ``z_mean`` and
    ``z_log_var`` of the latent's width, finite, and ``pred_packed_b64`` of
    ``item_bytes`` bytes."""
    classes = cfg.category_dim if classes is None else classes
    fields = {"z_mean", "z_log_var", "pred_packed_b64"} | ({"category"} if classes else set())
    for i, r in enumerate(replies):
        ok = (
            set(r) == fields
            and (not classes or (isinstance(r["category"], int) and 0 <= r["category"] < classes))
            and all(len(r[k]) == cfg.z_dim and all(math.isfinite(v) for v in r[k]) for k in ("z_mean", "z_log_var"))
            and len(base64.b64decode(r["pred_packed_b64"])) == item_bytes
        )
        if not ok:
            raise AssertionError(f"{what}: malformed reply {i}: {str(r)[:200]}")


def phase_serve(model: MultiModalVAE, device: torch.device, card: str) -> dict:
    """Serve the card model over HTTP; returns the launch counts of the served run."""
    cfg = model.config
    item = cfg.decoder.output_shape
    item_bytes = math.prod(item) // 8
    grids, masks = serve_requests(N_REQUESTS, item[0], cfg.z_category_dim, SEED + 1)
    server = InferenceServer(make_packed_infer(model, item), (item_bytes,), cfg.z_category_dim, batch_size=BATCH,
                             device=device)
    try:
        reset_counts()
        port = server.serve(0, background=True)
        latencies, replies, wall, health = http_load(port, grids, masks)
    finally:
        server.close()
    check_replies("serve", replies, cfg, item_bytes)
    batches = int(health["batches_run"])
    if not (health["ok"] and batches >= 2):
        raise AssertionError(f"serve: /healthz {health}")
    counts = expect_counts(f"serve, {batches} f32 batches", 4 * batches, 0, 0, tensor_cores=False)
    launches = counts["conv_k2"]
    lat = np.sort(latencies) * 1e3
    print(f"serve: {N_REQUESTS} requests from {N_CLIENTS} threads (closed loop), batch {BATCH}, "
          f"{batches} batches ({N_REQUESTS / batches:.2f} requests each), p50 {np.percentile(lat, 50):.2f} ms "
          f"p99 {np.percentile(lat, 99):.2f} ms, {N_REQUESTS / wall:.1f} shapes/s (64^3, f32), "
          f"conv_k2 launches {launches} [{card}]", flush=True)
    return counts


def state_leaves(state) -> list:
    """(name, tensor) of a train state's parameters and Adam moments, in order."""
    opt = state.optimizer.state_dict()["state"]
    return list(state.model.state_dict().items()) + [
        (f"adam {i} {k}", t) for i in sorted(opt) for k, t in sorted(opt[i].items())]


def compare_outputs(what: str, got: dict, want: dict, rel_tol: float) -> str:
    """Hold one program's outputs to another's: ``category`` equal, every float
    within ``rel_tol`` of max(1, its largest entry), packed bits flipping only
    near the threshold (``SLICE_BITS_TOL``). Returns a line of the errors."""
    if set(got) != set(want):
        raise AssertionError(f"{what}: outputs {sorted(got)} vs {sorted(want)}")
    parts = []
    for k in sorted(want):
        a, b = got[k].cpu(), want[k].cpu()
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{what} {k}: {tuple(a.shape)} {a.dtype} vs {tuple(b.shape)} {b.dtype}")
        if k == "category":
            if not torch.equal(a, b):
                raise AssertionError(f"{what}: category {a.tolist()} vs {b.tolist()}")
        elif k.endswith("_packed"):
            flips = int((np.unpackbits(a.numpy()) != np.unpackbits(b.numpy())).sum())
            parts.append(f"{k} bit flips {flips}/{a.numel() * 8}")
            if flips > SLICE_BITS_TOL * a.numel() * 8:
                raise AssertionError(f"{what}: {flips} {k} bits differ")
        else:
            err, top = float((a.float() - b.float()).abs().max()), max(1.0, float(b.float().abs().max()))
            parts.append(f"{k} max_abs_err {err:.3e}")
            if not (torch.isfinite(a).all() and err <= rel_tol * top):
                raise AssertionError(f"{what}: {k} off by {err:.3e} (tol {rel_tol * top:.3e})")
    return ", ".join(parts)


def serving_subprocesses(argvs: list, device: torch.device) -> list:
    """``python -m anytime3d_tpu_torch.cli.serve <args>`` for each ``args`` in
    ``argvs``, all started at once on ephemeral ports, as a user starts them;
    returns ``(process, port, seconds to ready)`` of each once all are ready.
    The caller terminates them."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-m", "anytime3d_tpu_torch.cli.serve", *args,
                               "--port", "0", "--device", device.type], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for args in argvs]
    lines: list = [[] for _ in procs]

    def pump(proc: subprocess.Popen, out: list) -> None:
        for line in proc.stdout:
            out.append(line)

    for proc, out in zip(procs, lines):
        threading.Thread(target=pump, args=(proc, out), daemon=True).start()
    ready: list = [None] * len(procs)
    deadline = time.monotonic() + LIFE_SERVE_START_S
    while time.monotonic() < deadline and not all(ready) and all(p.poll() is None for p in procs):
        for i, out in enumerate(lines):
            found = [line for line in out if line.startswith("serving ")]
            if ready[i] is None and found:
                print(f"cli.serve subprocess: {found[0].strip()}", flush=True)
                ready[i] = (procs[i], int(found[0].rsplit(":", 1)[1]), time.perf_counter() - t0)
        time.sleep(0.2)
    if all(ready):
        return ready
    for proc in procs:
        proc.kill()
        proc.wait()
    raise AssertionError("cli.serve did not start: " + " | ".join(
        f"{' '.join(args)}: {''.join(out)[-1000:]}" for args, out in zip(argvs, lines)))


def phase_lifecycle(cfg, device: torch.device, card: str) -> tuple[dict, dict]:
    """The model's lifecycle at full width, on the ModelNet fixtures: train
    with checkpoints, restore, evaluate the checkpoint, export, serve the
    artifact. Returns the launch counts of the train, restored and evaluate
    runs, and those of the exported programs."""
    from anytime3d_tpu_torch.cli import evaluate as cli_evaluate
    from anytime3d_tpu_torch.cli import export as cli_export
    from anytime3d_tpu_torch.data.modelnet import ModelNetLoader
    from anytime3d_tpu_torch.serving.export import export_infer, load_infer
    from anytime3d_tpu_torch.train.checkpoint import (
        CHECKPOINT_FILE, restore_params, restore_state, save_state, wait_for_saves)
    from anytime3d_tpu_torch.train.step import make_train_step

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_lifecycle_")
    try:
        ckpt = os.path.join(tmp, "ckpt")
        life_counts = dict.fromkeys(read_counts(), 0)

        def add(counts: dict) -> None:
            for k, v in counts.items():
                life_counts[k] += v

        # 1. cli.train on the fixtures: bf16, packed, checkpoints every LIFE_SAVE_EVERY steps and at the end
        args = cli_train.parse_args(["--config", "modelnet_nolbo", "--data", FIXTURES, "--packed", "--bf16",
                                     "--batch-size", str(LIFE_BATCH), "--steps", str(LIFE_STEPS),
                                     "--eval-every", str(LIFE_STEPS), "--save-path", ckpt,
                                     "--save-every", str(LIFE_SAVE_EVERY)])
        trainer, loader = cli_train.build_trainer(args)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        trainer.run(epoch_fn=lambda: loader.epoch)
        torch.cuda.synchronize()
        print("", flush=True)
        train_s = time.perf_counter() - t0
        add(expect_counts("lifecycle train", 4 * LIFE_STEPS + 4 + 6, 3 * LIFE_STEPS, 4 * LIFE_STEPS,
                          tensor_cores=True))
        rows = trainer.history + trainer.eval_history
        if trainer.state.step != LIFE_STEPS or trainer.aborted_nan or not all(
                math.isfinite(v) for row in rows for v in row.values()):
            raise AssertionError(f"lifecycle train: step {trainer.state.step}, aborted {trainer.aborted_nan}, {rows}")
        nbytes = os.path.getsize(os.path.join(ckpt, CHECKPOINT_FILE))
        print(f"lifecycle train: {LIFE_STEPS} steps at B={LIFE_BATCH} on {loader.dataLength} ModelNet fixture "
              f"shapes, bf16, saves every {LIFE_SAVE_EVERY} and at the end, {train_s:.2f} s; loss_total "
              f"{trainer.history[0]['loss_total']:.1f} -> {trainer.history[-1]['loss_total']:.1f}; checkpoint "
              f"{nbytes} bytes ({sum(p.numel() for p in trainer.model.parameters())} parameters x 3 x 4 = "
              f"{sum(p.numel() for p in trainer.model.parameters()) * 12})", flush=True)

        # the save's two halves and the restore, timed on the final state
        t0 = time.perf_counter()
        save_state(os.path.join(tmp, "timed"), trainer.state, wait=False)
        t1 = time.perf_counter()
        wait_for_saves()
        t2 = time.perf_counter()
        fresh = MultiModalVAE(cfg, generator=torch.Generator().manual_seed(SEED + 9), dtype=torch.bfloat16).to(device)
        restored = create_train_state(fresh, learning_rate=args.learning_rate)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        restore_state(ckpt, restored)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        print(f"lifecycle checkpoint: save_state(wait=False) snapshot {(t1 - t0) * 1e3:.2f} ms, commit "
              f"{(t2 - t1) * 1e3:.2f} ms; restore_state {(t4 - t3) * 1e3:.2f} ms; {nbytes} bytes [{card}]", flush=True)

        # 2. the restored state is the trainer's final state, bit for bit
        ours, theirs = state_leaves(trainer.state), state_leaves(restored)
        if restored.step != trainer.state.step or not len(ours) == len(theirs) == 4 * len(trainer.state.params):
            raise AssertionError(f"lifecycle restore: step {restored.step}, {len(theirs)} leaves of {len(ours)}")
        differ = [name for (name, a), (_, b) in zip(ours, theirs) if not torch.equal(a, b)]
        if differ:
            raise AssertionError(f"lifecycle restore: {len(differ)} leaves differ, first {differ[:3]}")
        print(f"lifecycle restore: step {restored.step}, {len(ours)} leaves (parameters, Adam moments and step "
              f"counts) equal bit for bit", flush=True)

        # 4 (before 3, whose steps move both states). cli.evaluate --ckpt against the trainer's own model
        torch.cuda.synchronize()
        reset_counts()
        table, _ = cli_evaluate.main(["--config", "modelnet_nolbo", "--data", FIXTURES, "--ckpt", ckpt, "--bf16",
                                      "--batch-size", str(LIFE_BATCH), "--batches", "1", "--rates", "0.5"])
        torch.cuda.synchronize()
        add(expect_counts("lifecycle evaluate --ckpt", 6 + 4, 0, 0, tensor_cores=True))  # sweep, then the PR curve
        trainer.model.eval()
        eval_fn = cli_train.build_batch_fn(ModelNetLoader(FIXTURES, "test", partial_num=None), cfg, LIFE_BATCH,
                                           packed=True, native=True)
        own = missing_rate_sweep(trainer.model, eval_fn, [0.5], num_batches=1)
        for k, v in own[0.5].items():
            w = table[0.5][k]
            ok = w == v if k.startswith("acc") else abs(w - v) <= (
                ANYTIME_TOL_PR if k.startswith(("precision", "recall")) else ANYTIME_TOL_LOSS_REL * abs(v))
            if not (ok and math.isfinite(w)):
                raise AssertionError(f"lifecycle evaluate --ckpt: {k} {w} vs the trainer's model {v}")
        print(f"lifecycle evaluate --ckpt: test split, missing 0.5, equal to the trainer's model: {table[0.5]}",
              flush=True)

        # 3. one step from the restored state and one from the trainer's, same batch and generator
        batch = to_device(cli_train.build_batch_fn(ModelNetLoader(FIXTURES, "train", partial_num=None), cfg,
                                                   LIFE_BATCH, packed=True, native=True)(0), device)
        loss_cfg = configs.loss_config("modelnet_nolbo")
        metrics = []
        torch.cuda.synchronize()
        reset_counts()
        for state in (trainer.state, restored):
            state.model.train()
            _, m = make_train_step(state.model, loss_cfg)(state, batch, torch.Generator(device=device).manual_seed(7))
            metrics.append({k: float(v) for k, v in m.items()})
        torch.cuda.synchronize()
        add(expect_counts("lifecycle restored step", 8, 6, 8, tensor_cores=True,
                          k4s2=(2 * k4s2_lowered(LIFE_BATCH),) * 3))
        moved = max(float((a - b).abs().max()) for (_, a), (_, b) in zip(ours, state_leaves(restored))
                    if a.is_floating_point())
        if metrics[0] != metrics[1] or not moved <= LIFE_TOL_PARAM:
            raise AssertionError(f"lifecycle restored step: metrics {metrics}, leaves apart by {moved}")
        print(f"lifecycle restored step: metrics equal ({metrics[0]}); parameters and moments after the step "
              f"within {moved:.3e} (tol {LIFE_TOL_PARAM})", flush=True)
        del trainer, restored, fresh, batch

        # 5. the f32 float-input artifact (cli.export) and a bf16 packed one (export_infer), against eager
        f32_path, bf16_path = os.path.join(tmp, "model_f32.pt2"), os.path.join(tmp, "model_bf16_packed.pt2")
        t0 = time.perf_counter()
        cli_export.main(["--config", "modelnet_nolbo", "--ckpt", ckpt, "--batch-size", str(BATCH), "--out", f32_path])
        export_f32_s = time.perf_counter() - t0
        model32 = MultiModalVAE(cfg)
        model32.load_state_dict(restore_params(ckpt, model32.state_dict()))
        model16 = copy.deepcopy(model32).to(torch.bfloat16).to(device)
        model32 = model32.to(device)
        item = cfg.decoder.output_shape
        t0 = time.perf_counter()
        data16 = export_infer(model16, (BATCH, *item), packed_input=True, packed_output=True)
        export_bf16_s = time.perf_counter() - t0
        with open(bf16_path, "wb") as fh:
            fh.write(data16)
        with open(f32_path, "rb") as fh:
            data32 = fh.read()
        fn32, fn16 = load_infer(data32), load_infer(data16)
        vox = synthetic_grids(BATCH, item[0], SEED + 4)
        x = torch.from_numpy(vox).to(device)
        packed = torch.from_numpy(pack_voxels(vox)).to(device)
        mask = torch.from_numpy(latent_masks(BATCH, cfg.z_category_dim, SEED + 4)).to(device)
        eager32, eager32_packed = make_infer_fn(model32), make_packed_infer(model32, item)
        eager16 = make_packed_infer(model16, item)
        art_counts = {}
        for label, fn, inp, tensor_cores in (("f32 float-input", fn32, x, False), ("bf16 packed", fn16, packed, True)):
            fn(inp, mask)  # warm-up, not counted
            torch.cuda.synchronize()
            reset_counts()
            outs = [fn(inp, mask) for _ in range(ARTIFACT_BATCHES)]
            torch.cuda.synchronize()
            counts = expect_counts(f"lifecycle artifact, {label}", 4 * ARTIFACT_BATCHES, 0, 0, tensor_cores)
            art_counts = {k: art_counts.get(k, 0) + v for k, v in counts.items()}
            if tensor_cores:
                line = compare_outputs("bf16 packed artifact vs eager", outs[0], eager16(packed, mask), EXPORT_TOL_BF16)
            else:
                line = compare_outputs("f32 artifact vs eager", outs[0], eager32(x, mask), EXPORT_TOL_F32)
                bits = {"pred_packed": pack_voxels_device(outs[0]["pred"])}
                line += "; its pred packed vs make_packed_infer: " + compare_outputs(
                    "f32 artifact's bits", bits, {"pred_packed": eager32_packed(packed, mask)["pred_packed"]}, 0.0)
            calls = collections.Counter(str(n.target) for n in fn.module.graph.nodes if n.op == "call_function")
            print(f"lifecycle artifact, {label}: {ARTIFACT_BATCHES} batches of {BATCH}, launches {counts}; "
                  f"against the eager program: {line}; the program makes {sum(calls.values())} calls, most often "
                  f"{calls.most_common(4)}", flush=True)
        runs = {"f32 artifact": lambda: fn32(x, mask), "f32 eager make_infer_fn": lambda: eager32(x, mask),
                "f32 eager make_packed_infer": lambda: eager32_packed(packed, mask),
                "bf16 packed artifact": lambda: fn16(packed, mask),
                "bf16 eager make_packed_infer": lambda: eager16(packed, mask)}
        first = {k: cuda_ms(f) for k, f in runs.items()}
        again = {k: cuda_ms(f) for k, f in reversed(runs.items())}
        enqueue = {k: host_enqueue_ms(f) for k, f in runs.items()}
        print(f"lifecycle export: cli.export (f32, float input) {export_f32_s:.2f} s, {len(data32)} bytes; "
              f"export_infer (bf16, packed) {export_bf16_s:.2f} s, {len(data16)} bytes; device time per batch of "
              f"{BATCH} (CUDA events, mean of 20, two rounds in opposite orders): "
              + ", ".join(f"{k} {(first[k] + again[k]) / 2:.3f} ms ({first[k]:.3f}, {again[k]:.3f})" for k in runs)
              + "; host time to enqueue one batch (the card idle before each, mean of 10): "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in enqueue.items()) + f" [{card}]", flush=True)

        # 6. cli.serve --artifact in a subprocess, beside cli.serve --checkpoint (make_packed_infer, eager) in another,
        # both started at once
        item_bytes = math.prod(item) // 8
        grids, masks = serve_requests(ARTIFACT_REQUESTS, item[0], cfg.z_category_dim, SEED + 5)
        labels = ("serve --artifact", "serve --checkpoint --bf16")
        servers = serving_subprocesses([["--artifact", bf16_path], ["--checkpoint", ckpt, "--bf16"]], device)
        served = {}
        try:
            # the first batches of a fresh process (cuDNN's algorithm choice, first launches), both servers at
            # once; not in the rate, which each server then gets alone
            with concurrent.futures.ThreadPoolExecutor(len(servers)) as pool:
                warm = list(pool.map(lambda srv: http_load(srv[1], grids[:N_CLIENTS], masks[:N_CLIENTS])[0],
                                     servers))
            for label, (_, port, started), warm_lat in zip(labels, servers, warm):
                lat, replies, wall, health = http_load(port, grids, masks)
                served[label] = (started, float(warm_lat.max()), lat, replies, wall, health)
        finally:
            for proc, _, _ in servers:
                proc.terminate()
            rcs = []
            for proc, _, _ in servers:
                try:
                    rcs.append(proc.wait(timeout=60))
                except subprocess.TimeoutExpired:
                    proc.kill()
                    rcs.append(f"killed after 60 s ({proc.wait()})")
        for (label, (_, _, _, replies, _, health)), rc in zip(served.items(), rcs):
            check_replies(label, replies, cfg, item_bytes)
            if rc != 0 or not health["ok"] or health["batches_run"] < 2:
                raise AssertionError(f"{label}: exit {rc}, /healthz {health}")
        (_, _, _, replies_a, _, _), (_, _, _, replies_e, _, _) = served.values()
        z_err = max(float(np.abs(np.subtract(a["z_mean"], e["z_mean"])).max()) for a, e in zip(replies_a, replies_e))
        z_top = max(1.0, max(float(np.abs(e["z_mean"]).max()) for e in replies_e))
        same_cat = sum(a["category"] == e["category"] for a, e in zip(replies_a, replies_e))
        # the same ops on the same weights in both servers: the same class for every request
        if same_cat != ARTIFACT_REQUESTS:
            raise AssertionError(f"serve --artifact: category differs from the eager server's in "
                                 f"{ARTIFACT_REQUESTS - same_cat} of {ARTIFACT_REQUESTS} replies")
        if not z_err <= SLICE_TOL_BF16_Z * z_top:
            raise AssertionError(f"serve --artifact: z_mean {z_err} from the eager server's")
        parts = []
        for label, (started, first, lat, _, wall, health) in served.items():
            lat = np.sort(lat) * 1e3
            parts.append(f"{label} (subprocess, started beside the other): ready {started:.2f} s, slowest of "
                         f"the first {N_CLIENTS} requests {first * 1e3:.1f} ms; then {ARTIFACT_REQUESTS / wall:.1f} shapes/s, p50 "
                         f"{np.percentile(lat, 50):.2f} ms, p99 {np.percentile(lat, 99):.2f} ms, "
                         f"{health['batches_run']} batches")
        print(f"lifecycle serve, bf16 packed, {ARTIFACT_REQUESTS} requests from {N_CLIENTS} threads, batch {BATCH}: "
              + "; ".join(parts) + f"; replies agree: category {same_cat}/{ARTIFACT_REQUESTS}, z_mean within "
              f"{z_err:.3e} [{card}]", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"lifecycle phase: {time.perf_counter() - t_phase:.1f} s wall", flush=True)
    return life_counts, art_counts


def image_draws(n: int, zc: int, zi: int, mix_prob: float, seed: int) -> dict:
    """The image train step's six draws and ``anytime_eval``'s four, from a numpy seed."""
    rng = np.random.default_rng(seed)

    def normal(d):
        return torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))

    return {"eps_cat": normal(zc), "eps_inst": normal(zi), "eps_prior_cat": normal(zc), "eps_prior_inst": normal(zi),
            "coin": torch.tensor(True), "take_prior": torch.from_numpy(rng.uniform(size=(n, zc + zi)) < mix_prob),
            "keep": torch.from_numpy(rng.uniform(size=(n, zc)) < 0.5), "eps_corr": normal(zc)}


def image_batch(cfg, n: int, rows: int, cols: int, seed: int) -> dict:
    """``n`` rendered images (rows x cols) with their voxels and one-hots,
    as the image loader makes them (numpy)."""
    loader = SyntheticImageObjectLoader(num_samples=n, dim=cfg.decoder.output_shape[0], num_classes=cfg.category_dim,
                                        num_inst=cfg.inst_dim, seed=seed)
    inst, cls, _, _, images, voxels = loader.getNextBatch(n, imageSize=(cols, rows))
    return {"input": images, "target": voxels, "category_onehot": cls, "inst_onehot": inst}


def image_step_batch(b: dict, n: int) -> dict:
    """The first ``n`` items of ``image_batch`` as the train step takes them
    (CPU tensors): images, packed-blocked targets (the native packer), one-hots."""
    return {"input": torch.from_numpy(b["input"][:n]),
            "target_packed_blocked": torch.from_numpy(pack_voxels_blocked(b["target"][:n], 4, native=True)),
            "category_onehot": torch.from_numpy(b["category_onehot"][:n]),
            "inst_onehot": torch.from_numpy(b["inst_onehot"][:n])}


def phase_image(device: torch.device, card: str) -> dict:
    """The image family at full width (``pascal_nolbo``): card against CPU,
    served batches, the bf16 train run at bench.py's image shape, the anytime
    protocol and the exported image program. Returns the launch counts of
    its served, train, anytime and exported runs, summed."""
    from anytime3d_tpu_torch.data.prefetch import _Slot
    from anytime3d_tpu_torch.serving.export import export_infer, load_infer

    t_phase = time.perf_counter()
    cfg, loss_cfg = configs.variant("pascal_nolbo")
    zc, zi = cfg.z_category_dim, cfg.z_inst_dim
    image_counts = dict.fromkeys(read_counts(), 0)

    def add(counts: dict) -> None:
        for k, v in counts.items():
            image_counts[k] += v

    # 1. float32 on the card against the CPU: serving, one train step, anytime_eval. The prior nets' dropout
    # at 0: their masks are the one draw that cannot be injected
    no_drop = dataclasses.replace(cfg, prior_category=dataclasses.replace(cfg.prior_category, dropout_rate=0.0),
                                  prior_inst=dataclasses.replace(cfg.prior_inst, dropout_rate=0.0))
    model_cpu = MultiModalVAE(no_drop, generator=torch.Generator().manual_seed(SEED))
    model_gpu = copy.deepcopy(model_cpu).to(device)
    n_params = sum(p.numel() for p in model_cpu.parameters())
    n = IMAGE_SLICE_BATCH
    b = image_batch(cfg, 16, IMAGE_SIZE, IMAGE_SIZE, SEED + 6)
    x, mask = torch.from_numpy(b["input"][:n]), torch.from_numpy(latent_masks(8, zc, SEED + 6)[2:2 + n])
    with torch.inference_mode():
        cpu = make_infer_fn(model_cpu)(x, mask)
        reset_counts()
        gpu = {k: v.cpu() for k, v in make_infer_fn(model_gpu)(x.to(device), mask.to(device)).items()}
        torch.cuda.synchronize()
    add(expect_counts("image slice, f32", 2, 0, 0, tensor_cores=False))
    err_z = float((gpu["z_mean"] - cpu["z_mean"]).abs().max())
    err_pred = float((gpu["pred"] - cpu["pred"]).abs().max())
    print(f"image slice f32 card vs CPU, B={n} {IMAGE_SIZE}x{IMAGE_SIZE}, pascal_nolbo {n_params} params: z_mean "
          f"max_abs_err {err_z:.3e}, pred max_abs_err {err_pred:.3e} (tol {SLICE_TOL_F32}), category card "
          f"{gpu['category'].tolist()} cpu {cpu['category'].tolist()}, pred std {float(gpu['pred'].std()):.4f}",
          flush=True)
    if tuple(gpu["z_mean"].shape) != (n, zc + zi) or tuple(gpu["pred"].shape) != (n, *cfg.decoder.output_shape):
        raise AssertionError(f"image slice: shapes {gpu['z_mean'].shape}, {gpu['pred'].shape}")
    if not (err_z <= SLICE_TOL_F32 and err_pred <= SLICE_TOL_F32 and torch.equal(gpu["category"], cpu["category"])):
        raise AssertionError("image slice: card f32 disagrees with the CPU")

    draws = image_draws(n, zc, zi, loss_cfg.mix_element_prob, SEED + 7)
    step_draws = {k: draws[k] for k in ("eps_cat", "eps_inst", "eps_prior_cat", "eps_prior_inst", "coin", "take_prior")}
    batch = image_step_batch(b, n)
    results = {}
    for name, model, dev in (("card", model_gpu, device), ("cpu", model_cpu, torch.device("cpu"))):
        if dev.type == "cuda":
            reset_counts()
        total, metrics = compute_losses(model, loss_cfg, {k: v.to(dev) for k, v in batch.items()},
                                        draws={k: v.to(dev) for k, v in step_draws.items()})
        names, params = zip(*model.named_parameters())
        grads = dict(zip(names, torch.autograd.grad(total, params)))
        results[name] = ({k: float(v) for k, v in metrics.items()}, {k: g.cpu() for k, g in grads.items()})
        if dev.type == "cuda":
            add(expect_counts("image train slice, f32", 2, 2, 2, tensor_cores=False))
    (m_gpu, g_gpu), (m_cpu, g_cpu) = results["card"], results["cpu"]
    for k, v in m_cpu.items():
        if not (math.isfinite(m_gpu[k]) and abs(m_gpu[k] - v) <= TRAIN_TOL_LOSS_REL * abs(v) + 1e-6):
            raise AssertionError(f"image train slice: {k} card {m_gpu[k]} vs CPU {v}")
    worst = max(((k, float((g_gpu[k] - g).abs().max()) / max(float(g.abs().max()), 1e-30)) for k, g in g_cpu.items()),
                key=lambda kv: kv[1])
    print(f"image train slice f32 card vs CPU, B={n}: metrics {m_gpu}; {len(g_cpu)} gradient leaves, worst "
          f"{worst[0]} at {worst[1]:.3e} of its largest entry (tol {TRAIN_TOL_GRAD_REL})", flush=True)
    if not worst[1] <= TRAIN_TOL_GRAD_REL:
        raise AssertionError(f"image train slice: gradient of {worst[0]} off by {worst[1]} of its largest entry")

    n = IMAGE_ANYTIME_BATCH
    any_batch = image_step_batch(b, n)
    any_draws = {k: v for k, v in image_draws(n, zc, zi, 0.5, SEED + 8).items()
                 if k in ("eps_cat", "eps_inst", "keep", "eps_corr")}
    reset_counts()
    card_any = {k: float(v) for k, v in anytime_eval(model_gpu, {k: v.to(device) for k, v in any_batch.items()},
                                                     missing_prob=0.5,
                                                     draws={k: v.to(device) for k, v in any_draws.items()}).items()}
    torch.cuda.synchronize()
    add(expect_counts("image anytime slice, f32", 4, 0, 0, tensor_cores=False))
    cpu_any = {k: float(v) for k, v in anytime_eval(model_cpu, any_batch, missing_prob=0.5, draws=any_draws).items()}
    if set(card_any) != set(cpu_any) or "acc_inst" not in card_any:
        raise AssertionError(f"image anytime: outputs {sorted(card_any)} vs {sorted(cpu_any)}")
    for k, v in cpu_any.items():
        if k.startswith("acc"):
            ok = card_any[k] == v
        elif k.startswith(("precision", "recall")):
            ok = abs(card_any[k] - v) <= ANYTIME_TOL_PR
        else:
            ok = abs(card_any[k] - v) <= ANYTIME_TOL_LOSS_REL * abs(v)
        if not (ok and math.isfinite(card_any[k])):
            raise AssertionError(f"image anytime: {k} card {card_any[k]} vs CPU {v}")
    print(f"image anytime f32 card vs CPU, B={n}, missing 0.5: card {card_any}; equal accuracies, losses within "
          f"{ANYTIME_TOL_LOSS_REL} relative, P/R within {ANYTIME_TOL_PR}", flush=True)
    del model_cpu, results, g_gpu, g_cpu

    # 2. a served batch of 8 at 64x64, f32 and bf16
    model_bf16 = copy.deepcopy(model_gpu).to(torch.bfloat16)
    x8 = torch.from_numpy(b["input"][:BATCH]).to(device)
    mask8 = torch.from_numpy(latent_masks(BATCH, zc, SEED + 6)).to(device)
    served_ms = {}
    for label, model, tensor_cores in (("f32", model_gpu, False), ("bf16", model_bf16, True)):
        infer = make_infer_fn(model)
        infer(x8, mask8)  # warm-up, not counted
        torch.cuda.synchronize()
        reset_counts()
        out = [infer(x8, mask8) for _ in range(SERVE_BF16_BATCHES)]
        torch.cuda.synchronize()
        add(expect_counts(f"image served {label}", 2 * SERVE_BF16_BATCHES, 0, 0, tensor_cores))
        if not all(torch.isfinite(o["pred"]).all() and torch.isfinite(o["z_mean"]).all() for o in out):
            raise AssertionError(f"image served {label}: non-finite outputs")
        served_ms[label] = cuda_ms(lambda: infer(x8, mask8))
    print(f"image served batch of {BATCH}, {IMAGE_SIZE}x{IMAGE_SIZE} images: device time (CUDA events, mean of 20) "
          f"f32 {served_ms['f32']:.3f} ms, bf16 {served_ms['bf16']:.3f} ms; 2 conv_k2 launches a batch [{card}]",
          flush=True)

    # 5 (before the train run frees nothing it needs). the exported f32 image program against the eager one
    t0 = time.perf_counter()
    fn = load_infer(export_infer(model_gpu, (BATCH, IMAGE_SIZE, IMAGE_SIZE, 3)))
    export_s = time.perf_counter() - t0
    fn(x8, mask8)
    torch.cuda.synchronize()
    reset_counts()
    outs = [fn(x8, mask8) for _ in range(ARTIFACT_BATCHES)]
    torch.cuda.synchronize()
    add(expect_counts("image artifact, f32", 2 * ARTIFACT_BATCHES, 0, 0, tensor_cores=False))
    line = compare_outputs("image artifact vs eager", outs[0], make_infer_fn(model_gpu)(x8, mask8), EXPORT_TOL_F32)
    print(f"image export: export_infer (f32, float input {BATCH}x{IMAGE_SIZE}x{IMAGE_SIZE}x3) {export_s:.2f} s; "
          f"loaded, against the eager program: {line}; device time per batch {cuda_ms(lambda: fn(x8, mask8)):.3f} ms "
          f"[{card}]", flush=True)
    del model_gpu, model_bf16, fn, outs

    # 4. anytime_eval at B=32, 64x64, bf16
    model = MultiModalVAE(cfg, generator=torch.Generator().manual_seed(SEED), dtype=torch.bfloat16).to(device)
    b32 = image_batch(cfg, TRAIN_BATCH, IMAGE_SIZE, IMAGE_SIZE, SEED + 9)
    a_batch = to_device({"input": b32["input"], "target_packed_blocked": pack_voxels_blocked(b32["target"], 4, True),
                         "category_onehot": b32["category_onehot"], "inst_onehot": b32["inst_onehot"]}, device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    torch.cuda.synchronize()
    reset_counts()
    masked = anytime_eval(model, a_batch, gen, missing_prob=0.5)
    anytime_eval(model, a_batch, gen)
    torch.cuda.synchronize()
    add(expect_counts("image anytime, one masked and one clean batch", 4 + 2, 0, 0, tensor_cores=True))
    if "acc_inst" not in masked or not all(math.isfinite(float(v)) for v in masked.values()):
        raise AssertionError(f"image anytime B={TRAIN_BATCH}: {masked}")
    ms_masked = cuda_ms(lambda: anytime_eval(model, a_batch, gen, missing_prob=0.5), iters=10)
    ms_clean = cuda_ms(lambda: anytime_eval(model, a_batch, gen), iters=10)
    print(f"image anytime, B={TRAIN_BATCH} bf16 {IMAGE_SIZE}x{IMAGE_SIZE}: device time per batch (CUDA events, "
          f"10 calls) at missing 0.5 {ms_masked:.3f} ms, at 0.0 {ms_clean:.3f} ms [{card}]", flush=True)
    del model, a_batch

    # 3. the train run: cli/train.py's trainer, bf16, B=32, bench.py's 96x128 images, packed-blocked targets
    args = cli_train.parse_args(["--config", "pascal_nolbo", "--data", "synthetic", "--bf16", "--batch-size",
                                 str(TRAIN_BATCH), "--steps", str(IMAGE_TRAIN_STEPS), "--eval-every", "0"])
    trainer, _ = cli_train.build_trainer(args)
    rows, cols = IMAGE_BENCH
    loader = SyntheticImageObjectLoader(num_samples=IMAGE_TRAIN_SAMPLES, dim=cfg.decoder.output_shape[0],
                                        num_classes=cfg.category_dim, num_inst=cfg.inst_dim)
    trainer.batch_fn = cli_train.build_batch_fn(loader, cfg, TRAIN_BATCH, packed=True, native=True,
                                                image_size=(cols, rows))
    # the host's batch, cold (rendering) and cached, on a loader of its own
    probe_fn = cli_train.build_batch_fn(
        SyntheticImageObjectLoader(num_samples=IMAGE_TRAIN_SAMPLES, dim=cfg.decoder.output_shape[0],
                                   num_classes=cfg.category_dim, num_inst=cfg.inst_dim, seed=5),
        cfg, TRAIN_BATCH, packed=True, native=True, image_size=(cols, rows))
    per_epoch = IMAGE_TRAIN_SAMPLES // TRAIN_BATCH
    host = []
    for i in range(2 * per_epoch):
        t0 = time.perf_counter()
        hb = probe_fn(i)
        host.append((time.perf_counter() - t0) * 1e3)
    if hb["input"].shape != (TRAIN_BATCH, rows, cols, 3) or "target_packed_blocked" not in hb:
        raise AssertionError(f"image batch: {({k: v.shape for k, v in hb.items()})}")
    # the prefetcher's pinned staging when the batch shape changes every batch (a multi-scale schedule) or not:
    # the same bytes in two shapes, so the difference is the reallocation alone; two rounds in opposite orders
    slot, turned = _Slot(), np.ascontiguousarray(hb["input"].transpose(0, 2, 1, 3))
    runs = {"same shape": [hb["input"]] * 8, "alternating shapes": [hb["input"], turned] * 4}
    stage_ms = dict.fromkeys(runs, 0.0)
    for order in (list(runs), list(runs)[::-1]):
        for label in order:
            slot.stage("input", runs[label][-1])
            t0 = time.perf_counter()
            for a in runs[label]:
                slot.stage("input", a)
            stage_ms[label] += (time.perf_counter() - t0) / len(runs[label]) * 1e3 / 2
    print(f"image host batch, B={TRAIN_BATCH} {rows}x{cols}, packed-blocked targets: cold (rendering) "
          f"{np.mean(host[:per_epoch]):.2f} ms, cached {np.mean(host[per_epoch:]):.2f} ms (means of {per_epoch}); "
          f"prefetcher staging of the images into pinned memory (mean of 8, two rounds) {stage_ms['same shape']:.3f} "
          f"ms a batch at one shape, {stage_ms['alternating shapes']:.3f} ms when the shape changes every batch "
          f"(the same bytes, {rows}x{cols} and {cols}x{rows}) [{card}]", flush=True)

    events, entries = [], []
    inner = trainer.step_fn

    def timed_step(*a, **kw):
        entries.append(time.perf_counter())
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = inner(*a, **kw)
        end.record()
        events.append((start, end))
        return out

    trainer.step_fn = timed_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    trainer.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print("", flush=True)
    add(expect_counts("image train run", 2 * IMAGE_TRAIN_STEPS, 2 * IMAGE_TRAIN_STEPS, 2 * IMAGE_TRAIN_STEPS,
                      tensor_cores=True))
    peak = torch.cuda.max_memory_allocated()
    hist = trainer.history
    if trainer.state.step != IMAGE_TRAIN_STEPS or trainer.aborted_nan or not all(
            math.isfinite(v) for row in hist for v in row.values()):
        raise AssertionError(f"image train run: step {trainer.state.step}, aborted {trainer.aborted_nan}")
    if any(row["grads_finite"] != 1.0 for row in hist):
        raise AssertionError("image train run: a step's gradients were not finite")
    step_ms = np.asarray([a.elapsed_time(e) for a, e in events[TRAIN_WARMUP:]])
    host_wall = np.diff(np.asarray(entries[-IMAGE_HOST_LAST - 1:])) * 1e3
    voxels = TRAIN_BATCH * math.prod(cfg.decoder.output_shape)
    print(f"image train run: {IMAGE_TRAIN_STEPS} steps of pascal_nolbo, B={TRAIN_BATCH} bf16, {rows}x{cols} images, "
          f"64^3 packed-blocked targets, {IMAGE_TRAIN_SAMPLES}-shape loader: loss_total {hist[0]['loss_total']:.1f} -> "
          f"{hist[-1]['loss_total']:.1f}; device time per step (CUDA events, steps {TRAIN_WARMUP}.."
          f"{IMAGE_TRAIN_STEPS - 1}) median {np.median(step_ms):.2f} ms (min {step_ms.min():.2f}, max "
          f"{step_ms.max():.2f}; {voxels / np.median(step_ms) * 1e3:.3e} voxels/s); host wall per step, start to "
          f"start, over the last {IMAGE_HOST_LAST} median {np.median(host_wall):.2f} ms (min {host_wall.min():.2f}, "
          f"max {host_wall.max():.2f}); whole run {wall:.2f} s; peak memory allocated {peak / 2**30:.2f} GiB; "
          f"launches 2 / 2 / 2 a step, all on the tensor cores [{card}]", flush=True)
    print(f"image phase: {time.perf_counter() - t_phase:.1f} s wall", flush=True)
    return image_counts


# phase 12: the detector at the reference scale (benchmarks/detector_quality.py, docs/results/detector_refscale_r5.json)
DET_FRAME = 416  # 416 x 416 frames on a 13 x 13 grid
DET_GRID = 13
DET_VOXEL = 64
DET_MAX_DETECTIONS = 32
DET_MAX_OBJECTS = 6
DET_SLOTS = 8
DET_TRAIN_BATCH = 8
DET_TRAIN_STEPS = 24
DET_SLICE_BATCH = 2  # the float32 step that is also run on the CPU
DET_SERVE_FRAMES = 50
DET_F32_STEPS = 3  # the float32 step timed and profiled
DET_IMAGE_PX = (1242, 375)  # the KITTI frame the 416 x 416 input was resized from, for the lifting
DET_K2 = (DET_TRAIN_BATCH * 4, 32, 32, 8)  # (decodes, grid, C, N) of the decoder's final conv in a train step
DET_K2_CASES = [("det_f32", torch.float32), ("det_bf16", torch.bfloat16)]
DET_SCENE_DECODES = DET_MAX_DETECTIONS * 32  # K * shape_samples: the scene pass's decodes
# card f32 vs CPU f32 of the same weights and frame: summation order through Darknet19 and the 1024-wide head
# (depths up to 9216); the fields are O(1) after GroupNorm: 1e-3 of max(1, the largest entry). Boxes: 1e-4 (normalized
# coordinates of O(1)). Shapes: occupancies in [0, 1] through the decoder, as SLICE_TOL_F32. The lifted detections'
# poses (metres through the SVD), hypothesis IoUs and projected corners (pixels): each entry to 1e-3 of max(1, its size).
DET_TOL_FIELDS = 1e-3
DET_TOL_BOX = 1e-4
DET_TOL_POSE_REL = 1e-3
DET_MIN_LIFTED = 24  # of lift_inputs' 32 car-like detections (all 32 lift on the CPU)
# the exported program against the eager one: the same ops on the same weights (EXPORT_TOL_*)


def detector_kernel_case(kernel: str, label: str, fns: tuple, exact, want: str, shape: tuple, dtype: torch.dtype,
                         card: str, iters: int = 20) -> dict:
    """One detector kernel case: checked against its plain version (and
    ``exact``) on the design ``want``, then timed as every kernel row is
    (``cuda_ms``: plain, kernel, kernel, plain) beside its library call and
    its bound. Beside them, the kernel and the library call on the card alone
    (``device_ms``, under ``device_ms`` and ``library_device_ms``: at 32
    decodes the host takes longer to enqueue an op call than the narrow
    kernels run) and the host's enqueue of a kernel call."""
    run, plain, library = fns
    n, grid, C, N = shape
    checked = check_kernel(kernel, label, run, plain, exact, want)
    warmup = 3 if iters >= 20 else 1
    p1, k1, k2_, p2 = (cuda_ms(f, iters=iters, warmup=warmup) for f in (plain, run, run, plain))
    ms, plain_ms, library_ms = (k1 + k2_) / 2, (p1 + p2) / 2, cuda_ms(library, iters=iters, warmup=warmup)
    alone, library_alone = (device_ms(f, iters=iters, warmup=warmup) for f in (run, library))
    bound_ms, bound_by = k2_bound_ms(kernel, n, C, N, dtype, grid)
    host = host_enqueue_ms(run, iters=iters)
    print(f"{kernel} {label} [{want}]: kernel {ms:.4f} ms plain {plain_ms:.4f} ms library {library_ms:.4f} ms "
          f"bound {bound_ms:.4f} ms ({bound_by}); kernel / bound {ms / bound_ms:.1f} "
          f"({100 * bound_ms / ms:.1f}% of the bound), kernel / library {ms / library_ms:.2f}; on the card alone: "
          f"kernel {alone:.4f} ms ({100 * bound_ms / alone:.1f}% of the bound) library {library_alone:.4f} ms, "
          f"kernel / library {alone / library_alone:.2f}; the host's enqueue of a kernel call {host:.4f} ms "
          f"[{card}]", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
            "device_ms": alone, "library_device_ms": library_alone,
            "max_abs_err": checked["max_abs_err"], "bound_by": bound_by, "design": checked["design"]}


def phase_detector_kernels(card: str) -> dict:
    """``conv_k2``, dx and dw at the detector decoder's final conv (32 decodes
    of 32^3, C=32 -> N=8: no wgmma plan; all three on the narrow kernels, dx
    by the plan of 8 -> 32: on ``mma.sync`` in bf16, on FFMA in f32), and the
    narrow forward at the scene pass's 1024 decodes, against their plain
    versions and float64 products, each timed beside its library call and its
    bound. Returns ``{kernel: {case: numbers}}`` as ``phase_kernels``."""
    gen = torch.Generator().manual_seed(SEED + 12)
    n, grid, C, N = DET_K2
    assert narrow_plan(DET_SCENE_DECODES, grid, grid, grid, C, N) is not None
    for _, dtype in DET_K2_CASES:
        # the forward with its dw part, and dx by the plan of the forward from N to C channels
        plan = narrow_plan(n, grid, grid, grid, C, N, dtype=dtype)
        assert plan is not None and plan.dw_splits >= 1
        assert narrow_plan(n, grid, grid, grid, N, C, dtype=dtype) is not None
    res = {k: {} for k in ("conv_k2", "conv_k2_dx", "conv_k2_dw")}
    with torch.inference_mode():
        for case, dtype in DET_K2_CASES:
            x, w, g = k2_operands(gen, (n, grid, grid, grid), C, N, dtype)
            exact = float64_products(x, w, g)
            for kernel, fns in k2_runs(x, w, g).items():
                res[kernel][case] = detector_kernel_case(kernel, f"detector {case} B={n} {grid}^3 {C}->{N}", fns,
                                                         exact[kernel], "narrow", DET_K2, dtype, card)
            del x, w, g, exact
        # the scene pass's final conv, bf16: K * S decodes, the largest grid the forward is given (x ~2.1 GB)
        n, dtype = DET_SCENE_DECODES, torch.bfloat16
        cuda_gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
        x = torch.randn(n, grid, grid, grid, C, generator=cuda_gen, device="cuda", dtype=dtype)
        w = (torch.randn(2, 2, 2, C, N, generator=cuda_gen, device="cuda") / math.sqrt(8 * C)).to(dtype)
        res["conv_k2"]["det_scene_bf16"] = detector_kernel_case(
            "conv_k2", f"detector scene pass bf16 B={n} {grid}^3 {C}->{N}", k2_runs(x, w, x[..., :N])["conv_k2"],
            float64_forward(x, w), "narrow", (n, grid, C, N), dtype, card, iters=5)
        del x, w
    return res


def detector_frame(seed: int) -> np.ndarray:
    """One (1, 416, 416, 3) rendered scene of the multi-object loader."""
    from anytime3d_tpu_torch.data.modelnet import SyntheticMultiObjectLoader

    loader = SyntheticMultiObjectLoader(num_samples=64, dim=DET_VOXEL, image_size=(DET_FRAME, DET_FRAME),
                                        grid_size=(DET_GRID, DET_GRID), max_objects=DET_MAX_OBJECTS, seed=seed)
    return loader.getNextBatch(1)[0]


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float().cpu() - b.float().cpu()).abs().max())


def compare_fields(what: str, got: dict, want: dict, tol: float, box_tol: float | None = None) -> str:
    """Every field of ``got`` within ``tol`` of ``want`` times max(1, its
    largest entry); bool fields equal; ``bbox2d`` within ``box_tol``."""
    parts = []
    for k, w in want.items():
        g = got[k]
        if tuple(g.shape) != tuple(w.shape) or not torch.isfinite(g.float()).all():
            raise AssertionError(f"{what} {k}: shape {tuple(g.shape)} (want {tuple(w.shape)}) or non-finite values")
        if w.dtype == torch.bool:
            if not torch.equal(g.cpu(), w.cpu()):
                raise AssertionError(f"{what} {k}: {g.cpu().tolist()} vs {w.cpu().tolist()}")
            parts.append(f"{k} equal ({int(w.sum())} of {w.numel()})")
            continue
        err = max_err(g, w)
        lim = box_tol if (k == "bbox2d" and box_tol is not None) else tol * max(1.0, float(w.float().abs().max()))
        parts.append(f"{k} {err:.2e}")
        if not err <= lim:
            raise AssertionError(f"{what} {k}: max_abs_err {err} > {lim}")
    return ", ".join(parts)


def lift_inputs(seed: int) -> tuple:
    """(bbox2d, bbox3d, ori_sin, ori_cos) of ``DET_MAX_DETECTIONS`` car-like
    detections: boxes in the frame's lower middle, (w, h, l) of cars in
    metres, any yaw. Every one of them lifts on the CPU."""
    rng = np.random.default_rng(seed)
    k = DET_MAX_DETECTIONS
    cx, cy = rng.uniform(0.25, 0.75, k), rng.uniform(0.45, 0.7, k)
    w, h = rng.uniform(0.05, 0.2, k), rng.uniform(0.08, 0.3, k)
    box = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2, rng.uniform(0.5, 1.0, k)], -1)
    whl = np.stack([rng.uniform(1.4, 1.9, k), rng.uniform(1.3, 1.7, k), rng.uniform(3.2, 4.6, k)], -1)
    euler = np.stack([rng.uniform(-np.pi, np.pi, k), np.zeros(k), np.zeros(k)], -1)
    return tuple(torch.from_numpy(a.astype(np.float32)) for a in (box, whl, np.sin(euler), np.cos(euler)))


def compare_lifts(what: str, got: dict, want: dict, min_lifted: int) -> str:
    """``valid`` (and ``valid_det`` where present) equal, at least
    ``min_lifted`` detections lifted, and on each lifted one every entry of
    ``pose``, ``hypothesis_iou`` and ``bbox3d_corners_px`` within
    ``DET_TOL_POSE_REL`` of max(1, its own size): metres, IoUs and pixels."""
    parts = []
    for k in ("valid", "valid_det"):
        if k in want:
            if not torch.equal(got[k].cpu(), want[k]):
                raise AssertionError(f"{what} {k}: card {got[k].tolist()} vs CPU {want[k].tolist()}")
            parts.append(f"{k} equal ({int(want[k].sum())} of {want[k].numel()})")
    lifted = want["valid"]
    if int(lifted.sum()) < min_lifted:
        raise AssertionError(f"{what}: {int(lifted.sum())} detections lifted, fewer than {min_lifted}")
    for k in ("pose", "hypothesis_iou", "bbox3d_corners_px"):
        g, w = got[k].float().cpu()[lifted], want[k].float()[lifted]
        if not torch.isfinite(g).all():
            raise AssertionError(f"{what} {k}: non-finite values")
        err = float(((g - w).abs() / w.abs().clamp_min(1.0)).max())
        parts.append(f"{k} {err:.2e}")
        if not err <= DET_TOL_POSE_REL:
            raise AssertionError(f"{what} {k}: error {err} of max(1, the entry) on the lifted detections")
    return ", ".join(parts) + f" (each entry of the {int(lifted.sum())} lifted, relative to max(1, its size))"


def profile_kernels(what: str, fn, runs: int, card: str, top: int = 10) -> None:
    """``fn`` warmed up, then ``runs`` calls under ``torch.profiler``: the
    device's busy time a call beside the wall window, and the ``top``
    longest kernels (``cli/profile.py``'s table)."""
    from torch.profiler import ProfilerActivity, profile

    from anytime3d_tpu_torch.cli.profile import print_kernels

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3 / runs
    rows = kernel_rows(prof, runs)
    busy = sum(r[1] for r in rows)
    print(f"{what}, profiled: device busy {busy:.3f} ms a call of a {window_ms:.3f} ms window "
          f"({100 * busy / window_ms:.1f}%), {sum(r[2] for r in rows):.0f} kernels a call [{card}]", flush=True)
    print_kernels(rows, busy, top, f"{what} [{card}]")


def phase_detector(device: torch.device, card: str) -> dict:
    """The multi-object detector-reconstructor at the reference scale: card
    f32 against the CPU (grid fields, detections, shapes, the scene pass),
    the served frame (exported, f32 and bf16, under sync-debug "error"), the
    scene pass at its defaults (1024 decodes) with the lifting timed alone,
    one f32 train step against the CPU, the bf16 trainer of
    ``cli/train_detector.py`` and ``evaluate_detector``, then the trainer's
    default f32 step timed and profiled. Returns the launch counts of its
    served, scene, trainer and f32 step runs, summed."""
    from anytime3d_tpu_torch.cli import train_detector as cli_det
    from anytime3d_tpu_torch.data.collate import collate_multiobject
    from anytime3d_tpu_torch.data.modelnet import SyntheticMultiObjectLoader
    from anytime3d_tpu_torch.evaluation.detection import evaluate_detector
    from anytime3d_tpu_torch.geometry import lift_detections
    from anytime3d_tpu_torch.models.detector import DetectorReconstructor
    from anytime3d_tpu_torch.models.pipeline import scene_reconstruction
    from anytime3d_tpu_torch.serving.export import export_detector, load_infer, make_detector_fn
    from anytime3d_tpu_torch.train.detector_step import DetectorLossConfig, detector_losses

    t_phase = time.perf_counter()
    det_counts = dict.fromkeys(read_counts(), 0)

    def add(counts: dict) -> None:
        for k, v in counts.items():
            det_counts[k] += v

    cfg = cli_det.detector_config(DET_VOXEL, DET_MAX_DETECTIONS)
    t0 = time.perf_counter()
    model_cpu = DetectorReconstructor(cfg, generator=torch.Generator().manual_seed(SEED))
    model_gpu = copy.deepcopy(model_cpu).to(device)
    with torch.device("meta"):
        model_bf16 = DetectorReconstructor(cfg, dtype=torch.bfloat16)
    model_bf16.load_state_dict(model_gpu.state_dict(), assign=True)  # the same float32 parameters, bf16 compute
    print(f"detector: {sum(p.numel() for p in model_cpu.parameters())} params (Darknet19, head 4 x 1024, "
          f"{cfg.head_output_dim} channels a cell, decoder to {DET_VOXEL}^3), built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    frame = torch.from_numpy(detector_frame(SEED + 12))
    frame_gpu = frame.to(device)

    # 1. f32 on the card against the CPU: fields, detections, the K slots' shapes, the scene pass
    with torch.inference_mode():
        fields = {k: v[0] for k, v in model_gpu.encode_grid(frame_gpu).items()}
        fields_cpu = {k: v[0] for k, v in model_cpu.encode_grid(frame).items()}
        line = compare_fields("detector encode_grid", fields, fields_cpu, DET_TOL_FIELDS)
        print(f"detector f32 card vs CPU, encode_grid (13x13x5): {line}", flush=True)
        det, det_cpu = model_gpu.detect(frame_gpu), model_cpu.detect(frame)
        line = compare_fields("detector detect", det, det_cpu, DET_TOL_FIELDS, DET_TOL_BOX)
        print(f"detector f32 card vs CPU, detect (K={DET_MAX_DETECTIONS}): {line}", flush=True)
        shapes = model_gpu.reconstruct(det["z_mean"], det["z_log_var"], sample=False)
        shapes_cpu = model_cpu.reconstruct(det_cpu["z_mean"], det_cpu["z_log_var"], sample=False)
        err = max_err(shapes, shapes_cpu)
        print(f"detector f32 card vs CPU, reconstruct of the {DET_MAX_DETECTIONS} slots ({DET_VOXEL}^3): max_abs_err "
              f"{err:.2e} (tol {SLICE_TOL_F32}), occupied {float((shapes > 0.5).float().mean()):.4f}", flush=True)
        if not err <= SLICE_TOL_F32:
            raise AssertionError("detector reconstruct: card f32 disagrees with the CPU")
    scene = scene_reconstruction(model_gpu, frame_gpu, DET_IMAGE_PX, sample_shapes=False)
    DETECTOR_SCENE.update(frame=frame[0], scene=scene)  # drawn in phase 17
    scene_cpu = scene_reconstruction(model_cpu, frame, DET_IMAGE_PX, sample_shapes=False)
    line = compare_lifts("detector scene", scene, scene_cpu, 1)
    print(f"detector f32 card vs CPU, scene_reconstruction (sample_shapes=False): {line}", flush=True)
    # the lifting on K car-like detections, clear of the borders, which lift as a trained detector's would
    lift_in = lift_inputs(SEED + 14)
    lifts = lift_detections(*(t.to(device) for t in lift_in), image_size=DET_IMAGE_PX)
    line = compare_lifts("detector lift_detections", lifts, lift_detections(*lift_in, image_size=DET_IMAGE_PX),
                         DET_MIN_LIFTED)
    print(f"detector f32 card vs CPU, lift_detections of {DET_MAX_DETECTIONS} car-like detections: {line}", flush=True)
    del model_cpu, fields_cpu, det_cpu, shapes_cpu, scene_cpu

    # 2. the served frame: exported, f32 and bf16, each against its eager program; sync-debug "error"
    served = {}
    for label, model, tol in (("f32", model_gpu, EXPORT_TOL_F32), ("bf16", model_bf16, EXPORT_TOL_BF16)):
        t0 = time.perf_counter()
        fn = load_infer(export_detector(model, (1, DET_FRAME, DET_FRAME, 3)))
        export_s = time.perf_counter() - t0
        eager = make_detector_fn(model)(frame_gpu)
        fn(frame_gpu)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        torch.cuda.set_sync_debug_mode("error")
        try:
            outs = [fn(frame_gpu) for _ in range(DET_SERVE_FRAMES)]
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        add(expect_counts(f"detector served frames, {label}", DET_SERVE_FRAMES, 0, 0, tensor_cores=False,
                          narrow=(DET_SERVE_FRAMES, 0, 0)))
        peak = torch.cuda.max_memory_allocated()
        line = compare_fields(f"detector artifact {label} vs eager", outs[-1], eager, tol)
        ms = cuda_ms(lambda: fn(frame_gpu), iters=DET_SERVE_FRAMES)
        host = host_enqueue_ms(lambda: fn(frame_gpu), iters=DET_SERVE_FRAMES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DET_SERVE_FRAMES):
            fn(frame_gpu)["valid"].cpu()
        wall = (time.perf_counter() - t0) / DET_SERVE_FRAMES * 1e3
        served[label] = ms
        print(f"detector served frame {label}: export_detector + load_infer {export_s:.2f} s; against the eager "
              f"program: {line}; {DET_SERVE_FRAMES} frames under sync-debug 'error', 1 conv_k2 launch a frame "
              f"(narrow); "
              f"device time a frame (CUDA events, mean of {DET_SERVE_FRAMES}) {ms:.3f} ms, host to enqueue one "
              f"{host:.3f} ms, wall a frame to its valid mask on the host {wall:.3f} ms; peak memory allocated "
              f"{peak / 2**30:.2f} GiB; valid {int(outs[-1]['valid'].sum())} of {DET_MAX_DETECTIONS} [{card}]",
              flush=True)
        profile_kernels(f"detector served frame {label}", lambda: fn(frame_gpu), 5, card)
        del fn, outs, eager

    # 3. the scene pass at its defaults, bf16: K * S = 1024 decodes, then the lifting (batched SVD) alone
    gen = torch.Generator(device=device).manual_seed(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out = scene_reconstruction(model_bf16, frame_gpu, DET_IMAGE_PX, generator=gen)
    torch.cuda.synchronize()
    add(expect_counts("detector scene pass", 1, 0, 0, tensor_cores=False, narrow=(1, 0, 0)))
    s = cfg.shape_samples
    assert DET_MAX_DETECTIONS * s == DET_SCENE_DECODES  # the shape phase_detector_kernels checks
    if tuple(out["shapes"].shape) != (DET_MAX_DETECTIONS, DET_VOXEL, DET_VOXEL, DET_VOXEL) or not all(
            torch.isfinite(out[k].float()).all() for k in ("shapes", "pose", "bbox3d_corners_px")):
        raise AssertionError(f"detector scene pass: shapes {tuple(out['shapes'].shape)} or non-finite values")
    peak = torch.cuda.max_memory_allocated()
    reset_counts()
    scene_ms = cuda_ms(lambda: scene_reconstruction(model_bf16, frame_gpu, DET_IMAGE_PX, generator=gen), iters=5,
                       warmup=1)
    add(expect_counts("detector scene pass, timed", 6, 0, 0, tensor_cores=False, narrow=(6, 0, 0)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        scene_reconstruction(model_bf16, frame_gpu, DET_IMAGE_PX, generator=gen)["valid"].cpu()
    scene_wall = (time.perf_counter() - t0) / 5 * 1e3
    with torch.inference_mode():
        det16 = model_bf16.detect(frame_gpu)
        lift_args = (det16["bbox2d"], det16["bbox3d"], det16["ori_sin"], det16["ori_cos"])
        lift_ms = cuda_ms(lambda: lift_detections(*lift_args, image_size=DET_IMAGE_PX, valid=det16["valid"]))
        svd_in = torch.randn(DET_MAX_DETECTIONS * 128, 4, 4, device=device)
        svd_ms = cuda_ms(lambda: torch.linalg.svd(svd_in, full_matrices=True))
        detect_ms = cuda_ms(lambda: model_bf16.detect(frame_gpu))
        z = det16["z_mean"].repeat_interleave(s, dim=0)
        decode_ms = cuda_ms(lambda: model_bf16.decoder(z), iters=5, warmup=1)
    print(f"detector scene pass, bf16, sample_shapes=True ({DET_MAX_DETECTIONS} x {s} = {DET_MAX_DETECTIONS * s} "
          f"decodes at {DET_VOXEL}^3, 1 narrow conv_k2 launch): device time (CUDA events, mean of 5) "
          f"{scene_ms:.2f} ms, wall "
          f"to its valid mask on the host {scene_wall:.2f} ms; inside it: detect {detect_ms:.3f} ms, the "
          f"{DET_MAX_DETECTIONS * s} decodes {decode_ms:.2f} ms, lift_detections {lift_ms:.3f} ms (its batched SVD of "
          f"{DET_MAX_DETECTIONS * 128} 4x4 systems alone {svd_ms:.3f} ms); peak memory allocated "
          f"{peak / 2**30:.2f} GiB; lifted {int(out['valid'].sum())} of {int(out['valid_det'].sum())} detections "
          f"[{card}]", flush=True)
    del out, det16, z

    # 4. one f32 train step, B=2, card against CPU: same weights, batch and draws
    loss_cfg = DetectorLossConfig()
    loader = SyntheticMultiObjectLoader(num_samples=64, dim=DET_VOXEL, image_size=(DET_FRAME, DET_FRAME),
                                        grid_size=(DET_GRID, DET_GRID), max_objects=DET_MAX_OBJECTS, seed=SEED + 13)
    images, targets, vlists = loader.getNextBatch(DET_SLICE_BATCH)
    batch = {k: torch.from_numpy(v) for k, v in collate_multiobject(images, targets, vlists, DET_SLOTS).items()}
    rng = np.random.default_rng(SEED + 13)
    draws = {"eps_z": torch.from_numpy(rng.normal(size=(DET_SLICE_BATCH, loss_cfg.shape_decode_per_image,
                                                        cfg.z_inst_dim)).astype(np.float32))}
    model_cpu = copy.deepcopy(model_gpu).cpu()
    results = {}
    for name, model, dev in (("card", model_gpu, device), ("cpu", model_cpu, torch.device("cpu"))):
        t0 = time.perf_counter()
        if dev.type == "cuda":
            reset_counts()
        total, metrics = detector_losses(model, loss_cfg, {k: v.to(dev) for k, v in batch.items()},
                                         draws={k: v.to(dev) for k, v in draws.items()})
        names, params = zip(*model.named_parameters())
        grads = torch.autograd.grad(total, params, allow_unused=True, materialize_grads=True)
        finite = float(torch.stack([torch.isfinite(g).all() for g in grads]).all())
        results[name] = ({k: float(v) for k, v in metrics.items()}, {k: g.cpu() for k, g in zip(names, grads)}, finite)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            add(expect_counts("detector train slice, f32", 1, 1, 1, tensor_cores=False, narrow=(1, 1, 1)))
        print(f"detector train slice {name}: {time.perf_counter() - t0:.1f} s, {results[name][0]}", flush=True)
    (m_gpu, g_gpu, fin_gpu), (m_cpu, g_cpu, _) = results["card"], results["cpu"]
    for k, v in m_cpu.items():
        if not (math.isfinite(m_gpu[k]) and abs(m_gpu[k] - v) <= TRAIN_TOL_LOSS_REL * abs(v) + 1e-6):
            raise AssertionError(f"detector train slice: {k} card {m_gpu[k]} vs CPU {v}")
    worst = ("", 0.0)
    for k, g in g_cpu.items():
        top = float(g.abs().max())
        rel = float((g_gpu[k] - g).abs().max()) / top if top > 0 else float((g_gpu[k] - g).abs().max())
        worst = max(worst, (k, rel), key=lambda kv: kv[1])
    print(f"detector train slice f32 card vs CPU, B={DET_SLICE_BATCH} {DET_FRAME}x{DET_FRAME}: every loss term within "
          f"{TRAIN_TOL_LOSS_REL}; {len(g_cpu)} gradient leaves, largest error relative to its leaf's largest entry "
          f"{worst[1]:.3e} ({worst[0]}; tol {TRAIN_TOL_GRAD_REL}); grads_finite {fin_gpu}", flush=True)
    if not (worst[1] <= TRAIN_TOL_GRAD_REL and fin_gpu == 1.0):
        raise AssertionError(f"detector train slice: gradient of {worst[0]} off by {worst[1]}, finite {fin_gpu}")
    del model_cpu, results, g_gpu, g_cpu, model_gpu, model_bf16

    # 5. cli/train_detector.py's trainer at the reference scale: bf16, packed voxels, uint8 images
    args = cli_det.parse_args(["--bf16", "--batch-size", str(DET_TRAIN_BATCH), "--image-size", str(DET_FRAME),
                               str(DET_FRAME), "--grid-size", str(DET_GRID), str(DET_GRID), "--voxel-dim",
                               str(DET_VOXEL), "--max-slots", str(DET_SLOTS), "--max-objects", str(DET_MAX_OBJECTS),
                               "--max-detections", str(DET_MAX_DETECTIONS), "--steps", str(DET_TRAIN_STEPS)])
    trainer, loader = cli_det.build_trainer(args)
    dense = cli_det.build_batch_fn(
        SyntheticMultiObjectLoader(num_samples=1024, dim=DET_VOXEL, image_size=(DET_FRAME, DET_FRAME),
                                   grid_size=(DET_GRID, DET_GRID), max_objects=DET_MAX_OBJECTS, seed=7),
        DET_TRAIN_BATCH, DET_SLOTS)

    def probe(i: int) -> dict:
        return cli_det.transfer_forms(dense(i))

    host = []
    for i in range(6):
        t0 = time.perf_counter()
        hb = probe(i)
        host.append((time.perf_counter() - t0) * 1e3)
    if hb["images"].dtype != np.uint8 or hb["voxels_packed"].shape != (DET_TRAIN_BATCH, DET_SLOTS, DET_VOXEL**3 // 8):
        raise AssertionError(f"detector batch: {({k: (v.shape, v.dtype) for k, v in hb.items()})}")
    events, entries = [], []
    inner = trainer.step_fn

    def timed_step(*a, **kw):
        entries.append(time.perf_counter())
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = inner(*a, **kw)
        end.record()
        events.append((start, end))
        return out

    trainer.step_fn = timed_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    trainer.run(epoch_fn=lambda: loader.epoch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print("", flush=True)
    add(expect_counts("detector train run", DET_TRAIN_STEPS, DET_TRAIN_STEPS, DET_TRAIN_STEPS, tensor_cores=False,
                      narrow=(DET_TRAIN_STEPS,) * 3))
    peak = torch.cuda.max_memory_allocated()
    hist = trainer.history
    if trainer.state.step != DET_TRAIN_STEPS or trainer.aborted_nan or not all(
            math.isfinite(v) for row in hist for v in row.values()):
        raise AssertionError(f"detector train run: step {trainer.state.step}, aborted {trainer.aborted_nan}")
    if any(row["grads_finite"] != 1.0 for row in hist):
        raise AssertionError("detector train run: a step's gradients were not finite")
    step_ms = np.asarray([a.elapsed_time(e) for a, e in events[TRAIN_WARMUP:]])
    host_wall = np.diff(np.asarray(entries[TRAIN_WARMUP:])) * 1e3
    print(f"detector train run: {DET_TRAIN_STEPS} steps of cli/train_detector.py's trainer, bf16, B={DET_TRAIN_BATCH} "
          f"{DET_FRAME}x{DET_FRAME} uint8 frames, {DET_GRID}x{DET_GRID} grid, up to {DET_MAX_OBJECTS} objects, "
          f"{DET_VOXEL}^3 packed voxels in {DET_SLOTS} slots: loss_total {hist[0]['loss_total']:.2f} -> "
          f"{hist[-1]['loss_total']:.2f}; device time per step (CUDA events, steps {TRAIN_WARMUP}..{DET_TRAIN_STEPS - 1}) "
          f"median {np.median(step_ms):.2f} ms (min {step_ms.min():.2f}, max {step_ms.max():.2f}); host wall per "
          f"step, start to start, median {np.median(host_wall):.2f} ms (min {host_wall.min():.2f}, max "
          f"{host_wall.max():.2f}); whole run {wall:.2f} s; the host's batch (up to {DET_TRAIN_BATCH * DET_MAX_OBJECTS} "
          f"renders, collate, pack) {np.median(host):.2f} ms median of {len(host)} (min {min(host):.2f}); peak memory "
          f"allocated {peak / 2**30:.2f} GiB; launches 1 / 1 / 1 a step, all three narrow [{card}]",
          flush=True)

    # 6. evaluate_detector on 2 batches of the training loader, as the CLI ends, on the trained model
    t0 = time.perf_counter()
    det = evaluate_detector(trainer.model, cli_det.build_batch_fn(loader, DET_TRAIN_BATCH, DET_SLOTS), num_batches=2)
    eval_s = time.perf_counter() - t0
    if not all(math.isfinite(v) for v in det.values()):
        raise AssertionError(f"detector eval: {det}")
    print(f"detector eval: evaluate_detector on 2 batches of {DET_TRAIN_BATCH} frames {eval_s:.2f} s, "
          f"{ {k: round(v, 4) for k, v in det.items()} } [{card}]", flush=True)

    # where a train step's time goes: its kernels over 3 more steps (after the eval: they move the model)
    gen = torch.Generator(device=device).manual_seed(SEED)
    batch = trainer.to_device(probe(0))
    profile_kernels(f"detector train step bf16 B={DET_TRAIN_BATCH}", lambda: inner(trainer.state, batch, gen), 3, card)
    del trainer, inner, batch

    # 7. the default trainer's step: float32 (cli/train_detector.py without --bf16), B=8, by events and by kernel
    args = cli_det.parse_args(["--batch-size", str(DET_TRAIN_BATCH), "--image-size", str(DET_FRAME), str(DET_FRAME),
                               "--grid-size", str(DET_GRID), str(DET_GRID), "--voxel-dim", str(DET_VOXEL),
                               "--max-slots", str(DET_SLOTS), "--max-objects", str(DET_MAX_OBJECTS),
                               "--max-detections", str(DET_MAX_DETECTIONS), "--steps", "1"])
    trainer, _ = cli_det.build_trainer(args)
    step, batch = trainer.step_fn, trainer.to_device(probe(1))
    if any(p.dtype != torch.float32 for p in trainer.model.parameters()):
        raise AssertionError("detector f32 train step: the default trainer's parameters are not all float32")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    step_ms = cuda_ms(lambda: step(trainer.state, batch, gen), iters=DET_F32_STEPS, warmup=1)
    peak = torch.cuda.max_memory_allocated()
    finite = float(step(trainer.state, batch, gen)[1]["grads_finite"])
    print(f"detector train step f32 B={DET_TRAIN_BATCH} (cli/train_detector.py's default): device time (CUDA events, "
          f"mean of {DET_F32_STEPS} after 1) {step_ms:.2f} ms; peak memory allocated {peak / 2**30:.2f} GiB; "
          f"grads_finite {finite} [{card}]", flush=True)
    if finite != 1.0:
        raise AssertionError("detector f32 train step: a gradient was not finite")
    profile_kernels(f"detector train step f32 B={DET_TRAIN_BATCH}", lambda: step(trainer.state, batch, gen),
                    DET_F32_STEPS, card)
    n_steps = 1 + DET_F32_STEPS + 1 + 2 + DET_F32_STEPS  # cuda_ms, the finite check, profile_kernels
    add(expect_counts("detector train step, f32", n_steps, n_steps, n_steps, tensor_cores=False,
                      narrow=(n_steps,) * 3))
    print(f"detector phase: {time.perf_counter() - t_phase:.1f} s wall", flush=True)
    return det_counts


def phase_stem_kernels(card: str) -> dict:
    """``conv_k2`` and dw at the classic encoder's space-to-depth(2) stem
    (64^3 x 1 folded to 32^3 x 8, C=8 -> N=64: no wgmma or narrow plan) at
    B=8 and B=32 in float32 and bfloat16, on their routes: the bfloat16
    forward on the wide plan (the chunked dx's kernel run forward), the
    float32 forward on the FFMA GEMM; dw in bfloat16 on the dw-only narrow
    plan, in float32 on the FFMA dw's 64 x 64 tile (fitted to 8C = 64 rows).
    Each against its plain version and a float64 product of the same
    operands, timed by events and on the card alone beside its library call
    and its bound, each row labelled with the route it took; the bfloat16
    forward also beside the FFMA GEMM it replaced, launched straight through
    the library on the card alone. Returns ``{kernel: {case: numbers}}`` as
    ``phase_kernels``, the bfloat16 forward rows also under ``conv_k2_wide``,
    the bfloat16 dw rows under ``conv_k2_dw_wide`` and the float32 dw rows
    under ``conv_k2_dw_ffma_fit``."""
    from anytime3d_tpu_torch.kernels import conv_k2 as k2mod

    grid, C, N = STEM_K2
    gen = torch.Generator().manual_seed(SEED + 13)
    res = {"conv_k2": {}, "conv_k2_dw": {}, "conv_k2_wide": {}, "conv_k2_dw_wide": {}, "conv_k2_dw_ffma_fit": {}}
    routes = {("conv_k2", torch.bfloat16): "wide", ("conv_k2", torch.float32): "ffma",
              ("conv_k2_dw", torch.bfloat16): "narrow", ("conv_k2_dw", torch.float32): "ffma_fit"}
    entries = {"wide": "conv_k2_wide", "narrow": "conv_k2_dw_wide", "ffma_fit": "conv_k2_dw_ffma_fit"}
    with torch.inference_mode():
        for case, batch, dtype in STEM_CASES:
            assert wgmma_plan(batch, grid, grid, grid, C, N) is None
            assert narrow_plan(batch, grid, grid, grid, C, N, dtype=dtype) is None
            wide_dw = narrow_dw_plan(batch, grid, grid, grid, C, N, dtype=dtype)
            wide_fwd = wide_plan(batch, grid, grid, grid, C, N, dtype=dtype)
            assert (wide_dw is not None) == (wide_fwd is not None) == (dtype == torch.bfloat16)
            assert ffma_dw_fitted(C, N)
            x, w, g = k2_operands(gen, (batch, grid, grid, grid), C, N, dtype)
            exact = float64_products(x, w, g)
            runs = k2_runs(x, w, g)
            for kernel in ("conv_k2", "conv_k2_dw"):
                run, plain, library = runs[kernel]
                route = routes[kernel, dtype]
                label = f"s2d(2) stem {case} B={batch} {grid}^3 {C}->{N}"
                checked = check_kernel(kernel, label, run, plain, None, route)
                # held to float64 too: f32 sums of at most 64 (forward) or 2^20 (dw) products
                out, ref, top64 = run(), plain(), float(exact[kernel].abs().max())
                if kernel == "conv_k2_dw":
                    tol64 = K2_TOL_DW_F64_REL * top64
                elif dtype == torch.float32:
                    tol64 = K2_TOL_F32_F64_REL * top64
                else:
                    tol64 = (2.0**-8 + K2_TOL_DW_F64_REL) * top64
                err_k, err_p = (float((t.double() - exact[kernel]).abs().max()) for t in (out, ref))
                p1, k1, k2_, p2 = cuda_ms(plain), cuda_ms(run), cuda_ms(run), cuda_ms(plain)
                ms, plain_ms, library_ms = (k1 + k2_) / 2, (p1 + p2) / 2, cuda_ms(library)
                # on the card alone, kernel and library in turns
                a1, l1, l2, a2 = (device_ms(f, iters=50) for f in (run, library, library, run))
                alone, library_alone = (a1 + a2) / 2, (l1 + l2) / 2
                bound_ms, bound_by = k2_bound_ms(kernel, batch, C, N, dtype, grid)
                detail = ""
                if route == "narrow":
                    detail = (f" (dw-only plan: box {wide_dw.dw_box}, {wide_dw.dw_splits} splits of "
                              f"{wide_dw.dw_boxes_per_split} boxes)")
                elif route == "ffma_fit":
                    splits, per_split = k2mod.ffma_dw_split(batch * grid**3, C, N, dtype=dtype)
                    bm, bn, per_sm = k2mod._ffma_dw_tile(C, N)
                    detail = f" ({bm} x {bn} tiles, {per_sm} blocks an SM, {splits} splits of {per_split} stages)"
                elif route == "wide":
                    # the route it replaced, the bf16 FFMA GEMM, launched straight through the library
                    y = torch.empty(batch, grid, grid, grid, N, dtype=dtype, device=x.device)
                    ffma = lambda: k2mod._check_launch("FFMA forward", k2mod._lib().conv_k2_forward(  # noqa: E731
                        x.data_ptr(), w.data_ptr(), y.data_ptr(), 0, 1, 8 * C // 16, batch, grid, grid, grid, C, N,
                        1, x.device.index, k2mod._stream(x)))
                    f1, f2 = device_ms(ffma, iters=50), device_ms(ffma, iters=50)
                    detail = (f" (box {wide_fwd.box}, {wide_fwd.chunks} chunk of {wide_fwd.bn}, {wide_fwd.stages} "
                              f"halo stages, {wide_fwd.grid} blocks; the FFMA GEMM it replaced, alone "
                              f"{(f1 + f2) / 2:.4f} ms ({f1:.4f}, {f2:.4f}))")
                print(f"{kernel} {label} [{route}]{detail}: against float64 (largest entry {top64:.3e}) kernel "
                      f"{err_k:.3e} plain {err_p:.3e} (tol {tol64:.3e}); kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
                      f"library {library_ms:.4f} ms bound {bound_ms:.4f} ms ({bound_by}); on the card alone kernel "
                      f"{alone:.4f} ms ({a1:.4f}, {a2:.4f}) library {library_alone:.4f} ms ({l1:.4f}, {l2:.4f}); "
                      f"kernel / bound {ms / bound_ms:.1f} (alone {alone / bound_ms:.1f}), kernel / library "
                      f"{ms / library_ms:.2f} (alone {alone / library_alone:.2f}) [{card}]", flush=True)
                if not (err_k <= tol64 and err_p <= tol64):
                    raise AssertionError(f"{kernel} {label}: off the float64 product")
                row = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
                       "max_abs_err": checked["max_abs_err"], "bound_by": bound_by, "design": route,
                       "device_ms": alone, "library_device_ms": library_alone}
                res[kernel][case] = row
                if route in entries:
                    res[entries[route]][case] = row
            del x, w, g, exact, runs
    return res


def phase_k4s2_kernels(card: str) -> dict:
    """The lowered stride-2 k=4 conv (``kernels/conv_k4s2.py``) at the flagship encoder's two stages in
    bfloat16: its forward, dx and dw (each counter moves once a call) against their plain versions (the
    lowering in PyTorch) and the float64 products of the same operands (``F.conv3d`` and its gradients in
    float64), timed by events and on the card alone beside their bound (``k2_bound_ms`` of the lowered
    k=2 conv, 8C -> N at the output grid: the taps that land on x's grid, not on the pad) and cuDNN's
    ``F.conv3d``, ``conv3d_input`` and ``conv3d_weight`` on the operands ``Conv3d`` handed it before the
    lowering (x padded (1, 1) and permuted, the weight in bf16), on the card alone with cuDNN's default
    heuristic and with ``cudnn.benchmark`` (the fastest engine it finds, picked in a warm-up call, named
    by a profile of one call). Returns ``{kernel: {case: numbers}}``."""
    from anytime3d_tpu_torch.kernels import conv_k4s2 as k4

    res = {"conv_k4s2": {}, "conv_k4s2_dx": {}, "conv_k4s2_dw": {}}
    gen = torch.Generator().manual_seed(SEED + 27)
    dev = torch.device("cuda")
    for batch in K4S2_BATCHES:
        for n, C, N in K4S2_STAGES:
            m = n // 2
            plan, dx_plan = k4.k4s2_plans(batch, m, m, m, C, N, sms=torch.cuda.get_device_properties(0)
                                          .multi_processor_count)
            x = torch.randn(batch, n, n, n, C, generator=gen).to(dev, torch.bfloat16)
            w = (torch.randn(N, C, 4, 4, 4, generator=gen) / math.sqrt(64 * C)).to(dev)
            g = torch.randn(batch, m, m, m, N, generator=gen).to(dev, torch.bfloat16)
            w16 = w.to(torch.bfloat16)
            x64, w64 = x.double().requires_grad_(), w16.double().requires_grad_()
            y64 = F.conv3d(F.pad(x64.permute(0, 4, 1, 2, 3), (1, 1) * 3), w64, stride=2)
            dx64, dw64 = torch.autograd.grad(y64, (x64, w64), g.double().permute(0, 4, 1, 2, 3))
            exact = {"conv_k4s2": y64.detach().permute(0, 2, 3, 4, 1), "conv_k4s2_dx": dx64, "conv_k4s2_dw": dw64}
            del x64, w64, y64
            x_pad = F.pad(x.permute(0, 4, 1, 2, 3), (1, 1) * 3)
            g_nc = g.permute(0, 4, 1, 2, 3)
            runs = {
                "conv_k4s2": (lambda: k4.conv_k4s2(x, w), lambda: k4.conv_k4s2_reference(x, w),
                              lambda: F.conv3d(x_pad, w16, stride=2)),
                "conv_k4s2_dx": (lambda: k4.conv_k4s2_dx(g, w, (n, n, n)),
                                 lambda: k4.conv_k4s2_dx_reference(g, w, (n, n, n)),
                                 lambda: torch.nn.grad.conv3d_input(x_pad.shape, w16, g_nc, stride=2)),
                "conv_k4s2_dw": (lambda: k4.conv_k4s2_dw(x, g), lambda: k4.conv_k4s2_dw_reference(x, g),
                                 lambda: torch.nn.grad.conv3d_weight(x_pad, w16.shape, g_nc, stride=2)),
            }
            counters = {"conv_k4s2": "launches", "conv_k4s2_dx": "launches_dx", "conv_k4s2_dw": "launches_dw"}
            with torch.inference_mode():
                for kernel, (run, plain, library) in runs.items():
                    label = f"B={batch} {n}^3 -> {m}^3 {C}->{N}"
                    before = getattr(k4.conv_k4s2, counters[kernel])
                    out, ref = run(), plain()
                    torch.cuda.synchronize()
                    if getattr(k4.conv_k4s2, counters[kernel]) != before + 1:
                        raise AssertionError(f"{kernel} {label}: its counter did not move once")
                    top, top64 = float(ref.float().abs().max()), float(exact[kernel].abs().max())
                    err = float((out.float() - ref.float()).abs().max())
                    err_k, err_p = (float((t.double() - exact[kernel]).abs().max()) for t in (out, ref))
                    if kernel == "conv_k4s2_dw":
                        tol, tol64 = 2 * K2_TOL_DW_F64_REL * top, K2_TOL_DW_F64_REL * top64
                        if not torch.equal(out, run()):
                            raise AssertionError(f"{kernel} {label}: differs between two calls")
                    else:
                        tol, tol64 = K2_TOL_BF16_REL * top, (2.0**-8 + K2_TOL_DW_F64_REL) * top64
                    p1, k1, k2_, p2 = cuda_ms(plain), cuda_ms(run), cuda_ms(run), cuda_ms(plain)
                    ms, plain_ms, library_ms = (k1 + k2_) / 2, (p1 + p2) / 2, cuda_ms(library)
                    a1, l1, l2, a2 = (device_ms(f, iters=50) for f in (run, library, library, run))
                    alone, library_alone = (a1 + a2) / 2, (l1 + l2) / 2
                    # cuDNN with benchmark on: the engine it finds fastest for these operands
                    torch.backends.cudnn.benchmark = True
                    try:
                        engines = profile_rows(library, runs=1)  # its unprofiled first call picks the engine
                        engine = engines[0][0] if engines else "not profiled"
                        b1, b2 = device_ms(library, iters=50), device_ms(library, iters=50)
                    finally:
                        torch.backends.cudnn.benchmark = False
                    bench_alone = (b1 + b2) / 2
                    bound_ms, bound_by = k2_bound_ms("conv_k2_dw" if kernel == "conv_k4s2_dw" else "conv_k2", batch,
                                                     8 * C, N, torch.bfloat16, grid=m)
                    walk = (f"box {plan.box} x {plan.box_items}, {plan.bm} x {plan.bn} tiles, {plan.splits} splits"
                            if kernel == "conv_k4s2" else
                            f"box {dx_plan.box} x {dx_plan.box_items}, {dx_plan.bm} x {dx_plan.bn} tiles"
                            if kernel == "conv_k4s2_dx" else
                            "persistent" if plan.dw_persistent is not None else f"grid {plan.dw_grid}")
                    line = (f"{kernel} {label} [{walk}]: max_abs_err {err:.3e} (tol {tol:.3e}); against float64 "
                            f"(largest entry {top64:.3e}) kernel {err_k:.3e} plain {err_p:.3e} (tol {tol64:.3e}); "
                            f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms library {library_ms:.4f} ms bound "
                            f"{bound_ms:.4f} ms ({bound_by}); on the card alone kernel {alone:.4f} ms ({a1:.4f}, "
                            f"{a2:.4f}) library {library_alone:.4f} ms ({l1:.4f}, {l2:.4f}), with cudnn.benchmark "
                            f"{bench_alone:.4f} ms ({b1:.4f}, {b2:.4f}; its longest kernel {engine}); bound / "
                            f"kernel alone {100 * bound_ms / alone:.1f}%, kernel / library alone "
                            f"{alone / library_alone:.2f}, kernel / benchmarked library alone "
                            f"{alone / bench_alone:.2f} [{card}]")
                    print(line, flush=True)
                    if not (err <= tol and err_k <= tol64 and err_p <= tol64):
                        raise AssertionError(f"{line}: the kernel disagrees")
                    res[kernel][f"b{batch}_{n}"] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                                                    "bound_ms": bound_ms, "bound_by": bound_by, "device_ms": alone,
                                                    "library_device_ms": library_alone,
                                                    "library_benchmark_device_ms": bench_alone,
                                                    "library_benchmark_engine": engine, "max_abs_err": err}
            del x, w, g, exact, runs, x_pad, g_nc
    return res


def install_step_timer(trainer) -> tuple[list, list]:
    """Wrap ``trainer.step_fn`` to record each step's CUDA events and the host
    time it was entered; returns the two lists the wrapper fills."""
    events, entries = [], []
    inner = trainer.step_fn

    def timed_step(*a, **kw):
        entries.append(time.perf_counter())
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = inner(*a, **kw)
        end.record()
        events.append((start, end))
        return out

    trainer.step_fn = timed_step
    return events, entries


def check_trained(trainer, what: str) -> None:
    """Fail unless ``trainer`` ran to its ``total_steps`` with every logged
    metric finite and every step's gradients finite."""
    rows = trainer.history
    if trainer.state.step != trainer.cfg.total_steps or trainer.aborted_nan or not all(
            math.isfinite(v) for row in rows for v in row.values()):
        raise AssertionError(f"{what}: step {trainer.state.step}, aborted {trainer.aborted_nan}")
    if any(row["grads_finite"] != 1.0 for row in rows):
        raise AssertionError(f"{what}: a step's gradients were not finite")


def step_times(events: list, entries: list) -> tuple[np.ndarray, np.ndarray]:
    """Device ms a step and host wall ms between step starts, both after ``TRAIN_WARMUP`` steps."""
    step_ms = np.asarray([a.elapsed_time(b) for a, b in events[TRAIN_WARMUP:]])
    return step_ms, np.diff(np.asarray(entries[TRAIN_WARMUP:])) * 1e3


def timed_train(trainer, what: str) -> tuple[np.ndarray, np.ndarray, float, int]:
    """Run ``trainer`` to its ``total_steps``: device ms a step by CUDA events
    and host wall ms between step starts (both after ``TRAIN_WARMUP`` steps),
    the run's wall seconds and its peak memory. Fails on a non-finite metric
    or gradient."""
    events, entries = install_step_timer(trainer)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print("", flush=True)  # end the logger's carriage-return line
    check_trained(trainer, what)
    return (*step_times(events, entries), wall, torch.cuda.max_memory_allocated())


def phase_variants(device: torch.device, card: str) -> dict:
    """The other 13 ``REGISTRY`` names at full width, from seeded weights:
    each distinct model's f32 encode + decode on the card against the CPU;
    six names trained through ``cli/train.py``'s trainer (bf16, B=32); a
    train step of ``modelnet_nolbo`` in three layouts no name uses; serving
    without class priors (a VAE with the zero fill over HTTP; an AE's
    ``cli.evaluate --latents-out`` -> ``cli.export --prior-means`` -> ``cli.serve
    --artifact``) and ``anytime_eval`` with those anchors. Returns the
    phase's launch counts."""
    from anytime3d_tpu_torch.cli import evaluate as cli_evaluate
    from anytime3d_tpu_torch.cli import export as cli_export
    from anytime3d_tpu_torch.serving.export import load_infer
    from anytime3d_tpu_torch.train.step import make_train_step

    t_phase = time.perf_counter()
    var_counts = dict.fromkeys(read_counts(), 0)

    def add(counts: dict) -> None:
        for k, v in counts.items():
            var_counts[k] += v

    # 1. each distinct model, f32, card against CPU: one encode (posterior mean) + decode of 2 items
    n = VARIANT_SLICE_BATCH
    for name, launches in VARIANT_MODELS.items():
        cfg = REGISTRY[name]()
        t0 = time.perf_counter()
        model_cpu = MultiModalVAE(cfg, generator=torch.Generator().manual_seed(SEED)).eval()
        model_gpu = copy.deepcopy(model_cpu).to(device)
        if cfg.encoder == "image":
            labels = dataclasses.replace(cfg, category_dim=cfg.category_dim or 40, inst_dim=cfg.inst_dim or 10)
            x = torch.from_numpy(image_batch(labels, n, IMAGE_SIZE, IMAGE_SIZE, SEED + 14)["input"])
        else:
            x = torch.from_numpy(synthetic_grids(n, cfg.decoder.output_shape[0], SEED + 14))
        outs = {}
        for label, model, dev in (("cpu", model_cpu, torch.device("cpu")), ("card", model_gpu, device)):
            if dev.type == "cuda":
                torch.cuda.synchronize()
                reset_counts()
            with torch.inference_mode():
                enc = model.encode(x.to(dev))
                out = {"z_mean": enc.mean, "pred": model.decode(enc.mean)}
                if enc.log_var is not None:
                    out["z_log_var"] = enc.log_var
            outs[label] = {k: v.float().cpu() for k, v in out.items()}
            if dev.type == "cuda":
                add(expect_counts(f"variant {name}, f32", launches, 0, 0, tensor_cores=False))
        line = compare_outputs(f"variant {name} card vs CPU", outs["card"], outs["cpu"], SLICE_TOL_F32)
        if tuple(outs["card"]["pred"].shape) != (n, *cfg.decoder.output_shape) or float(outs["card"]["pred"].std()) < 1e-3:
            raise AssertionError(f"variant {name}: pred {tuple(outs['card']['pred'].shape)}, constant or misshapen")
        print(f"variant {name} ({sum(p.numel() for p in model_cpu.parameters())} params, {cfg.encoder} encoder, "
              f"decoder {cfg.decoder.final_mode}{' blocked tail' if cfg.decoder.tail_blocked else ''}, "
              f"variational {cfg.variational}): f32 encode + decode of {n}, card vs CPU (tol {SLICE_TOL_F32}): {line}; "
              f"{launches} conv_k2 launches; built and run in {time.perf_counter() - t0:.1f} s", flush=True)
        del model_cpu, model_gpu

    # 2. training through cli/train.py's trainer: bf16, B=32, packed synthetic batches
    rows, cols = IMAGE_BENCH
    for name, (fwd, dx, dw) in VARIANT_TRAIN.items():
        t0 = time.perf_counter()
        args = cli_train.parse_args(["--config", name, "--data", "synthetic", "--packed", "--bf16", "--batch-size",
                                     str(TRAIN_BATCH), "--steps", str(VARIANT_TRAIN_STEPS), "--eval-every", "0"])
        trainer, _ = cli_train.build_trainer(args)
        cfg = trainer.model.config
        size = "64^3 packed"
        if cfg.encoder == "image":  # the image phase's shape: bench.py's 96x128 images, packed-blocked targets
            loader = SyntheticImageObjectLoader(num_samples=IMAGE_TRAIN_SAMPLES, dim=cfg.decoder.output_shape[0],
                                                num_classes=cfg.category_dim or 40, num_inst=cfg.inst_dim or 10)
            trainer.batch_fn = cli_train.build_batch_fn(loader, cfg, TRAIN_BATCH, packed=True, native=True,
                                                        image_size=(cols, rows))
            size = f"{rows}x{cols} images, 64^3 packed-blocked targets"
        built = time.perf_counter() - t0
        reset_counts()
        step_ms, host, wall, peak = timed_train(trainer, f"variant train {name}")
        add(expect_counts(f"variant train {name}", fwd * VARIANT_TRAIN_STEPS, dx * VARIANT_TRAIN_STEPS,
                          dw * VARIANT_TRAIN_STEPS, tensor_cores=True))
        hist = trainer.history
        print(f"variant train {name}: {VARIANT_TRAIN_STEPS} steps, B={TRAIN_BATCH} bf16, {size}: loss_total "
              f"{hist[0]['loss_total']:.1f} -> {hist[-1]['loss_total']:.1f}, last {dict(hist[-1])}; device time per "
              f"step (CUDA events, steps {TRAIN_WARMUP}..{VARIANT_TRAIN_STEPS - 1}) median {np.median(step_ms):.2f} ms "
              f"(min {step_ms.min():.2f}, max {step_ms.max():.2f}); host wall per step, start to start, median "
              f"{np.median(host):.2f} ms; whole run {wall:.2f} s (built in {built:.1f} s); peak memory allocated "
              f"{peak / 2**30:.2f} GiB; conv_k2 launches {fwd} / {dx} / {dw} a step, on wgmma [{card}]", flush=True)
        del trainer
        torch.cuda.empty_cache()

    # 3. modelnet_nolbo in layouts that no REGISTRY name uses: a bf16 train step at B=32
    base, loss_cfg = configs.variant("modelnet_nolbo")
    classic = dataclasses.replace(
        base, encoder3d=dataclasses.replace(base.encoder3d, stem_space_to_depth=1, head_blocked=False),
        decoder=dataclasses.replace(base.decoder, final_mode="transpose", tail_blocked=False))
    layouts = {"classic": classic,
               "blocked_dynfix": dataclasses.replace(base, decoder=dataclasses.replace(
                   base.decoder, tail_init_match_transpose=True, tail_phase_norm=True)),
               "classic_s2d2": dataclasses.replace(classic, encoder3d=dataclasses.replace(
                   classic.encoder3d, stem_space_to_depth=2))}
    for label, cfg in layouts.items():
        (fwd, dx, dw), tensor_cores, narrow, wide_fwd = VARIANT_LAYOUTS[label]
        model = MultiModalVAE(cfg, generator=torch.Generator().manual_seed(SEED), dtype=torch.bfloat16).to(device)
        state = create_train_state(model)
        step = make_train_step(model, loss_cfg)
        loader = SyntheticVoxelLoader(num_samples=TRAIN_BATCH, dim=cfg.decoder.output_shape[0],
                                      num_classes=cfg.category_dim)
        batch = to_device(cli_train.build_batch_fn(loader, cfg, TRAIN_BATCH, packed=True, native=True)(0), device)
        gen = torch.Generator(device=device).manual_seed(SEED)
        step(state, batch, gen)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        n_steps = VARIANT_LAYOUT_STEPS
        ms = cuda_ms(lambda: step(state, batch, gen), iters=n_steps, warmup=0)
        metrics = {k: float(v) for k, v in step(state, batch, gen)[1].items()}
        add(expect_counts(f"layout {label}", fwd * (n_steps + 1), dx * (n_steps + 1), dw * (n_steps + 1),
                          tensor_cores, narrow=tuple(n * (n_steps + 1) for n in narrow),
                          wide=narrow[2] * (n_steps + 1), wide_forward=wide_fwd * (n_steps + 1)))
        if not (all(math.isfinite(v) for v in metrics.values()) and metrics["grads_finite"] == 1.0):
            raise AssertionError(f"layout {label}: {metrics}")
        print(f"layout {label} of modelnet_nolbo (encoder head_blocked {cfg.encoder3d.head_blocked}, stem "
              f"s2d({cfg.encoder3d.stem_space_to_depth}); decoder {cfg.decoder.final_mode}, tail_blocked "
              f"{cfg.decoder.tail_blocked}, tail_phase_norm {cfg.decoder.tail_phase_norm}, tail_init_match_transpose "
              f"{cfg.decoder.tail_init_match_transpose}): bf16 train step B={TRAIN_BATCH}, device time (CUDA events, "
              f"mean of {n_steps} after 1) {ms:.2f} ms; peak memory allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; conv_k2 {fwd} / {dx} / {dw} a step "
              f"({'wgmma' if tensor_cores else 'FFMA' if fwd else 'none'}; narrow {narrow[0]} / {narrow[1]} / "
              f"{narrow[2]}; wide forward {wide_fwd}); metrics {metrics} [{card}]", flush=True)
        del model, state, step, batch
        torch.cuda.empty_cache()

    # 4a. an HTTP server for modelnet_vae (no class prior): the zero fill, replies without a category
    cfg = REGISTRY["modelnet_vae"]()
    item = cfg.decoder.output_shape
    item_bytes = math.prod(item) // 8
    model = MultiModalVAE(cfg, generator=torch.Generator().manual_seed(SEED)).to(device)
    grids, masks = serve_requests(N_REQUESTS // 4, item[0], cfg.z_dim, SEED + 15)
    server = InferenceServer(make_packed_infer(model, item), (item_bytes,), cfg.z_dim, batch_size=BATCH,
                             device=device)
    try:
        reset_counts()
        port = server.serve(0, background=True)
        latencies, replies, wall, health = http_load(port, grids, masks)
    finally:
        server.close()
    check_replies("variant serve modelnet_vae", replies, cfg, item_bytes, classes=0)
    batches = int(health["batches_run"])
    add(expect_counts(f"variant serve modelnet_vae, {batches} f32 batches", 4 * batches, 0, 0, tensor_cores=False))
    lat = np.sort(latencies) * 1e3
    empty = [r for r, m in zip(replies, masks) if not m.any()]
    if not all(not any(r["z_mean"]) for r in empty):
        raise AssertionError("variant serve modelnet_vae: an empty mask's latent is not filled with zeros")
    print(f"variant serve modelnet_vae (no class prior, zero fill): {len(masks)} requests from {N_CLIENTS} threads, "
          f"batch {BATCH}, {batches} batches, no category in any reply, {len(empty)} empty masks read back as zeros; "
          f"p50 {np.percentile(lat, 50):.2f} ms p99 {np.percentile(lat, 99):.2f} ms, {len(masks) / wall:.1f} shapes/s "
          f"[{card}]", flush=True)
    del model, server

    # 4b. modelnet_ae: cli.evaluate --latents-out -> cli.export --prior-means -> cli.serve --artifact
    tmp = tempfile.mkdtemp(prefix="chip_smoke_variants_")
    try:
        cfg = REGISTRY["modelnet_ae"]()
        vec_path, art_path = os.path.join(tmp, "v.npy"), os.path.join(tmp, "ae.pt2")
        t0 = time.perf_counter()
        reset_counts()
        vecs = cli_evaluate.main(["--config", "modelnet_ae", "--latents-out", vec_path, "--batches", "2",
                                  "--batch-size", str(TRAIN_BATCH)])
        torch.cuda.synchronize()
        add(expect_counts("variant cli.evaluate --latents-out", 2 * 2, 0, 0, tensor_cores=False))
        seen = int((np.abs(vecs).sum(-1) > 0).sum())
        if vecs.shape != (40, cfg.z_dim) or not np.isfinite(vecs).all() or seen < 2:
            raise AssertionError(f"variant latents: {vecs.shape}, {seen} classes seen")
        latents_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cli_export.main(["--config", "modelnet_ae", "--prior-means", vec_path, "--batch-size", str(BATCH),
                         "--out", art_path])
        export_s = time.perf_counter() - t0
        with open(art_path, "rb") as fh:
            fn = load_infer(fh.read())
        model = MultiModalVAE(cfg, generator=torch.Generator().manual_seed(0)).to(device)  # the CLIs' seed
        eager = make_infer_fn(model, prior_means=vecs)
        x8 = torch.from_numpy(synthetic_grids(BATCH, item[0], SEED + 16)).to(device)
        mask8 = torch.from_numpy(latent_masks(BATCH, cfg.z_dim, SEED + 16)).to(device)
        fn(x8, mask8)
        torch.cuda.synchronize()
        reset_counts()
        got = fn(x8, mask8)
        torch.cuda.synchronize()
        add(expect_counts("variant AE artifact, f32", 4, 0, 0, tensor_cores=False))
        line = compare_outputs("variant AE artifact vs eager", got, eager(x8, mask8), EXPORT_TOL_F32)
        if got["z_log_var"].abs().max() != 0:
            raise AssertionError("variant AE artifact: z_log_var is not zero")
        (proc, port, started), = serving_subprocesses([["--artifact", art_path]], device)
        replies = []
        try:
            for i in range(VARIANT_ARTIFACT_REQUESTS):
                conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
                body = json.dumps({"input": x8[i % BATCH].cpu().numpy().tolist(), "mask": mask8[i % BATCH].tolist()})
                conn.request("POST", "/infer", body, {"Content-Type": "application/json"})
                resp = conn.getresponse()
                replies.append((resp.status, json.loads(resp.read())))
                conn.close()
        finally:
            proc.terminate()
            try:
                rc = proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                rc = f"killed after 60 s ({proc.wait()})"
        cats = [r.get("category") for _, r in replies]
        want = [int(got["category"][i % BATCH]) for i in range(VARIANT_ARTIFACT_REQUESTS)]
        if any(status != 200 for status, _ in replies) or cats != want or rc != 0:
            raise AssertionError(f"variant serve --artifact: statuses {[s for s, _ in replies]}, categories {cats} "
                                 f"(in-process program {want}), exit {rc}")
        print(f"variant modelnet_ae: cli.evaluate --latents-out {vecs.shape} ({seen} classes seen) in {latents_s:.1f} "
              f"s; cli.export --prior-means {export_s:.1f} s; the artifact against the eager program with the same "
              f"anchors: {line}; cli.serve --artifact (subprocess, ready {started:.1f} s): {len(replies)} float "
              f"requests, categories {cats}, equal to the in-process program's [{card}]", flush=True)

        # 4c. anytime_eval at B=32 with those anchors, bf16, masked and clean
        model16 = MultiModalVAE(cfg, generator=torch.Generator().manual_seed(0), dtype=torch.bfloat16).to(device)
        loader = SyntheticVoxelLoader(num_samples=TRAIN_BATCH, dim=item[0], num_classes=40, seed=1)
        a_batch = to_device(cli_train.build_batch_fn(loader, cfg, TRAIN_BATCH, packed=True, native=True,
                                                     category=True)(0), device)
        anchors = torch.from_numpy(vecs).to(device)
        gen = torch.Generator(device=device).manual_seed(SEED)
        torch.cuda.synchronize()
        reset_counts()
        masked = anytime_eval(model16, a_batch, gen, missing_prob=0.5, prior_means=anchors)
        clean = anytime_eval(model16, a_batch, gen, prior_means=anchors)
        torch.cuda.synchronize()
        add(expect_counts("variant anytime, one masked and one clean batch", 6 + 4, 0, 0, tensor_cores=True))
        if not all(math.isfinite(float(v)) for v in {**masked, **clean}.values()) or "acc_category" not in masked:
            raise AssertionError(f"variant anytime: {masked}, {clean}")
        ms_masked = cuda_ms(lambda: anytime_eval(model16, a_batch, gen, missing_prob=0.5, prior_means=anchors),
                            iters=10)
        ms_clean = cuda_ms(lambda: anytime_eval(model16, a_batch, gen, prior_means=anchors), iters=10)
        print(f"variant anytime, modelnet_ae with its cli.evaluate anchors, B={TRAIN_BATCH} bf16 packed-blocked: "
              f"device time per batch (CUDA events, 10 calls) at missing 0.5 {ms_masked:.3f} ms, at 0.0 "
              f"{ms_clean:.3f} ms; masked {({k: round(float(v), 4) for k, v in masked.items()})} [{card}]", flush=True)
        del model, model16, fn, a_batch
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"variants phase: {time.perf_counter() - t_phase:.1f} s wall", flush=True)
    return var_counts


def view_masks(n_views: int, n: int, dim: int, seed: int) -> torch.Tensor:
    """(n_views, n, dim, dim, dim, 1) float32 visibility on the CPU: view t of
    object i sees the voxels on one side of a plane a quarter of the grid
    behind its center, across a random direction."""
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(n_views * n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    coords = torch.from_numpy((np.indices((dim,) * 3).reshape(3, -1).T + 0.5 - dim / 2).astype(np.float32))
    seen = (torch.from_numpy(dirs.astype(np.float32)) @ coords.T) > -0.25 * dim
    return seen.float().reshape(n_views, n, dim, dim, dim, 1)


def stream_calls(rec, views: torch.Tensor, masks: torch.Tensor, vis: torch.Tensor) -> tuple[dict, dict]:
    """The reconstructor's streaming calls over ``views`` (T, B, ...): encode
    each view of the B objects, fuse the T latents with their ``masks``,
    classify, correct, decode the corrected belief and fuse each view's
    decode into the occupancy belief under its visibility ``vis``. Returns
    (the outputs on the CPU, each call's CUDA-event ms: the card's time for a
    model on the card)."""
    events = {}

    def timed(name: str, fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        events[name] = (start, end)
        return out

    def fuse_views():
        occ = rec.new_shape_belief(pred.shape)
        for t in range(views.shape[0]):
            occ = rec.observe_decoded(occ, means[t], vis[t])
        return occ.probs

    means, lvs = timed("encode_observation",
                       lambda: [torch.stack(b) for b in zip(*(rec.encode_observation(v) for v in views))])
    belief = timed("observe_stream", lambda: rec.observe_stream(rec.new_object(means.shape[1:2]), means, lvs, masks))
    labels = timed("classify", lambda: rec.classify(belief))
    corrected = timed("correct", lambda: rec.correct(belief))
    pred = timed("decode", lambda: rec.decode(corrected))
    probs = timed("observe_decoded", fuse_views)
    torch.cuda.synchronize()
    out = {"info": belief.info, "precision": belief.precision, "category": labels, "corrected_info": corrected.info,
           "corrected_precision": corrected.precision, "pred": pred, "fused_probs": probs}
    return {k: v.cpu() for k, v in out.items()}, {k: a.elapsed_time(b) for k, (a, b) in events.items()}


def phase_pretrain_stream(device: torch.device, card: str) -> dict:
    """Classifier pretraining through ``cli/pretrain.py``'s ``main`` at full
    width (darknet19, 224x224, B=64, bf16) and its f32 forward on the card
    against the CPU; its backbone grafted into a fresh ``pascal_nolbo`` and
    trained a few bf16 steps; the structural instance shapes at 64^3 built
    (native) and trained on with ``modelnet_nolbo``; the streaming
    ``AnytimeReconstructor`` on full-width ``modelnet_nolbo`` (32 objects x 8
    masked views, f32), timed by call and held to the CPU. Returns the
    phase's launch counts."""
    from anytime3d_tpu_torch.anytime import AnytimeReconstructor
    from anytime3d_tpu_torch.cli import pretrain as cli_pretrain
    from anytime3d_tpu_torch.data import voxelize
    from anytime3d_tpu_torch.models.classifier import Classifier
    from anytime3d_tpu_torch.train.checkpoint import CHECKPOINT_FILE, graft_submodule
    from anytime3d_tpu_torch.train.classifier_step import make_classifier_train_step
    from anytime3d_tpu_torch.train.step import make_train_step
    from anytime3d_tpu_torch.train.trainer import Trainer, TrainerConfig

    t_phase = time.perf_counter()
    phase_counts = dict.fromkeys(read_counts(), 0)

    def add(counts: dict) -> None:
        for k, v in counts.items():
            phase_counts[k] += v

    tmp = tempfile.mkdtemp(prefix="chip_smoke_pretrain_")
    try:
        # 1. pretraining: cli.pretrain.main, its trainer's steps timed
        ckpt = os.path.join(tmp, "ckpt")
        argv = ["--data", "synthetic", "--backbone", "darknet19", "--batch-size", str(PRETRAIN_BATCH),
                "--image-size", str(PRETRAIN_SIZE), "--bf16", "--steps", str(PRETRAIN_STEPS), "--eval-every",
                str(PRETRAIN_STEPS), "--save-path", ckpt]
        timers = []
        build_trainer = cli_pretrain.build_trainer

        def build_timed(args):
            trainer, loader = build_trainer(args)
            timers.append(install_step_timer(trainer))
            return trainer, loader

        cli_pretrain.build_trainer = build_timed
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            trainer = cli_pretrain.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            cli_pretrain.build_trainer = build_trainer
        add(expect_counts("pretrain (2-D convolutions only)", 0, 0, 0, tensor_cores=False))
        peak = torch.cuda.max_memory_allocated()
        check_trained(trainer, "pretrain")
        step_ms, host = step_times(*timers[0])
        if not os.path.exists(os.path.join(ckpt, CHECKPOINT_FILE)) or len(trainer.eval_history) != 1:
            raise AssertionError(f"pretrain: no checkpoint under {ckpt} or {len(trainer.eval_history)} evals")
        hist = trainer.history
        loader = SyntheticImageObjectLoader(num_samples=PRETRAIN_LOADER_BATCHES * PRETRAIN_BATCH, dim=32,
                                            num_classes=10)
        batch_fn = cli_pretrain.build_batch_fn(loader, PRETRAIN_BATCH, PRETRAIN_SIZE)
        host_ms = []
        for i in range(2 * PRETRAIN_LOADER_BATCHES):
            t0 = time.perf_counter()
            batch = batch_fn(i)
            host_ms.append((time.perf_counter() - t0) * 1e3)
        cold, cached = host_ms[:PRETRAIN_LOADER_BATCHES], host_ms[PRETRAIN_LOADER_BATCHES:]
        # the step outside the loop: on the card alone, and the host's time to enqueue it
        step = make_classifier_train_step(trainer.model)
        batch = to_device(batch, device)
        alone_ms = device_ms(lambda: step(trainer.state, batch), iters=5, warmup=1)
        enqueue_ms = host_enqueue_ms(lambda: step(trainer.state, batch), iters=3)
        print(f"pretrain: cli.pretrain.main darknet19 classifier ({sum(p.numel() for p in trainer.model.parameters())}"
              f" params), B={PRETRAIN_BATCH} {PRETRAIN_SIZE}x{PRETRAIN_SIZE} bf16, {PRETRAIN_STEPS} steps and one "
              f"eval: loss_ce {hist[0]['loss_ce']:.4f} -> {hist[-1]['loss_ce']:.4f}, last top1 {hist[-1]['top1']:.3f}"
              f" top5 {hist[-1]['top5']:.3f}, eval {trainer.eval_history[-1]}; device time per step (CUDA events, "
              f"steps {TRAIN_WARMUP}..{PRETRAIN_STEPS - 1}) median {np.median(step_ms):.2f} ms (min "
              f"{step_ms.min():.2f}, max {step_ms.max():.2f}), {PRETRAIN_BATCH / np.median(step_ms) * 1e3:.0f} "
              f"images/s; host wall per step, start to start, median {np.median(host):.2f} ms "
              f"({PRETRAIN_BATCH / np.median(host) * 1e3:.0f} images/s); the step alone on the card (5 steps, "
              f"device_ms) {alone_ms:.2f} ms ({PRETRAIN_BATCH / alone_ms * 1e3:.0f} images/s), the host's time to "
              f"enqueue one {enqueue_ms:.2f} ms; whole main {wall:.2f} s; peak memory "
              f"allocated {peak / 2**30:.2f} GiB; the host's batch ({PRETRAIN_BATCH} renders at {PRETRAIN_SIZE}^2) cold median "
              f"{np.median(cold):.2f} ms, cached median {np.median(cached):.2f} ms; no conv_k2 launch [{card}]",
              flush=True)

        params = {k: v.detach().cpu() for k, v in trainer.model.state_dict().items()}
        clf_cpu = Classifier(trainer.model.config)
        clf_cpu.load_state_dict(params)
        clf_gpu = copy.deepcopy(clf_cpu).to(device)
        images = torch.from_numpy(cli_pretrain.build_batch_fn(SyntheticImageObjectLoader(
            num_samples=PRETRAIN_SLICE_BATCH, dim=32, num_classes=10, seed=1), PRETRAIN_SLICE_BATCH,
            PRETRAIN_SIZE)(0)["images"])
        with torch.inference_mode():
            got = {"logits": clf_gpu(images.to(device))}
            want = {"logits": clf_cpu(images)}
        line = compare_outputs("pretrain classifier f32 card vs CPU", got, want, SLICE_TOL_F32)
        print(f"pretrain classifier, the trained weights in f32, B={PRETRAIN_SLICE_BATCH} {PRETRAIN_SIZE}^2, card vs "
              f"CPU (tol {SLICE_TOL_F32}): {line} [{card}]", flush=True)
        del trainer, step, batch, clf_cpu, clf_gpu
        torch.cuda.empty_cache()

        # 2. the graft: the pretrained backbone into a fresh pascal_nolbo, then bf16 steps at B=32
        cfg = REGISTRY["pascal_nolbo"]()
        model = MultiModalVAE(cfg, generator=torch.Generator().manual_seed(SEED), dtype=torch.bfloat16).to(device)
        state = create_train_state(model)
        before = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        graft_submodule(state, ckpt, "backbone")
        donor = torch.load(os.path.join(ckpt, CHECKPOINT_FILE), map_location="cpu", weights_only=True)["params"]
        grafted = 0
        for k, v in model.state_dict().items():
            is_backbone = k.startswith("backbone.")
            if not torch.equal(v.cpu(), donor[k] if is_backbone else before[k]):
                raise AssertionError(f"graft: {k} is not the {'donor' if is_backbone else 'fresh model'}'s")
            grafted += is_backbone
        step = make_train_step(model, configs.loss_config("pascal_nolbo"))
        batch = to_device(image_step_batch(image_batch(cfg, TRAIN_BATCH, IMAGE_SIZE, IMAGE_SIZE, SEED + 30),
                                           TRAIN_BATCH), device)
        gen = torch.Generator(device=device).manual_seed(SEED)
        step(state, batch, gen)  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        ms = cuda_ms(lambda: step(state, batch, gen), iters=GRAFT_STEPS, warmup=0)
        metrics = {k: float(v) for k, v in step(state, batch, gen)[1].items()}
        n = GRAFT_STEPS + 1
        add(expect_counts("graft steps", 2 * n, 2 * n, 2 * n, tensor_cores=True))
        if not (all(math.isfinite(v) for v in metrics.values()) and metrics["grads_finite"] == 1.0):
            raise AssertionError(f"graft steps: {metrics}")
        print(f"graft: the pretrained backbone ({grafted} tensors) into a fresh pascal_nolbo, bit for bit, every "
              f"other tensor untouched; bf16 train step B={TRAIN_BATCH} {IMAGE_SIZE}x{IMAGE_SIZE} on it, device time "
              f"(CUDA events, mean of {GRAFT_STEPS} after 1) {ms:.2f} ms; conv_k2 2 / 2 / 2 a step on wgmma; "
              f"metrics {metrics} [{card}]", flush=True)
        del model, state, step, batch, donor
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 3. structural instance shapes at modelnet_nolbo's 64^3, native, and modelnet_nolbo trained on them
    cfg, loss_cfg = configs.variant("modelnet_nolbo")
    dim = cfg.decoder.output_shape[0]
    calls = (voxelize.voxelize.native_calls, voxelize.voxelize.numpy_calls)
    t0 = time.perf_counter()
    loader = SyntheticVoxelLoader(num_samples=STRUCT_SAMPLES, dim=dim, num_classes=cfg.category_dim, num_inst=10,
                                  structural_inst=True)
    build_s = time.perf_counter() - t0
    pairs = len(set(zip(loader._labels.tolist(), loader._insts.tolist())))
    native_calls = voxelize.voxelize.native_calls - calls[0]
    if voxelize.voxelize.numpy_calls != calls[1] or native_calls == 0:
        raise AssertionError(f"structural: {native_calls} native and {voxelize.voxelize.numpy_calls - calls[1]} "
                             "NumPy voxelizations")
    occupancy = loader._cache.reshape(STRUCT_SAMPLES, -1).mean(axis=1)
    if not (occupancy > 0.003).all():
        raise AssertionError(f"structural: a sample of occupancy {occupancy.min():.4f}")
    model = MultiModalVAE(cfg, generator=torch.Generator().manual_seed(SEED), dtype=torch.bfloat16).to(device)
    trainer = Trainer(model, create_train_state(model),
                      cli_train.build_batch_fn(loader, cfg, TRAIN_BATCH, packed=True, native=True),
                      loss_config=loss_cfg, config=TrainerConfig(total_steps=STRUCT_STEPS, eval_every=0))
    reset_counts()
    step_ms, host, wall, peak = timed_train(trainer, "structural train")
    add(expect_counts("structural train", 4 * STRUCT_STEPS, 3 * STRUCT_STEPS, 4 * STRUCT_STEPS, tensor_cores=True))
    hist = trainer.history
    print(f"structural: SyntheticVoxelLoader(structural_inst=True) of {STRUCT_SAMPLES} samples at {dim}^3, "
          f"{pairs} (class, instance) grids, {native_calls} native part voxelizations, none in NumPy: built in "
          f"{build_s:.2f} s, {build_s / pairs * 1e3:.1f} ms a grid (jitter and turn included); occupancy "
          f"{occupancy.min():.4f}..{occupancy.max():.4f}. modelnet_nolbo on them, {STRUCT_STEPS} steps B="
          f"{TRAIN_BATCH} bf16 packed-blocked: loss_total {hist[0]['loss_total']:.1f} -> {hist[-1]['loss_total']:.1f}"
          f"; device time per step (CUDA events, steps {TRAIN_WARMUP}..{STRUCT_STEPS - 1}) median "
          f"{np.median(step_ms):.2f} ms; host wall per step median {np.median(host):.2f} ms; whole run {wall:.2f} s;"
          f" peak memory allocated {peak / 2**30:.2f} GiB; conv_k2 4 / 3 / 4 a step on wgmma [{card}]", flush=True)
    del model, trainer, loader
    torch.cuda.empty_cache()

    # 4. the streaming reconstructor: full-width modelnet_nolbo, f32, card against CPU
    cfg = REGISTRY["modelnet_nolbo"]()
    dim = cfg.decoder.output_shape[0]
    model_cpu = MultiModalVAE(cfg, generator=torch.Generator().manual_seed(SEED))
    model_gpu = copy.deepcopy(model_cpu).to(device)
    grids = torch.from_numpy(synthetic_grids(STREAM_OBJECTS, dim, SEED + 31))
    vis = view_masks(STREAM_VIEWS, STREAM_OBJECTS, dim, SEED + 31)
    views = grids[None] * vis
    masks = torch.from_numpy((np.random.default_rng(SEED + 31).uniform(
        size=(STREAM_VIEWS, STREAM_OBJECTS, cfg.z_category_dim)) < 0.5).astype(np.float32))
    rec_gpu, rec_cpu = AnytimeReconstructor(model_gpu), AnytimeReconstructor(model_cpu)
    operands = [t.to(device) for t in (views, masks, vis)]
    torch.cuda.synchronize()
    reset_counts()
    got, _ = stream_calls(rec_gpu, *operands)
    torch.cuda.synchronize()
    add(expect_counts("streaming", 2 * STREAM_VIEWS + 2 + 2 * STREAM_VIEWS, 0, 0, tensor_cores=False))
    k = STREAM_CPU_OBJECTS
    want, _ = stream_calls(rec_cpu, views[:, :k], masks[:, :k], vis[:, :k])
    line = compare_outputs("streaming card vs CPU", {n: v[:k] for n, v in got.items()}, want, SLICE_TOL_F32)
    for name in ("pred", "fused_probs"):
        if float(got[name].std()) < 1e-3:
            raise AssertionError(f"streaming: {name} is constant")
    _, ms = stream_calls(rec_gpu, *operands)  # a second run, timed
    print(f"streaming: AnytimeReconstructor on modelnet_nolbo (prior-net anchors), f32, {STREAM_OBJECTS} objects x "
          f"{STREAM_VIEWS} masked views at {dim}^3 (latent masks keep 0.5, each view a plane's visibility); the first "
          f"{k} objects card vs CPU (tol {SLICE_TOL_F32}): {line}; labels {got['category'][:8].tolist()}...; device "
          f"time by call (CUDA events, the second run): " + ", ".join(f"{n} {v:.3f} ms" for n, v in ms.items())
          + f" (encode_observation: {STREAM_VIEWS} calls of {STREAM_OBJECTS}; observe_decoded: {STREAM_VIEWS} "
          f"decodes of {STREAM_OBJECTS} and their fusion); conv_k2 {2 * STREAM_VIEWS} + 2 + {2 * STREAM_VIEWS} "
          f"FFMA launches [{card}]", flush=True)
    del model_cpu, model_gpu, rec_gpu, rec_cpu, operands
    torch.cuda.empty_cache()
    print(f"pretrain and streaming phase: {time.perf_counter() - t_phase:.1f} s wall", flush=True)
    return phase_counts


# phase 16: the real-image data path (decode -> augment -> loaders -> CLIs) on the repo's fixtures
PASCAL_FIXTURES = os.path.join(REPO, "tests", "fixtures", "pascal3d")  # 3 train and 1 val objects, 2 classes
KITTI_FIXTURES = os.path.join(REPO, "tests", "fixtures", "kitti")  # 2 frames, 3 cars tall enough
REAL_STEPS = 20  # pascal_nolbo on the Pascal3D crops
REAL_KITTI_STEPS = 10
REAL_DET_STEPS = 10
REAL_PRETRAIN_STEPS = 10
REAL_LOADER_BATCHES = 4  # timed after a fresh loader's first batch
REAL_AUG_CALLS = 20  # seeds a timing of the warp runs over
VOC_FRAME, KITTI_FRAME = (375, 500), (375, 1242)  # (rows, cols) of a Pascal VOC and a KITTI frame
KMEANS_POINTS, KMEANS_K, KMEANS_ITERS = 8192, 30, 1000
KMEANS_TOL = 1e-4  # centres, card against CPU: float32 distances and float64 sums in another order
AUG_TWIN_TOL = 1e-2  # the NumPy twin samples in float64 coordinates, the engine in float32 (0..255 scale)


# sha256 of what the photometric jitter's cv2 calls give on the CPU the tests run on, and that cv2's version
CV2_DIGESTS = {
    "version": "5.0.0",
    "rgb2hsv": "a5b38b214f65aed9d382cc07bf40311aff2e3e324c98da86df77bef285f224eb",
    "hsv2rgb": "480b1c6168e0d875c27b92831a2184de8f40ebdeafdceac450afe4785b054334",
    "hsv2rgb_short_rows": "12230679e143445f6d87a789f13afa150837aec44b091e9deb9e25d2199e7fcb",
    "blur3": "2e6ff52fb4475dbb0b538269995158b3b7cdf45841b19342897a9852fa3c063e",
    "blur5": "3e2f986bcbd7493ce41b526346d973123c1df107d6a93ac2506323138fe0110b",
}


def cv2_digests() -> dict:
    """sha256 of ``cv2``'s outputs for the photometric jitter's calls: RGB2HSV
    of every 8-bit colour, HSV2RGB of every byte triple (as 4096 rows of
    4096, and as rows of 1..70 pixels), ``GaussianBlur`` k = 3 and 5 of a
    seeded float32 image."""
    import hashlib

    import cv2

    v = np.arange(1 << 24, dtype=np.uint32)
    every = np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255], -1).astype(np.uint8).reshape(4096, 4096, 3)
    rows = b"".join(cv2.cvtColor(every.reshape(-1, 3)[w * 7919:w * 7919 + 5 * w].reshape(5, w, 3),
                                 cv2.COLOR_HSV2RGB).tobytes() for w in range(1, 71))
    img = np.random.default_rng(SEED).uniform(-40, 300, (375, 500, 3)).astype(np.float32)
    out = {"rgb2hsv": cv2.cvtColor(every, cv2.COLOR_RGB2HSV).tobytes(),
           "hsv2rgb": cv2.cvtColor(every, cv2.COLOR_HSV2RGB).tobytes(), "hsv2rgb_short_rows": rows}
    out.update({f"blur{k}": cv2.GaussianBlur(img, (k, k), 0).tobytes() for k in (3, 5)})
    return {k: hashlib.sha256(b).hexdigest() for k, b in out.items()}


def photo_frame(rows: int, cols: int, seed: int) -> np.ndarray:
    """A seeded uint8 RGB frame with smooth regions and edges, as a photo has them."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:rows, 0:cols].astype(np.float32)
    img = np.stack([np.sin(xx / (17 + 9 * c)) * 90 + np.cos(yy / (23 + 5 * c)) * 60 + 128 for c in range(3)], -1)
    img += rng.normal(0, 6, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def mean_ms(fn, n: int) -> float:
    """Mean host milliseconds of ``fn(i)`` for i in range(n)."""
    t0 = time.perf_counter()
    for i in range(n):
        fn(i)
    return (time.perf_counter() - t0) / n * 1e3


def loader_batch_ms(loader, batch_fn) -> tuple[float, float]:
    """A fresh ``loader``'s first batch through ``batch_fn`` (cold: the
    pool's threads start) and the mean of the next ``REAL_LOADER_BATCHES``,
    host milliseconds; the loader closed after."""
    try:
        t0 = time.perf_counter()
        batch_fn(0)
        cold = (time.perf_counter() - t0) * 1e3
        return cold, mean_ms(lambda i: batch_fn(i + 1), REAL_LOADER_BATCHES)
    finally:
        loader.close()


def step_alone(trainer, step, loader_batch) -> tuple[float, float]:
    """The train ``step`` on one host batch outside the loop: on the card
    alone (``device_ms``, 5 steps) and the host's time to enqueue one."""
    batch = trainer.to_device(loader_batch)
    gen = torch.Generator(device=batch[next(iter(batch))].device).manual_seed(SEED)
    alone = device_ms(lambda: step(trainer.state, batch, gen), iters=5, warmup=1)
    return alone, host_enqueue_ms(lambda: step(trainer.state, batch, gen), iters=3)


def real_train_line(what: str, trainer, step_ms: np.ndarray, host: np.ndarray, wall: float, peak: int,
                    batch: int, loader_ms: tuple, alone: tuple, card: str) -> str:
    """A real-data loop's numbers, and which side bounds it: the host where
    its wall a step exceeds the step alone on the card by a fifth."""
    hist = trainer.history
    key = "loss_total" if "loss_total" in hist[0] else "loss_ce"
    wall_ms = float(np.median(host))
    bound = (f"the host (the loader's batch {loader_ms[1]:.2f} ms on the prefetch thread, the step's enqueue "
             f"{alone[1]:.2f} ms)" if wall_ms > 1.2 * alone[0] else "the card")
    return (f"{what}: {key} {hist[0][key]:.2f} -> {hist[-1][key]:.2f}; the step alone on the card {alone[0]:.2f} ms "
            f"({batch / alone[0] * 1e3:.0f} images/s), the host's enqueue of one {alone[1]:.2f} ms; in the loop, by "
            f"CUDA events (steps {TRAIN_WARMUP}..{len(hist) - 1}; they read the host's gaps too) median "
            f"{np.median(step_ms):.2f} ms, host wall per step, start to start, median {wall_ms:.2f} ms "
            f"({batch / wall_ms * 1e3:.0f} images/s); the loader's batch cold {loader_ms[0]:.2f} ms, warm "
            f"{loader_ms[1]:.2f} ms (mean of {REAL_LOADER_BATCHES}); bound by {bound}; whole run {wall:.2f} s; peak "
            f"memory allocated {peak / 2**30:.2f} GiB [{card}]")


# phase 17: the mapping geometry and data parallelism
# draw_scene of viz_scene(), as tests/test_torch_viz.py pins it
VIZ_SHA256 = "c4f6fe7f9f06879d32eccebc10687b798a8c9782f807bbbff2be0c3d64c4ea11"
BA_POSES, BA_LANDMARKS, BA_STEPS = 32, 8192, 10
PG_NODES, PG_EDGES, PG_STEPS = 64, 192, 10
FEATURE_KEYPOINTS = 256
FEATURE_SHIFT = (3, 5)  # (rows, cols) of the shifted copy
TWOVIEW_POINTS = 512
TWOVIEW_TOL = (1e-2, 1e-3)  # R and t against the truth (1e-4 of noise, the f32 eigh of A^T A), and card against CPU
MESH_STEPS = 12  # --mesh and plain, each; every logged metric compared bit for bit
GEOM_TOL = 1e-4  # f32 card against CPU, relative to the largest entry: the mapping tests' f32 tolerance
DETECTOR_SCENE = {}  # phase 12's f32 scene pass on the card, drawn in phase 17


def viz_scene() -> tuple:
    """A fixed frame (120 x 160, values in [0, 1]) and a scene of 4 slots in
    ``scene_reconstruction``'s keys: a lifted detection, a kept one that did
    not lift, a dropped one and a lifted one half off the frame."""
    rng = np.random.default_rng(SEED + 170)
    image = rng.uniform(size=(120, 160, 3)).astype(np.float32)
    bbox2d = np.array([[0.1, 0.1, 0.45, 0.5, 0.9], [0.5, 0.2, 0.9, 0.7, 0.8], [0.2, 0.6, 0.4, 0.9, 0.7],
                       [0.8, 0.7, 1.2, 1.1, 0.6]], np.float32)
    corners = np.stack([np.array([[20, 18], [22, 40], [48, 16], [50, 42], [28, 24], [30, 50], [60, 22], [62, 48]]) + 3 * k
                        for k in range(4)]).astype(np.float32)
    corners[3] += 120  # the last box mostly off the frame
    scene = {"bbox2d": bbox2d, "bbox3d_corners_px": corners, "valid": np.array([True, False, False, True]),
             "valid_det": np.array([True, True, False, True])}
    return image, scene


def phase_real_data(device: torch.device, card: str) -> dict:
    """The real-image data path on the card's host and the card: the
    fixture images read as the CPU tests read them, the native warp against its NumPy
    twin and timed, ``pascal_nolbo`` and ``kitti_inst_only`` trained on the
    fixtures' crops through ``cli/train.py`` (one f32 step of
    ``pascal_nolbo`` card against CPU), the detector on the Pascal3D frames
    through ``cli/train_detector.py``, darknet19 pretraining on an
    ImageNet-layout tree through ``cli/pretrain.py``, and ``kmeans_sincos``
    card against CPU. Returns the phase's launch counts."""
    import hashlib
    import importlib

    import cv2

    from anytime3d_tpu_torch.cli import pretrain as cli_pretrain
    from anytime3d_tpu_torch.cli import train_detector as cli_det
    from anytime3d_tpu_torch.data import augment
    from anytime3d_tpu_torch.data.imread import imread_color
    from anytime3d_tpu_torch.data.kitti import KittiSingleObjectLoader
    from anytime3d_tpu_torch.data.pascal3d import ObjRecord, Pascal3DSingleObjectLoader, orientation_anchors
    from anytime3d_tpu_torch.evaluation.detection import evaluate_detector
    from anytime3d_tpu_torch.ops.kmeans import kmeans_sincos
    from anytime3d_tpu_torch.train.step import compute_losses

    t_phase = time.perf_counter()
    phase_counts = dict.fromkeys(read_counts(), 0)

    def add(counts: dict) -> None:
        for k, v in counts.items():
            phase_counts[k] += v

    # (a) read every fixture PNG on the card's host, against the digests of the CPU tests; this cv2's jitter bits
    host_libs = {}
    for name in ("cv2", "PIL"):
        try:
            host_libs[name] = getattr(importlib.import_module(name), "__version__", "imports")
        except ImportError as e:
            host_libs[name] = f"absent ({e})"
    host_libs["g++"] = shutil.which("g++") or "absent"
    decode_ms = {}
    for rel, digest in sorted(FIXTURE_PNG_SHA256.items()):
        img = imread_color(os.path.join(REPO, rel))
        if img is None or hashlib.sha256(img.tobytes()).hexdigest() != digest:
            raise AssertionError(f"decode: {rel} is not the image cv2.imread gives on the CPU")
        decode_ms[os.path.basename(rel)] = mean_ms(lambda _: imread_color(os.path.join(REPO, rel)), 5)
    frames = {name: photo_frame(*shape, SEED + 40 + i) for i, (name, shape) in
              enumerate((("voc", VOC_FRAME), ("kitti", KITTI_FRAME)))}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_frames_") as tmp:
        for name, rgb in frames.items():
            path = os.path.join(tmp, f"{name}.png")
            cv2.imwrite(path, rgb)
            if not np.array_equal(imread_color(path), rgb):
                raise AssertionError(f"decode: the {name} frame does not round-trip")
            decode_ms[f"{name} frame {rgb.shape[0]}x{rgb.shape[1]}"] = mean_ms(lambda _: imread_color(path), 5)
    same = {k: v == CV2_DIGESTS.get(k) for k, v in cv2_digests().items()}
    print(f"real data (a) decode: {len(FIXTURE_PNG_SHA256)} fixture PNGs equal to the CPU tests' digests on this host; "
          f"imports here: cv2 {host_libs['cv2']}, PIL {host_libs['PIL']}, g++ {host_libs['g++']}; host ms a read by "
          "cv2.imread: " + ", ".join(f"{k} {v:.2f}" for k, v in decode_ms.items())
          + f"; the jitter's cv2 calls give the bits of cv2 {CV2_DIGESTS['version']} on the CPU tests' machine: {same}"
          + f" [{card}]", flush=True)

    # (b) the native warp on this host against its NumPy twin, then timed with and without the photometric jitter
    if not augment.augment_native_available():
        raise AssertionError("augment: the native engine does not build on the card's host")
    for name, rgb in frames.items():
        img = rgb.astype(np.float32)
        for seed in range(3):
            rng = np.random.default_rng(SEED + seed)
            args = (416, 416, float(rng.uniform(0.8, 1.2)), float(rng.uniform(-0.2, 0.2)), float(rng.uniform(-0.2, 0.2)))
            native, p_native = augment._augment_one_native(augment.native_augment(), img, *args, flip=seed == 1)
            twin, p_twin = augment._augment_one_numpy(img, *args, flip=seed == 1)
            err = float(np.abs(native - twin).max())
            if not (err <= AUG_TWIN_TOL and np.allclose(p_native, p_twin, rtol=1e-6, atol=1e-7)):
                raise AssertionError(f"augment {name} seed {seed}: native against the NumPy twin {err:.3e}")
    crop = frames["voc"][100:260, 120:330]
    aug_ms = {}
    calls = augment.image_random_augmentation.native_calls, augment.image_random_augmentation.numpy_calls
    for label, src, size in (("crop 160x210 -> 64x64", crop, (64, 64)), ("VOC frame -> 416x416", frames["voc"],
                                                                        (416, 416))):
        for noise in (False, True):
            aug_ms[f"{label}{' + photometric' if noise else ''}"] = mean_ms(
                lambda i: augment.image_random_augmentation(np.random.default_rng(i), src, size, add_noise=noise,
                                                            pad_to_aspect=size != (64, 64)), REAL_AUG_CALLS)
    if augment.image_random_augmentation.numpy_calls != calls[1]:
        raise AssertionError("augment: a warp took the NumPy twin on the card's host")
    print(f"real data (b) augment: the native engine against its NumPy twin on a {VOC_FRAME} and a {KITTI_FRAME} frame"
          f" to 416x416, 3 draws each, within {AUG_TWIN_TOL}; host ms a call (mean of {REAL_AUG_CALLS} seeds): "
          + ", ".join(f"{k} {v:.2f}" for k, v in aug_ms.items()) + f" [{card}]", flush=True)

    # (c) pascal_nolbo on the Pascal3D crops through cli/train.py: the 2-class resize, one f32 step card vs CPU,
    # then REAL_STEPS bf16 steps at B=32 on 64x64 crops with packed-blocked targets
    argv = ["--config", "pascal_nolbo", "--data", PASCAL_FIXTURES, "--bf16", "--batch-size", str(TRAIN_BATCH),
            "--image-size", str(IMAGE_SIZE), "--steps", str(REAL_STEPS), "--eval-every", "0"]
    trainer, loader = cli_train.build_trainer(cli_train.parse_args(argv))
    cfg = trainer.model.config
    if cfg.category_dim != 2 or loader.class_num != 2:
        raise AssertionError(f"pascal: category_dim {cfg.category_dim}, the fixture's classes {loader.class_num}")
    loss_cfg = configs.loss_config("pascal_nolbo")
    no_drop = dataclasses.replace(cfg, prior_category=dataclasses.replace(cfg.prior_category, dropout_rate=0.0),
                                  prior_inst=dataclasses.replace(cfg.prior_inst, dropout_rate=0.0))
    model_cpu = MultiModalVAE(no_drop, generator=torch.Generator().manual_seed(SEED))
    model_gpu = copy.deepcopy(model_cpu).to(device)
    val = Pascal3DSingleObjectLoader(PASCAL_FIXTURES, "val", workers=2)
    n = IMAGE_SLICE_BATCH
    batch = {k: torch.from_numpy(v) for k, v in cli_train.build_batch_fn(
        val, cfg, n, packed=True, native=True, image_size=(IMAGE_SIZE, IMAGE_SIZE))(0).items()}
    val.close()
    draws = image_draws(n, cfg.z_category_dim, cfg.z_inst_dim, loss_cfg.mix_element_prob, SEED + 41)
    draws = {k: draws[k] for k in ("eps_cat", "eps_inst", "eps_prior_cat", "eps_prior_inst", "coin", "take_prior")}
    results = {}
    for name, model, dev in (("card", model_gpu, device), ("cpu", model_cpu, torch.device("cpu"))):
        if dev.type == "cuda":
            reset_counts()
        total, metrics = compute_losses(model, loss_cfg, {k: v.to(dev) for k, v in batch.items()},
                                        draws={k: v.to(dev) for k, v in draws.items()})
        names, params = zip(*model.named_parameters())
        grads = dict(zip(names, torch.autograd.grad(total, params)))
        results[name] = ({k: float(v) for k, v in metrics.items()}, {k: g.cpu() for k, g in grads.items()})
        if dev.type == "cuda":
            add(expect_counts("real pascal f32 step", 2, 2, 2, tensor_cores=False))
    (m_gpu, g_gpu), (m_cpu, g_cpu) = results["card"], results["cpu"]
    for k, v in m_cpu.items():
        if not (math.isfinite(m_gpu[k]) and abs(m_gpu[k] - v) <= TRAIN_TOL_LOSS_REL * abs(v) + 1e-6):
            raise AssertionError(f"real pascal f32 step: {k} card {m_gpu[k]} vs CPU {v}")
    worst = max(((k, float((g_gpu[k] - g).abs().max()) / max(float(g.abs().max()), 1e-30)) for k, g in g_cpu.items()),
                key=lambda kv: kv[1])
    if not worst[1] <= TRAIN_TOL_GRAD_REL:
        raise AssertionError(f"real pascal f32 step: gradient of {worst[0]} off by {worst[1]} of its largest entry")
    print(f"real data (c) pascal_nolbo (category_dim resized 12 -> 2 by the fixture) f32 step on the val crops, B={n} "
          f"{IMAGE_SIZE}x{IMAGE_SIZE}, card vs CPU: metrics {m_gpu}; {len(g_cpu)} gradient leaves, worst {worst[0]} at "
          f"{worst[1]:.3e} of its largest entry (tol {TRAIN_TOL_GRAD_REL}, losses {TRAIN_TOL_LOSS_REL})", flush=True)
    del model_cpu, model_gpu, results, g_gpu, g_cpu

    def packed_fn(ld, model_cfg, batch_size):
        return cli_train.build_batch_fn(ld, model_cfg, batch_size, packed=True, native=True,
                                        image_size=(IMAGE_SIZE, IMAGE_SIZE))

    trainer.batch_fn = packed_fn(loader, cfg, TRAIN_BATCH)
    fresh = Pascal3DSingleObjectLoader(PASCAL_FIXTURES, "train", seed=1)
    loader_ms = loader_batch_ms(fresh, packed_fn(fresh, cfg, TRAIN_BATCH))
    step = trainer.step_fn
    reset_counts()
    step_ms, host, wall, peak = timed_train(trainer, "real pascal train")
    add(expect_counts("real pascal train", 2 * REAL_STEPS, 2 * REAL_STEPS, 2 * REAL_STEPS, tensor_cores=True))
    alone = step_alone(trainer, step, trainer.batch_fn(0))
    print("real data (c) " + real_train_line(
        f"pascal_nolbo through cli/train.py --data <Pascal3D fixture>, {REAL_STEPS} steps, B={TRAIN_BATCH} bf16, "
        f"{IMAGE_SIZE}x{IMAGE_SIZE} augmented crops, packed-blocked 64^3 targets, conv_k2 2 / 2 / 2 a step on wgmma",
        trainer, step_ms, host, wall, peak, TRAIN_BATCH, loader_ms, alone, card), flush=True)
    loader.close()
    del trainer
    torch.cuda.empty_cache()

    # (d) kitti_inst_only on the KITTI crops with --cad-path, REAL_KITTI_STEPS bf16 steps at B=32
    cad = os.path.join(KITTI_FIXTURES, "cad")
    argv = ["--config", "kitti_inst_only", "--data", KITTI_FIXTURES, "--cad-path", cad, "--bf16", "--batch-size",
            str(TRAIN_BATCH), "--image-size", str(IMAGE_SIZE), "--steps", str(REAL_KITTI_STEPS), "--eval-every", "0"]
    trainer, loader = cli_train.build_trainer(cli_train.parse_args(argv))
    trainer.batch_fn = packed_fn(loader, trainer.model.config, TRAIN_BATCH)
    fresh = KittiSingleObjectLoader(KITTI_FIXTURES, cad, "train", seed=1)
    loader_ms = loader_batch_ms(fresh, packed_fn(fresh, trainer.model.config, TRAIN_BATCH))
    if set(trainer.batch_fn(0)) != {"input", "target_packed_blocked", "inst_onehot"}:
        raise AssertionError("kitti: the 5-tuple batch carries a class")
    step = trainer.step_fn
    reset_counts()
    step_ms, host, wall, peak = timed_train(trainer, "real kitti train")
    add(expect_counts("real kitti train", 2 * REAL_KITTI_STEPS, 2 * REAL_KITTI_STEPS, 2 * REAL_KITTI_STEPS,
                      tensor_cores=True))
    alone = step_alone(trainer, step, trainer.batch_fn(0))
    print("real data (d) " + real_train_line(
        f"kitti_inst_only through cli/train.py --data <KITTI fixture> --cad-path, {REAL_KITTI_STEPS} steps, "
        f"B={TRAIN_BATCH} bf16, {IMAGE_SIZE}x{IMAGE_SIZE} crops, conv_k2 2 / 2 / 2 a step on wgmma",
        trainer, step_ms, host, wall, peak, TRAIN_BATCH, loader_ms, alone, card), flush=True)
    loader.close()
    del trainer
    torch.cuda.empty_cache()

    # (e) the detector on the Pascal3D frames (the car images) through cli/train_detector.py, then its eval
    argv = ["--data", PASCAL_FIXTURES, "--bf16", "--batch-size", str(DET_TRAIN_BATCH), "--image-size",
            str(DET_FRAME), str(DET_FRAME), "--grid-size", str(DET_GRID), str(DET_GRID), "--voxel-dim",
            str(DET_VOXEL), "--max-detections", str(DET_MAX_DETECTIONS), "--steps", str(REAL_DET_STEPS)]
    args = cli_det.parse_args(argv)
    trainer, loader = cli_det.build_trainer(args)
    fresh = Pascal3DMultiObjectLoader(PASCAL_FIXTURES, "train", image_size=(DET_FRAME,) * 2,
                                      grid_size=(DET_GRID,) * 2, seed=1)
    loader_ms = loader_batch_ms(fresh, cli_det.build_batch_fn(fresh, DET_TRAIN_BATCH, args.max_slots))
    step = trainer.step_fn
    reset_counts()
    step_ms, host, wall, peak = timed_train(trainer, "real detector train")
    add(expect_counts("real detector train", REAL_DET_STEPS, REAL_DET_STEPS, REAL_DET_STEPS, tensor_cores=False,
                      narrow=(REAL_DET_STEPS,) * 3))
    alone = step_alone(trainer, step, trainer.batch_fn(0))
    t0 = time.perf_counter()
    det = evaluate_detector(trainer.model, cli_det.build_batch_fn(loader, DET_TRAIN_BATCH, args.max_slots),
                            num_batches=2)
    eval_s = time.perf_counter() - t0
    if not all(math.isfinite(v) for v in det.values()):
        raise AssertionError(f"real detector eval: {det}")
    print("real data (e) " + real_train_line(
        f"the detector through cli/train_detector.py --data <Pascal3D fixture> ({loader.dataLength} car frames), "
        f"{REAL_DET_STEPS} steps, B={DET_TRAIN_BATCH} bf16, {DET_FRAME}x{DET_FRAME} frames, {DET_GRID}x{DET_GRID} "
        f"grid, {DET_VOXEL}^3 voxels, conv_k2 1 / 1 / 1 a step, all narrow", trainer, step_ms, host, wall, peak,
        DET_TRAIN_BATCH, loader_ms, alone, card) + f"; evaluate_detector on 2 batches {eval_s:.2f} s, "
        f"{ {k: round(v, 4) for k, v in det.items()} }", flush=True)
    loader.close()
    del trainer
    torch.cuda.empty_cache()

    # (f) darknet19 pretraining through cli/pretrain.py --data on an ImageNet-layout tree of the fixture PNGs
    tree = tempfile.mkdtemp(prefix="chip_smoke_imagenet_")
    try:
        for i, rel in enumerate(sorted(FIXTURE_PNG_SHA256)):
            os.makedirs(os.path.join(tree, f"n0{i % 3}"), exist_ok=True)
            shutil.copy(os.path.join(REPO, rel), os.path.join(tree, f"n0{i % 3}", f"img{i}.png"))
        argv = ["--data", tree, "--backbone", "darknet19", "--batch-size", str(PRETRAIN_BATCH), "--image-size",
                str(PRETRAIN_SIZE), "--bf16", "--steps", str(REAL_PRETRAIN_STEPS), "--eval-every", "0"]
        timers = []
        build_trainer = cli_pretrain.build_trainer

        def build_timed(a):
            tr, ld = build_trainer(a)
            timers.append((ld, tr.step_fn, install_step_timer(tr)))
            return tr, ld

        cli_pretrain.build_trainer = build_timed
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            trainer = cli_pretrain.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            cli_pretrain.build_trainer = build_trainer
        add(expect_counts("real pretrain (2-D convolutions only)", 0, 0, 0, tensor_cores=False))
        peak = torch.cuda.max_memory_allocated()
        check_trained(trainer, "real pretrain")
        loader, step, (events, entries) = timers[0]
        if trainer.model.config.num_classes != 3:
            raise AssertionError(f"pretrain: {trainer.model.config.num_classes} classes, the tree has 3")
        step_ms, host = step_times(events, entries)
        alone = step_alone(trainer, step, trainer.batch_fn(0))
        loader.close()
        fresh = ImagenetLoader(tree, seed=1)
        loader_ms = loader_batch_ms(fresh, cli_pretrain.build_batch_fn(fresh, PRETRAIN_BATCH, PRETRAIN_SIZE))
        print("real data (f) " + real_train_line(
            f"darknet19 pretraining through cli/pretrain.py --data <ImageNet-layout tree of the {len(FIXTURE_PNG_SHA256)}"
            f" fixture PNGs, 3 classes>, {REAL_PRETRAIN_STEPS} steps, B={PRETRAIN_BATCH} bf16, {PRETRAIN_SIZE}^2 "
            "augmented images, no conv_k2", trainer, step_ms, host, wall, peak, PRETRAIN_BATCH, loader_ms, alone, card),
            flush=True)
        del trainer
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tree, ignore_errors=True)

    # (g) kmeans_sincos / orientation_anchors, k=30, 1000 iterations, card against CPU
    rng = np.random.default_rng(SEED + 42)
    euler = (rng.uniform(-np.pi, np.pi, (KMEANS_POINTS, 3)) * np.array([1.0, 0.3, 0.2])).astype(np.float32)
    x = np.concatenate([np.sin(euler), np.cos(euler)], axis=-1)
    t0 = time.perf_counter()
    got = kmeans_sincos(x, KMEANS_K, KMEANS_ITERS, device=device)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = kmeans_sincos(x, KMEANS_K, KMEANS_ITERS)
    cpu_s = time.perf_counter() - t0
    err = float(np.abs(got[0] - want[0]).max())
    if not (np.array_equal(got[1], want[1]) and err <= KMEANS_TOL):
        raise AssertionError(f"kmeans: {int((got[1] != want[1]).sum())} assignments differ, centres off by {err:.3e}")
    records = [ObjRecord("car", "", 1, (0.0, 0.0, 1.0, 1.0), tuple(e)) for e in euler.tolist()]
    anchors = orientation_anchors(records, k=KMEANS_K, max_iter=KMEANS_ITERS, device=device)
    if float(np.abs(anchors - want[0]).max()) > KMEANS_TOL:
        raise AssertionError("orientation_anchors on the card: not kmeans_sincos's centres")
    print(f"real data (g) kmeans_sincos k={KMEANS_K}, {KMEANS_ITERS} iterations (after 10 on a subsample) on "
          f"{KMEANS_POINTS} seeded Euler triples: card against CPU, assignments equal, centres within {err:.3e} (tol "
          f"{KMEANS_TOL}); orientation_anchors on the card the same centres; host wall of the whole fit, card "
          f"{card_s * 1e3:.1f} ms, CPU {cpu_s * 1e3:.1f} ms [{card}]", flush=True)
    print(f"real data phase: {time.perf_counter() - t_phase:.1f} s wall", flush=True)
    return phase_counts


def ba_problem(p: int, n_l: int, seed: int):
    """``tests/test_ba.py::make_problem``'s scene at any size: ``p`` cameras
    along x looking at ``n_l`` points about z = 10, pixels of the true poses
    (``project``, float64) with 0.5 px of noise, every point seen by every
    camera; the poses (but the gauge's) and the points perturbed. A CPU float32
    ``BAProblem``."""
    from torch.func import vmap

    from anytime3d_tpu_torch.geometry.ba import BAProblem, project

    rng = np.random.default_rng(seed)
    poses = np.zeros((p, 6))
    poses[:, 3] = np.linspace(-1, 1, p)
    poses[:, :3] = rng.normal(0, 0.02, (p, 3))
    points = rng.normal([0, 0, 10], [2, 2, 1], (n_l, 3))
    intr = torch.tensor([500.0, 500.0, 320.0, 240.0], dtype=torch.float64)
    obs = vmap(vmap(lambda pose, pt: project(pose, pt, intr), in_dims=(None, 0)), in_dims=(0, None))(
        torch.from_numpy(poses), torch.from_numpy(points)).numpy()
    obs = obs + rng.normal(0, 0.5, obs.shape)
    poses0 = poses + rng.normal(0, 0.05, poses.shape)
    poses0[0] = poses[0]
    points0 = points + rng.normal(0, 0.2, points.shape)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    return BAProblem(f32(poses0), f32(points0), f32(obs), torch.ones((p, n_l)), intr.float())


def pose_graph(n: int, n_edges: int, seed: int):
    """A chain of ``n`` poses (a turn of 0.05 rad and 1 m a step, jittered),
    its noisy odometry (0.1 m on each translation) and ``n_edges - n + 1``
    exact loop closures between seeded pairs; the poses start from the noisy
    odometry integrated. A CPU float32 ``PoseGraph``."""
    from anytime3d_tpu_torch.geometry.posegraph import PoseGraph, compose, relative

    rng = np.random.default_rng(seed)
    gt = [torch.zeros(6, dtype=torch.float64)]
    for _ in range(n - 1):
        step = torch.tensor([0.0, 0.0, 0.05, 1.0, 0.0, 0.0], dtype=torch.float64) + torch.from_numpy(
            rng.normal(0, 0.01, 6))
        gt.append(compose(gt[-1], step))
    ei, ej, meas, w = [], [], [], []
    for i in range(n - 1):
        m = relative(gt[i], gt[i + 1]).numpy()
        m[3:] += rng.normal(0, 0.1, 3)
        ei, ej, meas, w = ei + [i], ej + [i + 1], meas + [m], w + [1.0]
    while len(ei) < n_edges:
        i, j = sorted(rng.choice(n, 2, replace=False))
        ei, ej, meas, w = ei + [i], ej + [j], meas + [relative(gt[i], gt[j]).numpy()], w + [2.0]
    poses = [torch.zeros(6, dtype=torch.float64)]
    for i in range(n - 1):
        poses.append(compose(poses[-1], torch.from_numpy(meas[i])))
    return PoseGraph(torch.stack(poses).float(), torch.tensor(ei), torch.tensor(ej),
                     torch.from_numpy(np.asarray(meas, np.float32)), torch.tensor(w))


def two_view_pair(n: int, seed: int, noise: float = 1e-4) -> tuple:
    """``tests/test_twoview.py::_synthetic_pair`` at ``n`` points: calibrated
    (pts1, pts2) float32 of a seeded scene under a seeded motion, and (R, t)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-1.0, -1.0, 4.0], [1.0, 1.0, 8.0], size=(n, 3))
    aa = 0.15 * rng.standard_normal(3)
    theta = np.linalg.norm(aa)
    k = aa / theta
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    r = np.eye(3) + np.sin(theta) * kx + (1 - np.cos(theta)) * kx @ kx
    t = np.array([0.5, -0.1, 0.2])
    pc2 = pts @ r.T + t
    p1 = pts[:, :2] / pts[:, 2:3] + rng.normal(scale=noise, size=(n, 2))
    p2 = pc2[:, :2] / pc2[:, 2:3] + rng.normal(scale=noise, size=(n, 2))
    return torch.from_numpy(p1.astype(np.float32)), torch.from_numpy(p2.astype(np.float32)), r, t


def rel_err(got, want) -> float:
    """max |got - want| over max |want|, on the CPU in float64."""
    got, want = (torch.as_tensor(x).detach().cpu().double() for x in (got, want))
    return float((got - want).abs().max()) / (float(want.abs().max()) + 1e-30)


def event_ms(fn) -> tuple:
    """(fn's result, its milliseconds by CUDA events)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def phase_mapping_dp(device: torch.device, card: str) -> dict:
    """Phase 17: drawing, the mapping geometry and data parallelism at one
    rank (NCCL on the card). Returns the phase's launch counts."""
    import hashlib

    import torch.distributed as dist

    from anytime3d_tpu_torch.anytime import AnytimeReconstructor
    from anytime3d_tpu_torch.anytime.engine import fuse_sequence, fuse_sequence_sharded
    from anytime3d_tpu_torch.cli import pretrain as cli_pretrain
    from anytime3d_tpu_torch.cli import train_detector as cli_det
    from anytime3d_tpu_torch.evaluation.viz import draw_scene
    from anytime3d_tpu_torch.geometry import ba, features, posegraph, twoview
    from anytime3d_tpu_torch.ops.sampling import fold_in
    from anytime3d_tpu_torch.parallel import all_reduce_grads, make_mesh
    from anytime3d_tpu_torch.parallel import mesh as mesh_module
    from anytime3d_tpu_torch.train.step import loss_and_grads, make_train_step_dp

    t_phase = time.perf_counter()
    phase_counts = dict.fromkeys(read_counts(), 0)
    cpu = torch.device("cpu")

    def add(counts: dict) -> None:
        for k, v in counts.items():
            phase_counts[k] += v

    # (a) drawing: the pinned frame, then phase 12's scene pass from the card
    image, scene = viz_scene()
    digest = hashlib.sha256(draw_scene(image, scene).tobytes()).hexdigest()
    if digest != VIZ_SHA256:
        raise AssertionError(f"viz: draw_scene gives {digest} on this host, the CPU tests pin {VIZ_SHA256}")
    line = "no scene pass (phase 12 did not run)"
    if DETECTOR_SCENE:
        frame, det_scene = DETECTOR_SCENE["frame"], DETECTOR_SCENE["scene"]
        drawn = draw_scene(frame, det_scene)
        if drawn.shape != tuple(frame.shape) or drawn.dtype != np.uint8:
            raise AssertionError(f"viz: the scene pass drew a {drawn.shape} {drawn.dtype} frame")
        line = (f"phase 12's scene pass ({int(det_scene['valid_det'].sum())} detections kept, "
                f"{int(det_scene['valid'].sum())} lifted) drawn on its {frame.shape[0]}x{frame.shape[1]} frame in "
                f"{mean_ms(lambda _: draw_scene(frame, det_scene), 10):.3f} ms of host")
    print(f"mapping (a) viz: the pinned frame's drawing equals the CPU tests' (sha256 {digest[:16]}...); {line} "
          f"[{card}]", flush=True)

    # (b) bundle adjustment at P x L on the card: the first step's pieces and update against the CPU, then a solve
    problem = ba_problem(BA_POSES, BA_LANDMARKS, SEED + 171)
    on = lambda prob, dev, dtype=torch.float32: ba.BAProblem(  # noqa: E731
        *(getattr(prob, f.name).to(dev, dtype) for f in dataclasses.fields(prob)))
    args = lambda prob: (prob.poses, prob.points, prob.observations, prob.mask, prob.intrinsics)  # noqa: E731
    pieces = {}
    for dev in (device, cpu):
        r, jp, jl = ba._residual_and_jacobians(*args(on(problem, dev)))
        s, rhs, *_ = ba._schur_reduce(r, jp, jl, 1e-3)
        pieces[dev.type] = {"r": r, "jp": jp, "jl": jl, "S": s, "rhs": rhs}
    errs = {k: rel_err(pieces[device.type][k], pieces["cpu"][k]) for k in pieces["cpu"]}
    step64 = {dev.type: ba.ba_step(on(problem, dev, torch.float64))[0] for dev in (device, cpu)}
    err64 = max(rel_err(getattr(step64[device.type], k), getattr(step64["cpu"], k)) for k in ("poses", "points"))
    del pieces, step64
    if max(errs.values()) > GEOM_TOL or err64 > 1e-9:
        raise AssertionError(f"ba: the card's first step against the CPU's: f32 {errs}, f64 update {err64}")
    gpu_problem = on(problem, device)
    ba.solve(gpu_problem, iters=1)  # warm-up
    (final, hist), solve_ms = event_ms(lambda: ba.solve(gpu_problem, iters=BA_STEPS))
    hist = hist.cpu().numpy()
    if not (np.all(np.isfinite(hist)) and hist[-1] < 0.05 * hist[0]):
        raise AssertionError(f"ba: the mse history does not fall 20x: {hist}")
    w_mb = BA_LANDMARKS * BA_POSES * 6 * 3 * 4 / 1e6
    print(f"mapping (b) bundle adjustment P={BA_POSES}, L={BA_LANDMARKS} (W {w_mb:.1f} MB), f32 on the card: the "
          f"first step's residuals, Jacobians and reduced system against the CPU within "
          f"{max(errs.values()):.2e} of each array's largest entry (tol {GEOM_TOL}), its f64 update within "
          f"{err64:.2e}; {BA_STEPS} steps, mse {hist[0]:.3f} -> {hist[-1]:.3f}, {solve_ms / BA_STEPS:.2f} ms a step "
          f"[{card}]", flush=True)

    # (c) the pose graph
    graph = pose_graph(PG_NODES, PG_EDGES, SEED + 172)
    g_on = lambda dev: posegraph.PoseGraph(  # noqa: E731
        *(getattr(graph, f.name).to(dev) for f in dataclasses.fields(graph)))
    first = {dev.type: posegraph.pgo_step(g_on(dev)) for dev in (device, cpu)}
    err = rel_err(first[device.type][0].poses, first["cpu"][0].poses)
    cost_err = rel_err(first[device.type][1], first["cpu"][1])
    if err > GEOM_TOL or cost_err > GEOM_TOL:
        raise AssertionError(f"pose graph: the card's first step is {err} (cost {cost_err}) off the CPU's")
    gpu_graph = g_on(device)
    posegraph.solve_pose_graph(gpu_graph, iters=1)
    (final_g, hist_g), pg_ms = event_ms(lambda: posegraph.solve_pose_graph(gpu_graph, iters=PG_STEPS))
    hist_g = hist_g.cpu().numpy()
    if not (np.all(np.isfinite(hist_g)) and hist_g[-1] < hist_g[0]):
        raise AssertionError(f"pose graph: the cost does not fall: {hist_g}")
    print(f"mapping (c) pose graph N={PG_NODES}, E={PG_EDGES} (a {6 * PG_EDGES}x{6 * PG_NODES} Jacobian), f32 on "
          f"the card: the first step within {err:.2e} of the CPU's (cost {cost_err:.2e}, tol {GEOM_TOL}); "
          f"{PG_STEPS} steps, cost {hist_g[0]:.3f} -> {hist_g[-1]:.5f}, {pg_ms / PG_STEPS:.2f} ms a step [{card}]",
          flush=True)

    # (d) features on a KITTI-sized frame and its shifted copy
    rgb = photo_frame(*KITTI_FRAME, SEED + 173).astype(np.float32) / 255.0
    frames = [torch.from_numpy(rgb), torch.from_numpy(np.roll(rgb, FEATURE_SHIFT, (0, 1)))]
    out = {}
    for dev in (device, cpu):
        fa, fb = (f.to(dev) for f in frames)
        ka, kb = (features.detect_keypoints(f, FEATURE_KEYPOINTS) for f in (fa, fb))
        da, db = features.extract_descriptors(fa, ka), features.extract_descriptors(fb, kb)
        out[dev.type] = (ka, kb, da, db, features.match_descriptors(da, db, ka.valid, kb.valid))
    (ka, kb, da, db, m), (cka, ckb, cda, cdb, cm) = out[device.type], out["cpu"]
    for got, want in ((ka, cka), (kb, ckb)):
        if not (torch.equal(got.valid.cpu(), want.valid) and torch.equal(got.rowcol.cpu(), want.rowcol)):
            raise AssertionError("features: the card's keypoints are not the CPU's")
    if not (torch.equal(m.valid.cpu(), cm.valid) and torch.equal(m.index_b.cpu()[cm.valid], cm.index_b[cm.valid])):
        raise AssertionError("features: the card's matches are not the CPU's")
    d_err = max(rel_err(da, cda), rel_err(db, cdb))
    moved = (ka.rowcol[m.index_a.long()] - kb.rowcol[m.index_b.long()])[m.valid].cpu().numpy()
    on_shift = float(np.mean(np.all(moved == -np.asarray(FEATURE_SHIFT), axis=-1))) if len(moved) else 0.0
    fa = frames[0].to(device)
    t_det = cuda_ms(lambda: features.detect_keypoints(fa, FEATURE_KEYPOINTS), iters=10)
    t_desc = cuda_ms(lambda: features.extract_descriptors(fa, ka), iters=10)
    t_match = cuda_ms(lambda: features.match_descriptors(da, db, ka.valid, kb.valid), iters=10)
    print(f"mapping (d) features on a {KITTI_FRAME[0]}x{KITTI_FRAME[1]} frame and its copy shifted by "
          f"{FEATURE_SHIFT}: {int(ka.valid.sum())} + {int(kb.valid.sum())} keypoints of {FEATURE_KEYPOINTS}, "
          f"{int(m.valid.sum())} matches ({on_shift:.0%} of them on the shift), keypoints and matches equal to the "
          f"CPU's, descriptors within {d_err:.2e}; ms on the card: detect {t_det:.3f}, describe {t_desc:.3f}, match "
          f"{t_match:.3f} [{card}]", flush=True)
    if int(m.valid.sum()) < 10 or on_shift < 0.8:
        raise AssertionError(f"features: {int(m.valid.sum())} matches, {on_shift:.0%} on the shift")

    # (e) two-view pose
    p1, p2, r_true, t_true = two_view_pair(TWOVIEW_POINTS, SEED + 174)
    w = torch.ones(TWOVIEW_POINTS)
    res = {dev.type: twoview.two_view_pose(p1.to(dev), p2.to(dev), w.to(dev)) for dev in (device, cpu)}
    rg, rc = res[device.type], res["cpu"]
    t_unit = t_true / np.linalg.norm(t_true)
    r_err = float(np.abs(rg.rotation.cpu().numpy() - r_true).max())
    t_err = float(np.abs(rg.translation.cpu().numpy() - t_unit).max())
    cc = max(rel_err(rg.rotation, rc.rotation), rel_err(rg.translation, rc.translation))
    e_sign = float(torch.sign((rg.essential.cpu() * rc.essential).sum()))
    e_err = rel_err(rg.essential.cpu() * e_sign, rc.essential)
    tv_ms = cuda_ms(lambda: twoview.two_view_pose(p1.to(device), p2.to(device), w.to(device)), iters=10)
    print(f"mapping (e) two-view pose of {TWOVIEW_POINTS} calibrated correspondences (1e-4 noise), f32 on the card: "
          f"R within {r_err:.2e} and t within {t_err:.2e} of the truth (tol {TWOVIEW_TOL[0]}); card against CPU: R "
          f"and t within {cc:.2e} (tol {TWOVIEW_TOL[1]}), E within {e_err:.2e} up to sign; {tv_ms:.3f} ms [{card}]", flush=True)
    if max(r_err, t_err) > TWOVIEW_TOL[0] or cc > TWOVIEW_TOL[1]:
        raise AssertionError(f"two-view: R {r_err}, t {t_err}, card against CPU {cc}")

    # (f) --mesh at one rank: NCCL on the card (gloo on the CPU), the flagship bf16 run with and without it
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False  # the two runs must take the same algorithms
    try:
        runs = {}
        for flag in ([], ["--mesh"]):
            args = cli_train.parse_args(["--config", "modelnet_nolbo", "--data", "synthetic", "--packed", "--bf16",
                                         "--batch-size", str(TRAIN_BATCH), "--steps", str(MESH_STEPS),
                                         "--eval-every", "0", "--device", device.type] + flag)
            trainer, _ = cli_train.build_trainer(args)
            events, entries = install_step_timer(trainer)
            sync()
            reset_counts()
            trainer.run()
            sync()
            print("", flush=True)
            check_trained(trainer, f"mesh run {flag}")
            add(expect_counts(f"train run {flag}", 4 * MESH_STEPS, 3 * MESH_STEPS, 4 * MESH_STEPS,
                              tensor_cores=device.type == "cuda"))
            runs["mesh" if flag else "plain"] = (trainer, step_times(events, entries)[0])
        mesh = runs["mesh"][0].mesh
        backend = dist.get_backend(mesh.get_group("data"))
        plain_rows, mesh_rows = runs["plain"][0].history, runs["mesh"][0].history
        if plain_rows != mesh_rows:
            raise AssertionError(f"--mesh at one rank: the metrics differ from the run without it: {mesh_rows} "
                                 f"against {plain_rows}")
        grads = {n: torch.randn_like(p) for n, p in runs["mesh"][0].model.named_parameters()}
        n_params = sum(g.numel() for g in grads.values())
        ar_f32 = cuda_ms(lambda: all_reduce_grads(grads, mesh), iters=10)
        ar_bf16 = cuda_ms(lambda: all_reduce_grads(grads, mesh, dtype=torch.bfloat16, average=True), iters=10)
        print(f"mapping (f) cli.train --mesh at 1 rank ({backend}): {MESH_STEPS} bf16 steps at B={TRAIN_BATCH}, every "
              f"logged metric equal bit for bit to the run without --mesh (loss_total "
              f"{plain_rows[0]['loss_total']:.4f} -> {plain_rows[-1]['loss_total']:.4f}); 4 / 3 / 4 conv_k2 "
              f"launches a step on the tensor cores in both; device ms a step by CUDA events (steps "
              f"{TRAIN_WARMUP}..{MESH_STEPS - 1}, cudnn deterministic) median {np.median(runs['mesh'][1]):.2f} "
              f"with --mesh, {np.median(runs['plain'][1]):.2f} without; the gradient all-reduce of {n_params} "
              f"parameters (one flat buffer) {ar_f32:.3f} ms in f32, {ar_bf16:.3f} ms in bf16 with the average "
              f"[{card}]", flush=True)
        del runs, grads

        # make_train_step_dp at one rank against the plain step fed its gradients rounded to bf16
        cfg = REGISTRY["modelnet_nolbo"]()
        loss_cfg = configs.loss_config("modelnet_nolbo")
        model_dp = MultiModalVAE(cfg, generator=torch.Generator().manual_seed(SEED)).to(device)
        model_ref = copy.deepcopy(model_dp)
        state_dp, state_ref = create_train_state(model_dp), create_train_state(model_ref)
        rng = np.random.default_rng(SEED + 175)
        batch = {"input_packed_blocked": torch.from_numpy(pack_voxels_blocked(
            synthetic_grids(TRAIN_SLICE_BATCH, cfg.decoder.output_shape[0], SEED + 175), 4)).to(device),
            "category_onehot": torch.from_numpy(np.eye(cfg.category_dim, dtype=np.float32)[
                rng.integers(0, cfg.category_dim, TRAIN_SLICE_BATCH)]).to(device)}
        gen = torch.Generator(device=device).manual_seed(SEED + 175)
        gen_ref = torch.Generator(device=device)
        gen_ref.set_state(gen.get_state())
        reset_counts()
        state_dp, m_dp = make_train_step_dp(model_dp, loss_cfg, mesh)(state_dp, batch, gen)
        g_ref, m_ref = loss_and_grads(model_ref, loss_cfg, batch, fold_in(gen_ref, 0))
        state_ref, m_ref = apply_gradients_if_finite(state_ref, {k: v.bfloat16().float() for k, v in g_ref.items()},
                                                     m_ref)
        sync()
        add(expect_counts("make_train_step_dp and its reference, f32", 8, 6, 8, tensor_cores=False))
        same = all(torch.equal(p, q) for p, q in zip(model_dp.parameters(), model_ref.parameters()))
        m_same = {k: float(v) for k, v in m_dp.items()} == {k: float(v) for k, v in m_ref.items()}
        if not (same and m_same):
            raise AssertionError(f"make_train_step_dp at one rank: parameters equal {same}, metrics equal {m_same}")
        print(f"mapping (f) make_train_step_dp at 1 rank, full width f32 B={TRAIN_SLICE_BATCH}: parameters and "
              f"metrics after the step equal bit for bit to the plain step fed its gradients rounded to bf16 "
              f"[{card}]", flush=True)

        # (g) the sharded fusion at one rank against the sequential one
        frng = np.random.default_rng(SEED + 176)
        means, lvs = (torch.from_numpy(frng.normal(scale=s, size=(64, cfg.z_category_dim)).astype(np.float32))
                      .to(device) for s in (1.0, 0.5))
        masks = torch.from_numpy((frng.uniform(size=(64, cfg.z_category_dim)) > 0.4).astype(np.float32)).to(device)
        rec = AnytimeReconstructor(model_dp)
        prior = rec.new_object()
        seq = fuse_sequence(means, lvs, masks, prior=prior)
        fused = [fuse_sequence_sharded(mesh, means, lvs, masks, prior=prior),
                 rec.observe_stream(prior, means, lvs, masks, mesh=mesh)]
        f_err = max(max(rel_err(b.info, seq.info), rel_err(b.precision, seq.precision)) for b in fused)
        print(f"mapping (g) fuse_sequence_sharded and observe_stream(mesh=) at 1 rank, 64 observations of "
              f"{cfg.z_category_dim} dims: within {f_err:.2e} of fuse_sequence (the same sums in another order) "
              f"[{card}]", flush=True)
        if f_err > 1e-6:
            raise AssertionError(f"fusion: the sharded form is {f_err} off the sequential one")
        del model_dp, model_ref, state_dp, state_ref, rec

        # (h) the two other CLIs with --mesh, 2 steps each
        reset_counts()
        pre = cli_pretrain.main(["--data", "synthetic", "--backbone", "darknet19", "--batch-size",
                                 str(PRETRAIN_BATCH), "--image-size", str(PRETRAIN_SIZE), "--bf16", "--steps", "2",
                                 "--mesh", "--device", device.type])
        sync()
        print("", flush=True)
        check_trained(pre, "cli.pretrain --mesh")
        add(expect_counts("cli.pretrain --mesh (2-D convolutions only)", 0, 0, 0, tensor_cores=False))
        det, det_metrics = cli_det.main(["--bf16", "--batch-size", str(DET_TRAIN_BATCH), "--image-size",
                                         str(DET_FRAME), str(DET_FRAME), "--grid-size", str(DET_GRID), str(DET_GRID),
                                         "--voxel-dim", str(DET_VOXEL), "--max-slots", str(DET_SLOTS),
                                         "--max-objects", str(DET_MAX_OBJECTS), "--max-detections",
                                         str(DET_MAX_DETECTIONS), "--steps", "2", "--mesh", "--device", device.type])
        sync()
        check_trained(det, "cli.train_detector --mesh")
        counts = read_counts()
        add(counts)
        if device.type == "cuda" and not (counts["conv_k2_dx"] == counts["conv_k2_dw"] == 2 <= counts["conv_k2"]
                                          and counts["conv_k2_narrow"] == counts["conv_k2"]):
            raise AssertionError(f"cli.train_detector --mesh: launches {counts}, expected 1 / 1 / 1 narrow a step")
        print(f"mapping (h) cli.pretrain --mesh (darknet19, B={PRETRAIN_BATCH}, {PRETRAIN_SIZE}^2, bf16) and "
              f"cli.train_detector --mesh (B={DET_TRAIN_BATCH}, {DET_FRAME}^2, bf16) 2 steps each at 1 rank: loss "
              f"{pre.history[-1]['loss_total']:.3f} and {det.history[-1]['loss_total']:.3f}, detection eval "
              f"{ {k: round(v, 3) for k, v in det_metrics.items() if k in ('map50', 'det_recall')} }; the "
              f"detector's launches {counts} [{card}]", flush=True)
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
        if dist.is_initialized():
            dist.destroy_process_group()
        mesh_module._mesh.cache_clear()
    print(f"mapping and data parallel phase: {time.perf_counter() - t_phase:.1f} s wall", flush=True)
    return phase_counts


# phase 18: the mid_blocked layout of modelnet_nolbo. (grid, C, N) of its four conv_k2 stages beyond the blocked head
# and tail: encoder stage 3 (s2d of 16^3) and 4 (s2d of 8^3), decoder stage 2 (then d2s to 8^3) and 3 (d2s to 16^3)
MID_K2 = [(8, 1024, 256), (4, 2048, 512), (4, 512, 2048), (8, 256, 1024)]
# (label, batch, dtype, stages) of its kernel rows: the train step's shapes in both types, and the served batch's
# that split their depth (the 4^3 ones and 8^3 1024 -> 256 at B=8), in both types
MID_CASES = [("mid_b32_bf16", TRAIN_BATCH, torch.bfloat16, MID_K2), ("mid_b32_f32", TRAIN_BATCH, torch.float32, MID_K2),
             ("mid_b8_bf16_4cubed", BATCH, torch.bfloat16, [k for k in MID_K2 if k[0] == 4]),
             ("mid_b8_bf16_8cubed", BATCH, torch.bfloat16, [MID_K2[0]]),
             ("mid_b8_f32_4cubed", BATCH, torch.float32, [k for k in MID_K2 if k[0] == 4]),
             ("mid_b8_f32_8cubed", BATCH, torch.float32, [MID_K2[0]])]
# forward / dx launches that split their depth: a served bf16 batch of 8 (8^3 1024 -> 256, 4^3 2048 -> 512 and
# 512 -> 2048), a bf16 train step at B=32 (the forward of 4^3 2048 -> 512, the dx of 512 -> 2048)
MID_SPLIT_SERVED = 3
MID_SPLIT_STEP = (1, 1)


def mid_ffma_splits(batch: int) -> tuple[int, int]:
    """The mid_blocked stages' float32 FFMA forwards and dx at ``batch`` whose depth splits (``ffma_split``; dx:
    the forward from N to C): 3 forwards at the served batch of 8; 4 and 4 at B=2."""
    return (sum(ffma_split(batch, g, g, g, C, N)[0] > 1 for g, C, N in MID_K2),
            sum(ffma_split(batch, g, g, g, N, C)[0] > 1 for g, C, N in MID_K2))


# the bf16 dw launches of a mid_blocked train step at B=32 on the persistent kernel: its two stages at 4^3
MID_PERSISTENT_STEP = sum(wgmma_plan(TRAIN_BATCH, g, g, g, C, N).dw_persistent is not None for g, C, N in MID_K2)


def mid_design(kernel: str, batch: int, grid: int, C: int, N: int, dtype: torch.dtype) -> str:
    """The design ``kernel`` takes at a mid_blocked stage (``check_kernel``'s ``want``): in bf16 the tensor-core
    kernels, dw on persistent blocks where the plan says so; in float32 FFMA, the forward and dx with their
    depth split where ``ffma_split`` says so (dx: the forward from N to C)."""
    if dtype == torch.bfloat16:
        persistent = kernel == "conv_k2_dw" and wgmma_plan(batch, grid, grid, grid, C, N).dw_persistent is not None
        return "persistent" if persistent else "wgmma"
    if kernel == "conv_k2_dw":
        return "ffma"
    c, n = (C, N) if kernel == "conv_k2" else (N, C)
    return "ffma_split" if ffma_split(batch, grid, grid, grid, c, n)[0] > 1 else "ffma"


def ffma_launch(kernel: str, src: torch.Tensor, w: torch.Tensor, out: torch.Tensor, splits: int):
    """A function that launches the float32 FFMA forward (or dx) of ``src`` into ``out`` straight through the
    library, its depth in ``splits`` runs (1: the kernel without the split), to time the two launched alike."""
    from anytime3d_tpu_torch.kernels import conv_k2 as k2mod

    B, D, H, W, depth = src.shape
    C, N = (depth, out.shape[-1]) if kernel == "conv_k2" else (out.shape[-1], depth)
    per_split = -(-(8 * depth // 16) // splits)
    part = k2mod._split_workspace(splits, out)
    wk = w.contiguous() if kernel == "conv_k2" else w.transpose(3, 4).contiguous()
    entry = k2mod._lib().conv_k2_forward if kernel == "conv_k2" else k2mod._lib().conv_k2_backward_input
    args = (src.data_ptr(), wk.data_ptr(), out.data_ptr(), 0 if part is None else part.data_ptr(), splits, per_split,
            B, D, H, W, C, N, 0, out.device.index, k2mod._stream(out))
    return lambda: k2mod._check_launch(f"{kernel} (FFMA, {splits} splits)", entry(*args))
MID_TRAIN_STEPS = 20
MID_SLICE_BATCH = 2  # the f32 train step also run on the CPU
MID_SERVE_BATCHES = 5
MID_FLAT_STEPS = 5  # bf16 steps timed with each optimizer
SUBPIXEL_CASE = (BATCH, 16, 64, 64)  # B, grid, C_in, C_out of the sub-pixel deconv check
SUBPIXEL_TOL_F32 = 1e-4  # f32: the k=2 conv and the k=3 phase conv sum the same products in another order


def mid_blocked_factory(base_factory):
    """``base_factory`` (a ``REGISTRY`` entry) with ``mid_blocked`` on its encoder and decoder."""
    def factory(**kw):
        cfg = base_factory(**kw)
        return dataclasses.replace(cfg, encoder3d=dataclasses.replace(cfg.encoder3d, mid_blocked=True),
                                   decoder=dataclasses.replace(cfg.decoder, mid_blocked=True))
    return factory


def mid_stage_layers(grid: int, C: int, N: int, device: torch.device):
    """(the default layout's layer, the mid_blocked layer) of one stage, each
    a function of its NDHWC input: a k=4 s=2 ``Conv3d`` against space-to-depth(2)
    and a k=2 conv (the encoder, N < C / 4), or a k=4 s=2 ``ConvTranspose3d``
    against a k=2 conv to 8 N and depth-to-space(2) (the decoder)."""
    from anytime3d_tpu_torch.nn.blocks import ConvK2, Conv3d, ConvTranspose3d, space_to_depth3d

    gen = torch.Generator().manual_seed(SEED + 19)
    if C > N:  # encoder: input (grid*2)^3 x C/8
        c_in = C // 8
        plain, mid = Conv3d(c_in, N, 4, 2, gen).to(device), ConvK2(C, N, gen).to(device)
        return c_in, 2 * grid, plain, lambda x: mid(space_to_depth3d(x, 2))
    n_out = N // 8
    plain, mid = ConvTranspose3d(C, n_out, 4, 2, gen).to(device), ConvK2(C, N, gen).to(device)
    return C, grid, plain, lambda x: depth_to_space3d(mid(x), 2)


def phase_mid_blocked(device: torch.device, card: str) -> tuple[dict, dict]:
    """``modelnet_nolbo`` with ``mid_blocked`` on its encoder and decoder at
    full width: a served f32 batch of 8 and an f32 train step at B=2 on the
    card against the CPU; bf16 served batches (8 ``wgmma`` launches each);
    ``MID_TRAIN_STEPS`` bf16 steps at B=32 through ``cli/train.py``'s trainer
    (8 / 7 / 8 ``wgmma`` launches a step) beside as many of the default layout
    (4 / 3 / 4); ``conv_k2``, dx and dw at the four new stages (and the 4^3
    ones at B=8) against their plain versions and float64 products, timed
    beside cuDNN's k=2 call and their bound, the other tile height beside
    and, where the plan splits the depth, the plan unsplit (on the card alone
    and the host's enqueue), the split reduce's device time from the profiler;
    in f32 at B=8 too, the split FFMA forward and dx against the kernel
    unsplit, and the persistent dw against the grid kernel;
    the cuDNN k=4 s=2 conv or transposed conv each stage replaces (a record);
    ``SubpixelDeconv3D`` against its plain version and ``ConvTransposeEquiv3D``;
    a bf16 step with ``flat_opt=True`` beside the per-leaf Adam. Returns the
    phase's launch counts and its kernel rows ``{kernel: {case: numbers}}``."""
    from anytime3d_tpu_torch.kernels import conv_k2 as k2mod
    from anytime3d_tpu_torch.kernels import subpixel
    from anytime3d_tpu_torch.nn.blocks import ConvTransposeEquiv3D
    from anytime3d_tpu_torch.train.step import make_train_step

    t_phase = time.perf_counter()
    phase_counts = dict.fromkeys(read_counts(), 0)

    def add(counts: dict) -> None:
        for k, v in counts.items():
            phase_counts[k] += v

    base_factory = REGISTRY["modelnet_nolbo"]
    cfg = mid_blocked_factory(base_factory)()
    item = cfg.decoder.output_shape

    # (a) f32, card against CPU: one served batch of 8 (8 FFMA forward launches), one train step at B=2
    t0 = time.perf_counter()
    model_cpu = MultiModalVAE(cfg, generator=torch.Generator().manual_seed(SEED)).eval()
    model_gpu = copy.deepcopy(model_cpu).to(device)
    if model_cpu.encoder3d.mid != [False, False, True, True]:
        raise AssertionError(f"mid_blocked encoder folds {model_cpu.encoder3d.mid}")
    x = torch.from_numpy(synthetic_grids(BATCH, item[0], SEED + 19))
    mask = torch.from_numpy(latent_masks(BATCH, cfg.z_category_dim, SEED + 19))
    with torch.inference_mode():
        cpu = make_infer_fn(model_cpu)(x, mask)
        torch.cuda.synchronize()
        reset_counts()
        gpu = make_infer_fn(model_gpu)(x.to(device), mask.to(device))
        torch.cuda.synchronize()
    served_splits = mid_ffma_splits(BATCH)[0]
    add(expect_counts("mid_blocked served batch, f32", 8, 0, 0, tensor_cores=False, ffma_split=(served_splits, 0)))
    line = compare_outputs("mid_blocked served batch card vs CPU", gpu, cpu, SLICE_TOL_F32)
    if float(gpu["pred"].float().std()) < 1e-3:
        raise AssertionError("mid_blocked served batch: pred is constant")
    # its time: on the card alone (5 batches back to back) and the profiler's busy time a batch
    infer32, x_dev, mask_dev = make_infer_fn(model_gpu), x.to(device), mask.to(device)
    with torch.inference_mode():
        served32 = lambda: infer32(x_dev, mask_dev)  # noqa: E731
        alone32, busy32 = device_ms(served32, iters=5), busy_ms(served32)
    print(f"mid_blocked modelnet_nolbo ({sum(p.numel() for p in model_cpu.parameters())} params; encoder folds "
          f"{model_cpu.encoder3d.mid}): f32 served batch of {BATCH}, card vs CPU (tol {SLICE_TOL_F32}): {line}; "
          f"8 conv_k2 launches (FFMA, {served_splits} of them with the depth split); on the card alone "
          f"{alone32:.3f} ms a batch, device busy {busy32:.3f} ms; {time.perf_counter() - t0:.1f} s [{card}]",
          flush=True)
    del model_cpu, model_gpu, infer32
    add(phase_train_slice(cfg, device, n=MID_SLICE_BATCH, launches=(8, 7, 8), what="mid_blocked train slice",
                          ffma_split=mid_ffma_splits(MID_SLICE_BATCH)))

    # (b) bf16 served batches: 8 tensor-core launches each, beside the default layout's 4
    served_ms = {}
    for label, layout_cfg, launches in (("mid_blocked", cfg, 8), ("default", base_factory(), 4)):
        model16 = MultiModalVAE(layout_cfg, generator=torch.Generator().manual_seed(SEED)).to(torch.bfloat16).to(device)
        infer = make_packed_infer(model16, item)
        packed = torch.from_numpy(pack_voxels(x.numpy())).to(device)
        infer(packed, mask.to(device))  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        outs = [infer(packed, mask.to(device)) for _ in range(MID_SERVE_BATCHES)]
        torch.cuda.synchronize()
        split = (MID_SPLIT_SERVED * MID_SERVE_BATCHES if label == "mid_blocked" else 0, 0)
        add(expect_counts(f"{label} bf16 served batches", launches * MID_SERVE_BATCHES, 0, 0, tensor_cores=True,
                          split=split))
        if not torch.isfinite(outs[-1]["z_mean"].float()).all():
            raise AssertionError(f"{label} bf16 served batch: z_mean not finite")
        served_ms[label] = cuda_ms(lambda: infer(packed, mask.to(device)))
        del model16, infer
    print(f"mid_blocked bf16 served batch of {BATCH}: {MID_SERVE_BATCHES} batches, 8 wgmma launches each "
          f"({MID_SPLIT_SERVED} of them split, each with its reduce); device "
          f"time per batch (CUDA events) {served_ms['mid_blocked']:.3f} ms, the default layout's "
          f"{served_ms['default']:.3f} ms [{card}]", flush=True)

    # (c) the train CLI's trainer, bf16, B=32, packed batches: mid_blocked, then the default layout
    runs = {}
    for label, launches in (("mid_blocked", (8, 7, 8)), ("default", (4, 3, 4))):
        REGISTRY["modelnet_nolbo"] = mid_blocked_factory(base_factory) if label == "mid_blocked" else base_factory
        try:
            args = cli_train.parse_args(["--config", "modelnet_nolbo", "--data", "synthetic", "--packed", "--bf16",
                                         "--batch-size", str(TRAIN_BATCH), "--steps", str(MID_TRAIN_STEPS),
                                         "--eval-every", "0"])
            trainer, _ = cli_train.build_trainer(args)
        finally:
            REGISTRY["modelnet_nolbo"] = base_factory
        if (label == "mid_blocked") != trainer.model.config.decoder.mid_blocked:
            raise AssertionError(f"{label} train run built {trainer.model.config.decoder}")
        reset_counts()
        step_ms, host, wall, peak = timed_train(trainer, f"{label} train run")
        split = tuple(n * MID_TRAIN_STEPS for n in (MID_SPLIT_STEP if label == "mid_blocked" else (0, 0)))
        persistent = MID_PERSISTENT_STEP * MID_TRAIN_STEPS if label == "mid_blocked" else 0
        add(expect_counts(f"{label} train run", *(n * MID_TRAIN_STEPS for n in launches), tensor_cores=True,
                          split=split, persistent=persistent))
        hist = trainer.history
        runs[label] = (np.median(step_ms), np.median(host))
        print(f"{label} train run: {MID_TRAIN_STEPS} steps, B={TRAIN_BATCH} bf16, 64^3 packed: loss_total "
              f"{hist[0]['loss_total']:.1f} -> {hist[-1]['loss_total']:.1f}; device time per step (CUDA events, steps "
              f"{TRAIN_WARMUP}..{MID_TRAIN_STEPS - 1}) median {np.median(step_ms):.2f} ms (min {step_ms.min():.2f}, "
              f"max {step_ms.max():.2f}); host wall per step median {np.median(host):.2f} ms; whole run {wall:.2f} s; "
              f"peak memory allocated {peak / 2**30:.2f} GiB; conv_k2 {launches[0]} / {launches[1]} / {launches[2]} "
              f"a step, on wgmma ({persistent // MID_TRAIN_STEPS} dw a step on persistent blocks) [{card}]",
              flush=True)
        del trainer
        torch.cuda.empty_cache()
    print(f"mid_blocked against the default layout, bf16 step at B={TRAIN_BATCH}: device {runs['mid_blocked'][0]:.2f} "
          f"vs {runs['default'][0]:.2f} ms, host wall {runs['mid_blocked'][1]:.2f} vs {runs['default'][1]:.2f} ms "
          f"[{card}]", flush=True)

    # (d) the kernels at the new stages: plain, float64, cuDNN's k=2 call, the bound, the other tile height
    gen = torch.Generator().manual_seed(SEED + 20)
    rows = {"conv_k2": {}, "conv_k2_dx": {}, "conv_k2_dw": {}}
    with torch.inference_mode():
        for case, batch, dtype, stages in MID_CASES:
            for grid, C, N in stages:
                x_, w_, g_ = k2_operands(gen, (batch, grid, grid, grid), C, N, dtype)
                exact = float64_products(x_, w_, g_) if dtype == torch.bfloat16 else {}
                for kernel, (run, plain, library) in k2_runs(x_, w_, g_).items():
                    label = f"{case} {grid}^3 {C}->{N}"
                    want = mid_design(kernel, batch, grid, C, N, dtype)
                    checked = check_kernel(kernel, label, run, plain, exact.get(kernel), want)
                    p1, t1, t2, p2 = cuda_ms(plain), cuda_ms(run), cuda_ms(run), cuda_ms(plain)
                    ms, plain_ms, library_ms = (t1 + t2) / 2, (p1 + p2) / 2, cuda_ms(library)
                    bound_ms, bound_by = k2_bound_ms(kernel, batch, C, N, dtype, grid)
                    row = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
                           "max_abs_err": checked["max_abs_err"], "bound_by": bound_by, "design": checked["design"]}
                    # on the card alone, kernel and cuDNN's call in turns (the op's host side can outlast a 0.03 ms
                    # kernel)
                    a1, l1, l2, a2 = (device_ms(f, iters=50) for f in (run, library, library, run))
                    row["device_ms"], row["library_device_ms"] = (a1 + a2) / 2, (l1 + l2) / 2
                    extra = (f"; on the card alone kernel {row['device_ms']:.4f} ms ({a1:.4f}, {a2:.4f}) library "
                             f"{row['library_device_ms']:.4f} ms ({l1:.4f}, {l2:.4f}), kernel / library "
                             f"{row['device_ms'] / row['library_device_ms']:.2f}")
                    if kernel == "conv_k2_dw":  # what the two write: cuDNN's weight gradient in the operands' type
                        out_lib = library()
                        row["library_dtype"] = str(out_lib.dtype).removeprefix("torch.")
                        extra += (f"; cuDNN's dw is {row['library_dtype']} "
                                  f"({out_lib.numel() * out_lib.element_size() / 1e6:.1f} MB), this one float32 "
                                  f"({8 * C * N * 4 / 1e6:.1f} MB)")
                    if want == "persistent":
                        # against the grid kernel (the route before it) on the same operands, launched the same
                        # way, on the card alone in turns
                        plan = wgmma_plan(batch, grid, grid, grid, C, N)
                        grid_plan = wgmma_plan(batch, grid, grid, grid, C, N, persistent_dw=False)
                        walk, out, other = plan.dw_persistent, run(), torch.empty(2, 2, 2, C, N, device=device)
                        k2mod.dw_wgmma(x_, g_, other, grid_plan)
                        torch.cuda.synchronize()
                        off = float((other - out).abs().max())
                        if off > 2 * K2_TOL_DW_F64_REL * float(out.abs().max()):
                            raise AssertionError(f"{kernel} {label}: the grid kernel differs by {off}")
                        by_plan = lambda: k2mod.dw_wgmma(x_, g_, other, plan)
                        by_grid = lambda: k2mod.dw_wgmma(x_, g_, other, grid_plan)
                        q1, u1, u2, q2 = (device_ms(f, iters=50) for f in (by_plan, by_grid, by_grid, by_plan))
                        row |= {"device_ms_persistent": (q1 + q2) / 2, "device_ms_grid": (u1 + u2) / 2,
                                "tiles": walk.tiles, "splits": walk.splits}
                        extra += (f"; {walk.tiles} tiles of 128 x {walk.bn} on {walk.grid} blocks, the rows in "
                                  f"{walk.splits} split(s) of {walk.stages_per_split} stages; launched directly, "
                                  f"persistent {(q1 + q2) / 2:.4f} ms ({q1:.4f}, {q2:.4f}), the grid kernel "
                                  f"{grid_plan.dw_grid} {(u1 + u2) / 2:.4f} ms ({u1:.4f}, {u2:.4f}), "
                                  f"{off:.1e} apart")
                    if want == "ffma_split":
                        # against the FFMA kernel without the split, both launched straight through the library,
                        # on the card alone in turns, and the host's time to enqueue each
                        src, out = (x_, run()) if kernel == "conv_k2" else (g_, run())
                        cin, cout = (C, N) if kernel == "conv_k2" else (N, C)
                        splits, per_split = ffma_split(batch, grid, grid, grid, cin, cout)
                        other = torch.empty_like(out)
                        by_plan, by_un = (ffma_launch(kernel, src, w_, other, n) for n in (splits, 1))
                        by_un()
                        torch.cuda.synchronize()
                        off = float((other - out).abs().max())
                        if off > 2 * K2_TOL_F32:  # two f32 sums in other orders, each within K2_TOL_F32 of plain
                            raise AssertionError(f"{kernel} {label}: unsplit differs from split by {off}")
                        q1, u1, u2, q2 = (device_ms(f, iters=20) for f in (by_plan, by_un, by_un, by_plan))
                        h1, v1, v2, h2 = (host_enqueue_ms(f, iters=20) for f in (by_plan, by_un, by_un, by_plan))
                        row |= {"device_ms_split": (q1 + q2) / 2, "device_ms_unsplit": (u1 + u2) / 2,
                                "host_ms_split": (h1 + h2) / 2, "host_ms_unsplit": (v1 + v2) / 2, "splits": splits,
                                "stages_per_split": per_split}
                        extra += (f"; the depth in {splits} splits of {per_split} stages of 16; launched directly, "
                                  f"on the card alone split {(q1 + q2) / 2:.4f} ms ({q1:.4f}, {q2:.4f}) unsplit "
                                  f"{(u1 + u2) / 2:.4f} ms ({u1:.4f}, {u2:.4f}), host enqueue split "
                                  f"{(h1 + h2) / 2:.4f} ms unsplit {(v1 + v2) / 2:.4f} ms, {off:.1e} apart")
                    if want == "wgmma" and kernel != "conv_k2_dw":
                        # the other tile height (128 <-> 256 rows) where the grid allows it, launched directly
                        cin, cout = (C, N) if kernel == "conv_k2" else (N, C)
                        plan = wgmma_plan(batch, grid, grid, grid, cin, cout)
                        alt = wgmma_plan(batch, grid, grid, grid, cin, cout, bm=384 - plan.bm)
                        row["splits"], row["stages_per_split"], row["tiles"] = (plan.splits, plan.stages_per_split,
                                                                               plan.tiles)
                        extra += (f"; {plan.tiles} tiles of {plan.bm} rows, the depth in {plan.splits} split(s) of "
                                  f"{plan.stages_per_split} stages")
                        if alt is not None:
                            src, out = (x_, run()) if kernel == "conv_k2" else (g_, run())
                            other = torch.empty_like(out)
                            launch = k2mod.forward_wgmma if kernel == "conv_k2" else k2mod.dx_wgmma
                            launch(src, w_, other, alt)
                            if not torch.equal(other, out):
                                raise AssertionError(f"{kernel} {label}: {alt.bm}-row tiles differ from {plan.bm}")
                            # both heights launched the same way and timed on the card alone (the op's host
                            # side can outlast a 0.05 ms kernel), in the order plan, other, other, plan
                            by_plan, by_alt = (lambda: launch(src, w_, other, plan)), (lambda: launch(src, w_, other, alt))
                            q1, o1, o2, q2 = (device_ms(f, iters=50) for f in (by_plan, by_alt, by_alt, by_plan))
                            row[f"device_ms_bm{plan.bm}"], row[f"device_ms_bm{alt.bm}"] = (q1 + q2) / 2, (o1 + o2) / 2
                            extra += (f"; launched directly, the plan's {plan.bm}-row tiles ({plan.tiles} tiles, "
                                      f"{plan.splits} splits) {(q1 + q2) / 2:.4f} ms ({q1:.4f}, {q2:.4f}), "
                                      f"{alt.bm}-row tiles ({alt.tiles} tiles, {alt.splits} splits) "
                                      f"{(o1 + o2) / 2:.4f} ms ({o1:.4f}, {o2:.4f}), same bits")
                        if plan.splits > 1:
                            # against the plan without the split (the one before it), launched the same way, in
                            # turns: on the card alone, and the host's time to enqueue the launch (the split's
                            # workspace, its reduce launched by the same call into the library)
                            src, out = (x_, run()) if kernel == "conv_k2" else (g_, run())
                            other = torch.empty_like(out)
                            launch = k2mod.forward_wgmma if kernel == "conv_k2" else k2mod.dx_wgmma
                            unsplit = wgmma_plan(batch, grid, grid, grid, cin, cout, split=False)
                            launch(src, w_, other, unsplit)
                            torch.cuda.synchronize()
                            off = float((other.float() - out.float()).abs().max())
                            if off > 2.0**-7 * float(out.float().abs().max()):
                                raise AssertionError(f"{kernel} {label}: unsplit differs from split by {off}")
                            by_plan, by_un = (lambda: launch(src, w_, other, plan)), (lambda: launch(src, w_, other,
                                                                                                     unsplit))
                            q1, u1, u2, q2 = (device_ms(f, iters=50) for f in (by_plan, by_un, by_un, by_plan))
                            h1, v1, v2, h2 = (host_enqueue_ms(f, iters=20) for f in (by_plan, by_un, by_un, by_plan))
                            row |= {"device_ms_split": (q1 + q2) / 2, "device_ms_unsplit": (u1 + u2) / 2,
                                    "host_ms_split": (h1 + h2) / 2, "host_ms_unsplit": (v1 + v2) / 2}
                            extra += (f"; against the plan unsplit ({unsplit.tiles} tiles of {unsplit.bm} rows), "
                                      f"launched directly, on the card alone split {(q1 + q2) / 2:.4f} ms ({q1:.4f}, "
                                      f"{q2:.4f}) unsplit {(u1 + u2) / 2:.4f} ms ({u1:.4f}, {u2:.4f}), host enqueue "
                                      f"split {(h1 + h2) / 2:.4f} ms ({h1:.4f}, {h2:.4f}) unsplit "
                                      f"{(v1 + v2) / 2:.4f} ms ({v1:.4f}, {v2:.4f})")
                    print(f"{kernel} {label} [{checked['design']}]: kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
                          f"library {library_ms:.4f} ms bound {bound_ms:.4f} ms ({bound_by}); kernel / bound "
                          f"{ms / bound_ms:.1f}, kernel / library {ms / library_ms:.2f}{extra} [{card}]", flush=True)
                    rows[kernel][f"{label}"] = row
                del x_, w_, g_, exact
        # the split forward's reduce, launched by the forward's own call into the library: its device time a
        # launch from the profiler, at the served batch's 4^3 2048 -> 512 (16 partials of 512 x 512), beside the
        # split kernel's; its plain version (the partials added in ascending order in f32, rounded once) timed on
        # partials of that shape; its output is the forward's, held above to the plain version and float64. The
        # bound: bytes (the partials read once, y written once) over the memory rate
        plan = wgmma_plan(BATCH, 4, 4, 4, 2048, 512)
        x_, w_, _ = k2_operands(gen, (BATCH, 4, 4, 4), 2048, 512, torch.bfloat16)
        prof = profile_rows(lambda: conv_k2(x_, w_), runs=20)
        reduce_ms = sum(ms for name, ms, _ in prof if "split_reduce" in name)
        split_ms = sum(ms for name, ms, _ in prof if "conv_k2_fwd_wgmma" in name)
        part = torch.randn(plan.splits, BATCH, 4, 4, 4, 512, generator=gen).to(device)
        p1, p2 = cuda_ms(lambda: split_reduce_plain(part)), cuda_ms(lambda: split_reduce_plain(part))
        count = BATCH * 64 * 512
        t_bytes, t_ops = (part.numel() * 4 + count * 2) / PEAK_BYTES_PER_S, (plan.splits - 1) * count / PEAK_FLOPS[
            torch.float32]
        forward_row = rows["conv_k2"]["mid_b8_bf16_4cubed 4^3 2048->512"]
        rows["conv_k2_split_reduce"] = {"mid_b8_bf16_4cubed 4^3 2048->512": {
            "ms": reduce_ms, "plain_ms": (p1 + p2) / 2, "library_ms": None, "split_kernel_ms": split_ms,
            "bound_ms": max(t_bytes, t_ops) * 1e3, "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "max_abs_err": forward_row["max_abs_err"], "design": "reduce"}}
        r = rows["conv_k2_split_reduce"]["mid_b8_bf16_4cubed 4^3 2048->512"]
        print(f"conv_k2_split_reduce {plan.splits} x {count} f32 -> bf16 (the split forward's partials at 4^3 "
              f"2048->512, B={BATCH}; the profiler's device time a launch): the reduce {reduce_ms:.4f} ms, the split "
              f"kernel {split_ms:.4f} ms; plain {r['plain_ms']:.4f} ms bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}); the forward's max abs err against its plain version {r['max_abs_err']:.3e} "
              f"[{card}]", flush=True)
        if reduce_ms <= 0 or split_ms <= 0:
            raise AssertionError(f"the profiler saw no split kernel or reduce: {prof}")
        del part, x_, w_
    # the rows of this PR's two designs: the float32 FFMA forward and dx with their depth split, and the bf16 dw on
    # persistent blocks
    rows["conv_k2_ffma_split"] = {f"{kernel} {label}": row for kernel in ("conv_k2", "conv_k2_dx")
                                  for label, row in rows[kernel].items() if row["design"] == "ffma_split"}
    rows["conv_k2_dw_persistent"] = {label: row for label, row in rows["conv_k2_dw"].items()
                                     if row["design"] == "persistent"}

    # (e) a record: the cuDNN k=4 s=2 conv or transposed conv each stage replaces, beside the stage's mid_blocked
    # layer (space-to-depth + conv_k2, or conv_k2 + depth-to-space), bf16 at B=32, forward and forward + backward
    for grid, C, N in MID_K2:
        c_in, g_in, plain, mid = mid_stage_layers(grid, C, N, device)
        xs = torch.randn(TRAIN_BATCH, g_in, g_in, g_in, c_in, device=device, dtype=torch.bfloat16)
        times = {}
        for label, layer in (("k=4 s=2 (cuDNN)", plain), ("mid_blocked", mid)):
            y0 = layer(xs)
            gy = torch.randn_like(y0)
            xg = xs.clone().requires_grad_(True)
            with torch.inference_mode():
                fwd = cuda_ms(lambda: layer(xs))
            both = cuda_ms(lambda: layer(xg).backward(gy))
            times[label] = (fwd, both)
        kind = "conv" if C > N else "transposed conv"
        print(f"stage {grid}^3 {C}->{N} at B={TRAIN_BATCH} bf16: the default layout's k=4 s=2 {kind} forward "
              f"{times['k=4 s=2 (cuDNN)'][0]:.4f} ms, forward + backward {times['k=4 s=2 (cuDNN)'][1]:.4f} ms; the "
              f"mid_blocked layer forward {times['mid_blocked'][0]:.4f} ms, forward + backward "
              f"{times['mid_blocked'][1]:.4f} ms (a record) [{card}]", flush=True)
        del xs, plain, mid

    # (f) SubpixelDeconv3D: conv_k2 on a (D+1)^3 grid (no plan: FFMA), against its plain version and
    # ConvTransposeEquiv3D on the same transposed-conv weight
    b, grid, c_in, c_out = SUBPIXEL_CASE
    equiv = ConvTransposeEquiv3D(c_in, c_out, generator=torch.Generator().manual_seed(SEED + 21)).to(device)
    sub = subpixel.SubpixelDeconv3D(c_in, c_out).to(device)
    with torch.no_grad():
        sub.weight.copy_(subpixel.convtranspose_kernel_to_subpixel(equiv.weight.flip(2, 3, 4).permute(2, 3, 4, 0, 1)))
    xs = torch.randn(b, grid, grid, grid, c_in, generator=torch.Generator().manual_seed(SEED + 21)).to(device)
    for dtype in (torch.float32, torch.bfloat16):
        xd = xs.to(dtype)
        with torch.inference_mode():
            before = conv_k2.launches
            y = sub(xd)
            if xd.is_cuda and conv_k2.launches != before + 1:
                raise AssertionError("SubpixelDeconv3D: not one conv_k2 launch")
            k2mod_conv = subpixel.conv_k2
            subpixel.conv_k2 = conv_k2_reference  # the plain version: the same function on the plain conv
            try:
                y_plain = sub(xd)
                plain_ms = cuda_ms(lambda: sub(xd))
            finally:
                subpixel.conv_k2 = k2mod_conv
            y_equiv = equiv(xd)
            ms, equiv_ms = cuda_ms(lambda: sub(xd)), cuda_ms(lambda: equiv(xd))
        top = float(y_equiv.float().abs().max())
        err_p, err_e = (float((y.float() - t.float()).abs().max()) for t in (y_plain, y_equiv))
        tol = SUBPIXEL_TOL_F32 * max(1.0, top) if dtype == torch.float32 else K2_TOL_BF16_REL * 2 * top
        print(f"SubpixelDeconv3D {grid}^3 {c_in}->{c_out}, B={b}, {dtype}: against its plain version "
              f"{err_p:.3e}, against ConvTransposeEquiv3D {err_e:.3e} (tol {tol:.3e}); {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, ConvTransposeEquiv3D {equiv_ms:.4f} ms [{card}]", flush=True)
        if not (err_p <= tol and err_e <= tol and y.shape == (b, 2 * grid, 2 * grid, 2 * grid, c_out)):
            raise AssertionError(f"SubpixelDeconv3D {dtype}: off its plain version or ConvTransposeEquiv3D")
    del equiv, sub, xs

    # (g) a bf16 step of the default layout with flat_opt=True beside the per-leaf Adam
    base_cfg, loss_cfg = configs.variant("modelnet_nolbo")
    models = {}
    for flat in (False, True):
        model = MultiModalVAE(base_cfg, generator=torch.Generator().manual_seed(SEED), dtype=torch.bfloat16).to(device)
        models[flat] = (model, create_train_state(model, flat_opt=flat), make_train_step(model, loss_cfg))
    loader = SyntheticVoxelLoader(num_samples=TRAIN_BATCH, dim=item[0], num_classes=base_cfg.category_dim)
    batch = to_device(cli_train.build_batch_fn(loader, base_cfg, TRAIN_BATCH, packed=True, native=True)(0), device)
    # the same update from the same gradients: the two optimizers agree
    grads = {k: torch.randn(p.shape, generator=torch.Generator().manual_seed(i), dtype=torch.float32).to(device) * 1e-2
             for i, (k, p) in enumerate(models[False][0].named_parameters())}
    for flat in (False, True):
        models[flat][1].apply_gradients(grads)
    with torch.no_grad():
        diff = max(float((a - b).abs().max()) for a, b in zip(models[False][0].parameters(),
                                                             models[True][0].parameters()))
    if not diff <= 1e-6:
        raise AssertionError(f"flat_opt: one update from the same gradients differs by {diff}")
    update_ms = {}
    for flat in (False, True, True, False):
        update_ms.setdefault(flat, []).append(cuda_ms(lambda: models[flat][1].apply_gradients(grads)))
    step_ms = {}
    for flat in (False, True, True, False):
        model, state, step = models[flat]
        g = torch.Generator(device=device).manual_seed(SEED)
        step(state, batch, g)  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        step_ms.setdefault(flat, []).append(cuda_ms(lambda: step(state, batch, g), iters=MID_FLAT_STEPS, warmup=0))
        add(expect_counts(f"bf16 step, flat_opt {flat}", 4 * MID_FLAT_STEPS, 3 * MID_FLAT_STEPS, 4 * MID_FLAT_STEPS,
                          tensor_cores=True))
    print(f"flat_opt, bf16 step of modelnet_nolbo at B={TRAIN_BATCH}: one update from the same gradients agrees "
          f"within {diff:.3e}; the update alone (CUDA events, 20 calls, two rounds) per-leaf Adam "
          f"{np.mean(update_ms[False]):.3f} ms ({', '.join(f'{v:.3f}' for v in update_ms[False])}), flat "
          f"{np.mean(update_ms[True]):.3f} ms ({', '.join(f'{v:.3f}' for v in update_ms[True])}); the step (mean of {MID_FLAT_STEPS}, two rounds) per-leaf "
          f"{np.mean(step_ms[False]):.2f} ms ({', '.join(f'{v:.2f}' for v in step_ms[False])}), flat "
          f"{np.mean(step_ms[True]):.2f} ms ({', '.join(f'{v:.2f}' for v in step_ms[True])}) [{card}]", flush=True)
    del models, batch, grads
    torch.cuda.empty_cache()
    print(f"mid_blocked phase: {time.perf_counter() - t_phase:.1f} s wall", flush=True)
    return phase_counts, rows


# phase 19: tensor parallelism over a ("data", "model") mesh of 1 x 2, two processes on the one card
TP_MODEL = 2  # the "model" axis
# (C, N) of the flagship's four k=2 stages on one model rank of 2: each shards its output channels
TP_K2 = [(64, 256), (512, 64), (128, 256), (512, 32)]
TP_CASES = [("tp_b32_bf16", TRAIN_BATCH, torch.bfloat16), ("tp_b32_f32", TRAIN_BATCH, torch.float32)]
TP_SLICE_BATCH = 8  # the float32 step held to the 1-rank step
TP_WARMUP, TP_STEPS, TP_PROBE_STEPS = 2, 5, 2  # bf16 steps at B=32: warm-up, timed, then with the collectives timed
TP_RANK_TIMEOUT_S = 600  # both ranks' whole run: start, model, the f32 check, the bf16 steps
# the f32 tensor-parallel step against the 1-rank step on the same card, weights, batch and draws: the
# metrics and the parameters after one Adam step at dryrun_multichip's bounds (__graft_entry__.py); the
# gradients, the same products summed in another order (a shard's GEMM tiles and dx's sum over the two
# ranks), relative to each leaf's largest entry
TP_TOL_METRIC = (2e-3, 1e-5)
TP_TOL_PARAM = (5e-3, 2.2e-4)
TP_TOL_GRAD_REL = 1e-4


def tp_step_inputs(cfg, n: int, seed: int) -> tuple[dict, dict]:
    """A packed-blocked batch of ``n`` seeded grids and its injected draws
    (the mixed branch on), as CPU tensors."""
    loss_cfg = configs.loss_config("modelnet_nolbo")
    rng = np.random.default_rng(seed)
    batch = {"input_packed_blocked": torch.from_numpy(pack_voxels_blocked(synthetic_grids(n, cfg.decoder.output_shape[0],
                                                                                          seed), 4)),
             "category_onehot": torch.from_numpy(np.eye(cfg.category_dim, dtype=np.float32)[
                 rng.integers(0, cfg.category_dim, n)])}
    z = cfg.z_category_dim
    draws = {"eps_inst": torch.from_numpy(rng.normal(size=(n, z)).astype(np.float32)),
             "eps_prior_cat": torch.from_numpy(rng.normal(size=(n, z)).astype(np.float32)),
             "coin": torch.tensor(True),
             "take_prior": torch.from_numpy(rng.uniform(size=(n, z)) < loss_cfg.mix_element_prob)}
    return batch, draws


def tp_expected(batch: int, dtype: torch.dtype, model: int) -> dict:
    """The launches of one train step of the flagship with its k=2 stages'
    output channels split over ``model`` ranks, on each rank: 4 forward, 3 dx
    (the first stage's input is data), 4 dw, on the routes the plans give
    their shapes: in bf16 the tensor-core ones, but 512 -> 32 at a model axis
    of 2, whose forward and dw walk C in chunks (the narrow kernels) and whose
    dx (the forward from 32 to 512, which neither plan of that forward takes)
    is the chunked dx; in f32 the FFMA ones, but that shard's forward, which
    walks C in chunks of 16 (its dx and dw keep FFMA, dw on the tile fitted to
    its 32 columns). In bf16 the encoder's stride-2 k=4 stages, their
    output channels split as well, add a lowered forward, dx and dw each
    where ``lowering_plans`` takes the shard."""
    want = dict.fromkeys(read_counts(), 0)
    bf16 = dtype == torch.bfloat16
    for stage, (C, N) in enumerate(FLAGSHIP_K2):
        n = N // model
        fwd, dx = (wgmma_plan(batch, GRID, GRID, GRID, C, n) if bf16 else None,
                   wgmma_plan(batch, GRID, GRID, GRID, n, C) if bf16 else None)
        narrow = narrow_plan(batch, GRID, GRID, GRID, C, n, dtype=dtype)
        assert narrow is None or narrow.c_chunks > 1  # only the walk in chunks: no other narrow shard
        assert narrow_plan(batch, GRID, GRID, GRID, n, C, dtype=dtype) is None
        chunked, chunked_dw = narrow is not None, narrow is not None and narrow.dw_box is not None
        chunked_dx = bf16 and dx is None and chunked_dx_plan(batch, GRID, GRID, GRID, C, n) is not None
        want["conv_k2"] += 1
        want["conv_k2_dw"] += 1
        want["conv_k2_wgmma"] += fwd is not None
        want["conv_k2_dw_wgmma"] += fwd is not None
        want["conv_k2_dw_persistent"] += fwd is not None and fwd.dw_persistent is not None
        want["conv_k2_narrow"] += chunked
        want["conv_k2_chunked"] += chunked
        want["conv_k2_chunked_f32"] += chunked and not bf16
        want["conv_k2_dw_narrow"] += chunked_dw
        want["conv_k2_dw_chunked"] += chunked_dw
        want["conv_k2_dw_ffma_fit"] += fwd is None and not chunked_dw and ffma_dw_fitted(C, n)
        if stage:
            want["conv_k2_dx"] += 1
            want["conv_k2_dx_wgmma"] += dx is not None
            want["conv_k2_dx_narrow"] += chunked_dx
            want["conv_k2_dx_chunked"] += chunked_dx
    # the encoder's stride-2 k=4 stages, their output channels split too: lowered in bf16 where a plan takes them
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for n, C, N in K4S2_STAGES:
        if bf16 and lowering_plans((batch, n, n, n, C), N // model, 4, 2, dtype, "cuda", sms) is not None:
            for key in ("conv_k4s2", "conv_k4s2_dx", "conv_k4s2_dw"):
                want[key] += 1
    return want


def tp_timed_steps(step, state, batch: dict, generator, n: int) -> tuple[np.ndarray, np.ndarray, dict]:
    """``n`` train steps, each fenced: device ms by CUDA events and host wall
    ms a step; fails on a non-finite loss or a zeroed update."""
    device_ms_, host_ms = [], []
    metrics = {}
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = step(state, batch, generator)
        end.record()
        end.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        device_ms_.append(start.elapsed_time(end))
        metrics = {k: float(v) for k, v in metrics.items()}
        if not (math.isfinite(metrics["loss_total"]) and metrics["grads_finite"] == 1.0):
            raise AssertionError(f"tensor-parallel phase: a step gave {metrics}")
    return np.asarray(device_ms_), np.asarray(host_ms), metrics


def tp_rank(workdir: str) -> None:
    """One model rank of phase 19 (b), started by ``phase_tensor_parallel``
    with ``COORDINATOR_ADDRESS``, ``NUM_PROCESSES`` and ``PROCESS_ID``: gloo
    on the card's tensors, asked for by name. Prints one ``TP_RESULT`` JSON
    line; any failure raises, so the process exits non-zero."""
    import hashlib

    import torch.distributed as dist

    from anytime3d_tpu_torch.parallel import gather_params, initialize, make_mesh, mesh_device, parallelize
    from anytime3d_tpu_torch.parallel.mesh import gather_along
    from anytime3d_tpu_torch.train.step import loss_and_grads, make_train_step

    rank, world = initialize(backend="gloo", device="cuda")
    torch.backends.cudnn.allow_tf32 = False  # true f32, as the 1-rank reference
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(data=1, model=TP_MODEL, device="cuda")
    device = mesh_device(mesh)
    out = {"rank": rank, "world": world, "backend": dist.get_backend(mesh.get_group("model"))}
    cfg = REGISTRY["modelnet_nolbo"]()
    loss_cfg = configs.loss_config("modelnet_nolbo")

    # (b1) the f32 step at B=8 against the 1-rank step's gradients, metrics and parameters after Adam
    no_drop = dataclasses.replace(cfg, prior_category=dataclasses.replace(cfg.prior_category, dropout_rate=0.0))
    model = parallelize(MultiModalVAE(no_drop, generator=torch.Generator().manual_seed(SEED)).to(device), mesh)
    batch, draws = tp_step_inputs(cfg, TP_SLICE_BATCH, SEED + 30)
    reset_counts()
    grads, metrics = loss_and_grads(model, loss_cfg, to_device(batch, device), draws=to_device(draws, device),
                                    mesh=mesh)
    whole = {n: (grads[n] if getattr(p, "model_axis", None) is None else
                 gather_along(grads[n], p.model_axis, p.model_group)).cpu() for n, p in model.named_parameters()}
    _, metrics = apply_gradients_if_finite(create_train_state(model), grads, metrics, mesh)
    counts = read_counts()
    if counts != tp_expected(TP_SLICE_BATCH, torch.float32, TP_MODEL):
        raise AssertionError(f"rank {rank}, f32 step: launches {counts}")
    params = {k: v.cpu() for k, v in gather_params(model, mesh).items()}
    digest = hashlib.sha256()
    for k, v in params.items():
        digest.update(k.encode() + v.numpy().tobytes())
    out |= {"f32_counts": counts, "digest": digest.hexdigest(),
            "sharded": sum(getattr(p, "model_axis", None) is not None for p in model.parameters()),
            "params_this_rank": sum(p.numel() for p in model.parameters()),
            "params_whole": sum(v.numel() for v in params.values())}
    metrics = {k: float(v) for k, v in metrics.items()}
    if rank == 0:
        ref = torch.load(os.path.join(workdir, "reference.pt"), weights_only=True)
        worst = {}
        for k, want in ref["metrics"].items():
            if not abs(metrics[k] - want) <= TP_TOL_METRIC[0] * abs(want) + TP_TOL_METRIC[1]:
                raise AssertionError(f"tensor-parallel f32 step: metric {k} {metrics[k]} against {want}")
        worst["grad_rel"] = max((float((whole[k] - g).abs().max()) / float(g.abs().max()), k)
                                for k, g in ref["grads"].items() if float(g.abs().max()) > 0)
        if not worst["grad_rel"][0] <= TP_TOL_GRAD_REL:
            raise AssertionError(f"tensor-parallel f32 step: gradient {worst['grad_rel']} of its largest entry")
        for k, want in ref["params"].items():
            if not torch.allclose(params[k], want, rtol=TP_TOL_PARAM[0], atol=TP_TOL_PARAM[1]):
                raise AssertionError(f"tensor-parallel f32 step: parameter {k} off by "
                                     f"{float((params[k] - want).abs().max())}")
        worst["param_abs"] = max(float((params[k] - w).abs().max()) for k, w in ref["params"].items())
        worst["metric_rel"] = max(abs(metrics[k] - w) / max(abs(w), 1e-12) for k, w in ref["metrics"].items())
        out["f32_check"] = worst
    del model, grads, whole, params
    torch.cuda.empty_cache()

    # (b2) bf16 steps at B=32, the draws from one seeded generator on each rank
    model = parallelize(MultiModalVAE(cfg, generator=torch.Generator().manual_seed(SEED),
                                      dtype=torch.bfloat16).to(device), mesh)
    state = create_train_state(model)
    step = make_train_step(model, loss_cfg, mesh=mesh)
    batch = to_device(tp_step_inputs(cfg, TRAIN_BATCH, SEED + 31)[0], device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    step_ms, host_ms, metrics = tp_timed_steps(step, state, batch, gen, TP_WARMUP + TP_STEPS)
    counts = read_counts()
    want = {k: v * (TP_WARMUP + TP_STEPS) for k, v in tp_expected(TRAIN_BATCH, torch.bfloat16, TP_MODEL).items()}
    if counts != want:
        raise AssertionError(f"rank {rank}, bf16 steps: launches {counts}, expected {want}")
    out |= {"bf16_counts": counts, "step_ms": step_ms[TP_WARMUP:].tolist(), "host_ms": host_ms[TP_WARMUP:].tolist(),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "loss_total": metrics["loss_total"]}

    # the collectives of more steps, each fenced on both sides (all but those over a group of one rank)
    real = dist.all_reduce
    spent = {"ms": 0.0, "calls": 0, "mb": 0.0}

    def timed_all_reduce(t, op=dist.ReduceOp.SUM, group=None, async_op=False):
        if dist.get_world_size(group) == 1:
            return real(t, op=op, group=group, async_op=async_op)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = real(t, op=op, group=group, async_op=async_op)
        torch.cuda.synchronize()
        spent["ms"] += (time.perf_counter() - t0) * 1e3
        spent["calls"] += 1
        spent["mb"] += t.numel() * t.element_size() / 1e6
        return res

    dist.all_reduce = timed_all_reduce
    try:
        probe_ms, probe_host, _ = tp_timed_steps(step, state, batch, gen, TP_PROBE_STEPS)
    finally:
        dist.all_reduce = real
    out["collectives"] = {"ms_per_step": spent["ms"] / TP_PROBE_STEPS, "calls_per_step": spent["calls"] / TP_PROBE_STEPS,
                          "mb_per_step": spent["mb"] / TP_PROBE_STEPS, "probe_step_ms": probe_host.tolist()}
    out["counts"] = {k: out["f32_counts"][k] + counts[k] for k in counts}
    print("TP_RESULT " + json.dumps(out), flush=True)
    dist.barrier()
    dist.destroy_process_group()


def phase_tensor_parallel(device: torch.device, card: str) -> tuple[dict, dict]:
    """Phase 19: tensor parallelism. Returns the phase's launch counts (the
    1-rank runs here and both ranks' runs) and the shard shapes' kernel rows."""
    import socket

    from anytime3d_tpu_torch.parallel import param_sharding_rules, tp_coverage
    from anytime3d_tpu_torch.train.step import loss_and_grads, make_train_step

    t_phase = time.perf_counter()
    phase_counts = dict.fromkeys(read_counts(), 0)

    def add(counts: dict) -> None:
        for k, v in counts.items():
            phase_counts[k] += v

    # (a) forward, dx and dw at the shard shapes, in both types, on the routes their plans give them
    gen = torch.Generator().manual_seed(SEED + 29)
    rows = {"conv_k2": {}, "conv_k2_dx": {}, "conv_k2_dw": {}, "conv_k2_dx_chunked": {}, "conv_k2_chunked_f32": {},
            "conv_k2_dw_ffma_fit": {}}
    with torch.inference_mode():
        for case, batch, dtype in TP_CASES:
            for C, n in TP_K2:
                x, w, g = k2_operands(gen, (batch, GRID, GRID, GRID), C, n, dtype)
                exact = float64_products(x, w, g) if dtype == torch.bfloat16 else {}
                for kernel, (run, plain, library) in k2_runs(x, w, g).items():
                    cin, cout = (n, C) if kernel == "conv_k2_dx" else (C, n)
                    bf16 = dtype == torch.bfloat16
                    plan = wgmma_plan(batch, GRID, GRID, GRID, cin, cout) if bf16 else None
                    narrow = narrow_plan(batch, GRID, GRID, GRID, cin, cout, dtype=dtype)
                    if kernel == "conv_k2_dx":  # the forward from n to C has no narrow plan here
                        narrow = chunked_dx_plan(batch, GRID, GRID, GRID, C, n) if bf16 else None
                    elif kernel == "conv_k2_dw" and narrow is not None and narrow.dw_box is None:
                        narrow = None  # the f32 walk in chunks is the forward's alone
                    # 512 -> 32: in bf16 the forward and dw walk C in chunks, dx takes the chunked dx; in f32 the
                    # forward walks C in chunks of 16, dx keeps FFMA and dw takes the FFMA tile of 32 columns
                    want = "wgmma" if plan is not None else "chunked" if narrow is not None else "ffma"
                    if want == "ffma" and kernel == "conv_k2_dw" and ffma_dw_fitted(C, n):
                        want = "ffma_fit"
                    assert (want == "chunked") == (n == 32 and (bf16 or kernel == "conv_k2"))
                    assert (want == "ffma_fit") == (not bf16 and n == 32 and kernel == "conv_k2_dw")
                    assert (want == "ffma") == (not bf16 and (n != 32 or kernel == "conv_k2_dx"))
                    label = f"{case} {GRID}^3 {C}->{n}"
                    checked = check_kernel(kernel, label, run, plain, exact.get(kernel), want)
                    p1, t1, t2, p2 = cuda_ms(plain), cuda_ms(run), cuda_ms(run), cuda_ms(plain)
                    ms, plain_ms, library_ms = (t1 + t2) / 2, (p1 + p2) / 2, cuda_ms(library)
                    a1, l1, l2, a2 = (device_ms(f, iters=50) for f in (run, library, library, run))
                    bound_ms, bound_by = k2_bound_ms(kernel, batch, C, n, dtype)
                    row = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
                           "max_abs_err": checked["max_abs_err"], "bound_by": bound_by, "design": checked["design"],
                           "device_ms": (a1 + a2) / 2, "library_device_ms": (l1 + l2) / 2}
                    rows[kernel][label] = row
                    if checked["design"] == "chunked" and (kernel == "conv_k2_dx" or not bf16):
                        # the kernels of this shard's own entries: the chunked dx, the float32 chunked forward
                        rows["conv_k2_dx_chunked" if bf16 else "conv_k2_chunked_f32"][label] = row
                    if checked["design"] == "ffma_fit":  # and the float32 dw on the FFMA tile of 32 columns
                        rows["conv_k2_dw_ffma_fit"][label] = row
                    print(f"{kernel} TP shard {label} [{checked['design']}]: kernel {ms:.4f} ms plain "
                          f"{plain_ms:.4f} ms library {library_ms:.4f} ms bound {bound_ms:.4f} ms ({bound_by}); on "
                          f"the card alone kernel {row['device_ms']:.4f} ms ({a1:.4f}, {a2:.4f}) library "
                          f"{row['library_device_ms']:.4f} ms ({l1:.4f}, {l2:.4f}); kernel / bound "
                          f"{ms / bound_ms:.1f}, kernel / library {ms / library_ms:.2f} (alone "
                          f"{row['device_ms'] / row['library_device_ms']:.2f}) [{card}]", flush=True)
                del x, w, g, exact
    torch.cuda.empty_cache()
    for case, _, _ in TP_CASES:  # K8, K8b, K3 and the FFMA dw's tile of 32 columns: the shard 512 -> 32
        parts = []
        for kernel in ("conv_k2", "conv_k2_dw", "conv_k2_dx"):
            r = rows[kernel][f"{case} {GRID}^3 512->32"]
            parts.append(f"{kernel} [{r['design']}] alone {r['device_ms']:.4f} ms against cuDNN's call alone "
                         f"{r['library_device_ms']:.4f} ms ({r['device_ms'] / r['library_device_ms']:.2f}x), bound "
                         f"{r['bound_ms']:.4f} ms ({r['bound_by']}, {r['bound_ms'] / r['device_ms']:.1%} of it)")
        print(f"TP shard {case} {GRID}^3 512->32 (K8, K8b, K3, the f32 dw's fitted tile): " + "; ".join(parts)
              + f" [{card}]", flush=True)

    # (b) the flagship at full width: the placements, the 1-rank references here, then two model ranks
    cfg = REGISTRY["modelnet_nolbo"]()
    loss_cfg = configs.loss_config("modelnet_nolbo")
    with torch.device("meta"):
        shapes = dict(MultiModalVAE(cfg).named_parameters())
    placements = param_sharding_rules(shapes, TP_MODEL)
    print(f"tensor parallelism, modelnet_nolbo at model={TP_MODEL}: {sum(a is not None for a in placements.values())} "
          f"of {len(placements)} leaves sharded, coverage {tp_coverage(shapes, TP_MODEL):.6f} of "
          f"{sum(p.numel() for p in shapes.values())} parameters", flush=True)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    try:
        no_drop = dataclasses.replace(cfg, prior_category=dataclasses.replace(cfg.prior_category, dropout_rate=0.0))
        model = MultiModalVAE(no_drop, generator=torch.Generator().manual_seed(SEED)).to(device)
        batch, draws = tp_step_inputs(cfg, TP_SLICE_BATCH, SEED + 30)
        reset_counts()
        grads, metrics = loss_and_grads(model, loss_cfg, to_device(batch, device), draws=to_device(draws, device))
        ref = {"grads": {k: g.cpu().clone() for k, g in grads.items()}}
        _, metrics = apply_gradients_if_finite(create_train_state(model), grads, metrics)
        add(expect_counts("tensor-parallel phase, 1-rank f32 step", 4, 3, 4, tensor_cores=False))
        ref |= {"metrics": {k: float(v) for k, v in metrics.items()},
                "params": {k: p.detach().cpu() for k, p in model.named_parameters()}}
        torch.save(ref, os.path.join(workdir, "reference.pt"))
        del model, grads, ref
        model = MultiModalVAE(cfg, generator=torch.Generator().manual_seed(SEED), dtype=torch.bfloat16).to(device)
        step = make_train_step(model, loss_cfg)
        train_batch = to_device(tp_step_inputs(cfg, TRAIN_BATCH, SEED + 31)[0], device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        one_ms, one_host, _ = tp_timed_steps(step, create_train_state(model), train_batch,
                                              torch.Generator(device=device).manual_seed(SEED), TP_WARMUP + TP_STEPS)
        add(expect_counts("tensor-parallel phase, 1-rank bf16 steps", *(n * (TP_WARMUP + TP_STEPS) for n in (4, 3, 4)),
                          tensor_cores=True))
        one_peak = torch.cuda.max_memory_allocated() / 2**30
        del model, step, train_batch
        torch.cuda.empty_cache()

        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--tp-rank", workdir], cwd=REPO,
                                  env=dict(os.environ, COORDINATOR_ADDRESS=f"localhost:{port}",
                                           NUM_PROCESSES=str(TP_MODEL), PROCESS_ID=str(r)),
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(TP_MODEL)]
        try:
            logs = [p.communicate(timeout=TP_RANK_TIMEOUT_S)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        ranks_s = time.perf_counter() - t0
        results = []
        for r, (p, log) in enumerate(zip(procs, logs)):
            lines = [ln for ln in log.splitlines() if ln.startswith("TP_RESULT ")]
            if p.returncode != 0 or len(lines) != 1:
                raise AssertionError(f"tensor-parallel rank {r} exited {p.returncode}:\n{log[-6000:]}")
            results.append(json.loads(lines[0][len("TP_RESULT "):]))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    if len({r["digest"] for r in results}) != 1:
        raise AssertionError("tensor-parallel ranks end with different gathered parameters")
    for r in results:
        add(r["counts"])
    check, (r0, r1) = results[0]["f32_check"], results
    print(f"tensor-parallel f32 step, modelnet_nolbo full width, B={TP_SLICE_BATCH}, data=1 x model={TP_MODEL} "
          f"({r0['backend']}): against the 1-rank step, metrics {check['metric_rel']:.2e} relative (tol "
          f"{TP_TOL_METRIC}), gradients {check['grad_rel'][0]:.2e} of the leaf's largest entry ({check['grad_rel'][1]}; "
          f"tol {TP_TOL_GRAD_REL}), parameters after Adam {check['param_abs']:.2e} (tol {TP_TOL_PARAM}); "
          f"{r0['sharded']} sharded leaves, {r0['params_this_rank']} of {r0['params_whole']} parameters on each rank; "
          f"both ranks' gathered parameters the same bits [{card}]", flush=True)
    for r in results:
        c = r["collectives"]
        print(f"tensor-parallel bf16 steps, rank {r['rank']}, B={TRAIN_BATCH}: device ms a step (CUDA events, steps "
              f"{TP_WARMUP}..{TP_WARMUP + TP_STEPS - 1}) median {np.median(r['step_ms']):.2f} ({r['step_ms']}); host "
              f"wall median {np.median(r['host_ms']):.2f} ms; the model axis's all-reduces, each fenced, "
              f"{c['ms_per_step']:.2f} ms a step over {c['calls_per_step']:.0f} calls and {c['mb_per_step']:.1f} MB "
              f"(those steps {c['probe_step_ms']} ms); peak memory allocated {r['peak_gib']:.2f} GiB; loss_total "
              f"{r['loss_total']:.1f}; launches a step {r['bf16_counts']['conv_k2'] // (TP_WARMUP + TP_STEPS)} / "
              f"{r['bf16_counts']['conv_k2_dx'] // (TP_WARMUP + TP_STEPS)} / "
              f"{r['bf16_counts']['conv_k2_dw'] // (TP_WARMUP + TP_STEPS)}, on wgmma "
              f"{r['bf16_counts']['conv_k2_wgmma'] // (TP_WARMUP + TP_STEPS)} / "
              f"{r['bf16_counts']['conv_k2_dx_wgmma'] // (TP_WARMUP + TP_STEPS)} / "
              f"{r['bf16_counts']['conv_k2_dw_wgmma'] // (TP_WARMUP + TP_STEPS)}, chunked "
              f"{r['bf16_counts']['conv_k2_chunked'] // (TP_WARMUP + TP_STEPS)} / "
              f"{r['bf16_counts']['conv_k2_dx_chunked'] // (TP_WARMUP + TP_STEPS)} / "
              f"{r['bf16_counts']['conv_k2_dw_chunked'] // (TP_WARMUP + TP_STEPS)} (the 512->32 shard) [{card}]",
              flush=True)
    print(f"the 1-rank bf16 step beside them, B={TRAIN_BATCH}: device ms median {np.median(one_ms[TP_WARMUP:]):.2f}, "
          f"host wall median {np.median(one_host[TP_WARMUP:]):.2f} ms, peak memory {one_peak:.2f} GiB, 4 / 3 / 4 "
          f"on wgmma. Both model ranks shared this one card's SMs and gloo staged every collective through host "
          f"memory, so the wall time is not a two-card TP step's: the phase shows correctness at full width and "
          f"each shard kernel's own time. The ranks' run took {ranks_s:.1f} s; the phase "
          f"{time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
    return phase_counts, rows


def sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def main() -> None:
    card = phase_device()
    phase_build()
    kernels = phase_kernels(card)
    device = torch.device("cuda")
    cfg = REGISTRY["modelnet_nolbo"]()
    model, serve_bf16_counts = phase_slice(cfg, device, card)
    phase_train_slice(cfg, device)
    serve_counts = phase_serve(model, device, card)
    serve_counts = {k: v + serve_bf16_counts[k] for k, v in serve_counts.items()}
    del model
    phase_anytime_slice(cfg, device)
    anytime_counts = phase_anytime_timing(cfg, device, card)
    train_counts = phase_train_run(card)
    life_counts, artifact_counts = phase_lifecycle(cfg, device, card)
    image_counts = phase_image(device, card)
    for kernel, cases in phase_detector_kernels(card).items():
        kernels[kernel].update(cases)
    detector_counts = phase_detector(device, card)
    for kernel, cases in phase_stem_kernels(card).items():
        kernels.setdefault(kernel, {}).update(cases)
    for kernel, cases in phase_k4s2_kernels(card).items():
        kernels.setdefault(kernel, {}).update(cases)
    variant_counts = phase_variants(device, card)
    stream_counts = phase_pretrain_stream(device, card)
    real_counts = phase_real_data(device, card)
    mapping_counts = phase_mapping_dp(device, card)
    mid_counts, mid_rows = phase_mid_blocked(device, card)
    for kernel, cases in mid_rows.items():
        kernels.setdefault(kernel, {}).update(cases)
    tp_counts, tp_rows = phase_tensor_parallel(device, card)
    for kernel, cases in tp_rows.items():
        kernels.setdefault(kernel, {}).update(cases)
    entries = kernel_entries(kernels, serve_counts, train_counts, anytime_counts, life_counts, artifact_counts,
                             image_counts, detector_counts, variant_counts, stream_counts, real_counts, mapping_counts,
                             mid_counts, tp_counts)
    # every kernel, and every design of the three, went through the main paths
    for e in entries:
        for key in ("launches", "launches_wgmma", "launches_narrow", "launches_split", "launches_ffma_split",
                    "launches_persistent", "launches_chunked"):
            if e.get(key, 1) < 1:
                raise AssertionError(f"{e['name']}: {key} {e[key]} on the main paths")
    print(card, flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--tp-rank"]:  # one model rank of phase 19, started by phase_tensor_parallel
        tp_rank(sys.argv[2])
    else:
        main()
