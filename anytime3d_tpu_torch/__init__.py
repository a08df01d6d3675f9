"""anytime3d_tpu_torch — the PyTorch and CUDA port of ``anytime3d_tpu``.

It sits beside the JAX package, which stays the reference, and mirrors its
module names. It imports ``torch`` and never ``jax`` or ``flax``. Voxels keep
the JAX layout, NDHWC ``(B, D, H, W, C)``, at every public function.

Ported so far, for ``modelnet_nolbo``: the serving path (packed bits in,
blocked-head encoder, nearest-prior classification with latent fill,
blocked-tail decoder, packed bits out, behind a micro-batching HTTP server);
the train step (packed-blocked batches, losses in float32, a gradient
zeroed whole when any leaf is non-finite, Adam) and its loop (batches
prefetched on a worker thread, packed natively; ``cli/train.py``); and the
anytime engine with the evaluation protocols (``anytime/``, ``evaluation/``,
``cli/evaluate.py``); the image family (``pascal_nolbo``); and the
multi-object detector-reconstructor (``models/detector.py``, ``ops/nms.py``,
``geometry/``, ``models/pipeline.py``, ``train/detector_step.py``,
``evaluation/detection.py``, ``cli/train_detector.py``). The 2x2x2
convolutions run through hand-written CUDA kernels, forward and backward
(``kernels/csrc/conv_k2.cu``), on the GPU.
"""

__version__ = "0.1.0"
