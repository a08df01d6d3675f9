"""The serving programs: encode -> nearest-prior classify -> prior fill ->
decode, as an eager function over the model or as one exported artifact; and
the detector's per-frame program (:func:`export_detector`).

Counterpart of ``anytime3d_tpu/serving/export.py``. The JAX
package serialises the program as StableHLO; here :func:`export_infer` traces
it with ``torch.export`` (the weights and the prior means become constants of
the program, on the model's device and in its dtype) and saves it with
``torch.export.save`` into bytes, and :func:`load_infer` loads those bytes in
any process, with no model class, config or checkpoint. An artifact is tied to
the torch version that saved it: load it with the same version. Its batch
shape is static, as in the JAX artifact: the micro-batcher pads requests to it.
The ``conv_k2`` stages are the op ``anytime3d_torch::conv_k2`` in the program,
and a bfloat16 program traced on the card holds the encoder's stride-2 k=4
convs as ``anytime3d_torch::conv_k4s2``; importing this module registers both.

One deliberate difference: the JAX program applies a sigmoid to the decoder
output, which the decoder has already passed through its own sigmoid, so its
``pred`` lies in (0.5, 0.731) and every packed voxel reads as occupied. Here
``pred`` is the decoder's output.
"""

from __future__ import annotations

import io
import math
from typing import Callable, Dict, Sequence

import torch
import torch.nn as nn

import anytime3d_tpu_torch.kernels.conv_k2  # noqa: F401  registers the ops an exported program calls
import anytime3d_tpu_torch.kernels.conv_k4s2  # noqa: F401
from anytime3d_tpu_torch.anytime.engine import classify_by_prior
from anytime3d_tpu_torch.data.packing import pack_voxels_device, unpack_voxels
from anytime3d_tpu_torch.models.mmvae import MultiModalVAE
from anytime3d_tpu_torch.utils.profiling import span

InferFn = Callable[[torch.Tensor, torch.Tensor], Dict[str, torch.Tensor]]


class _ServingProgram(nn.Module):
    """The serving program over ``model`` and its class anchors (a buffer,
    or None): the module that the eager functions call and that
    ``export_infer`` exports. The anchors are ``prior_means`` (K, z_cat_dim)
    when given (a model without a category prior: the per-class mean latents
    of ``evaluation.protocols.category_vectors``), else the category prior
    net's means over all K one-hots, else none. With ``item_shape`` it takes
    packed bits, (B, N/8) uint8, of (B, *item_shape) grids; with
    ``threshold`` it returns ``pred_packed`` bits of ``pred > threshold`` in
    place of ``pred``. Spans: ``serve.unpack`` (the bits, or the cast, to
    the model's input), ``model.encode``, ``serve.classify`` (the nearest
    anchor and the fill of the missing dims), ``model.decode``,
    ``serve.pack`` (the output's cast and bits)."""

    def __init__(self, model: MultiModalVAE, correction: bool = True, item_shape=None, threshold=None,
                 prior_means=None):
        super().__init__()
        cfg = model.config
        model.eval()
        param = next(model.parameters())
        self.dtype = param.dtype
        if prior_means is not None:
            prior_means = torch.as_tensor(prior_means).to(param.device, param.dtype)
            z_cat_dim = cfg.z_category_dim or cfg.z_inst_dim
            if prior_means.ndim != 2 or prior_means.shape[1] != z_cat_dim:
                raise ValueError(f"prior_means {tuple(prior_means.shape)}: expected (K, {z_cat_dim})")
        elif cfg.prior_category is not None:
            with torch.inference_mode():
                eye = torch.eye(cfg.prior_category.input_dim, dtype=param.dtype, device=param.device)
                prior_means = model.priors_category(eye)[0]
        self.model = model
        # a normal tensor, not an inference one; None where the model has no anchors
        self.register_buffer("prior_means", None if prior_means is None else prior_means.clone())
        self.correction = correction
        self.item_shape = None if item_shape is None else tuple(item_shape)
        self.threshold = threshold

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> Dict[str, torch.Tensor]:
        with span("serve.unpack"):
            if self.item_shape is not None:
                x = unpack_voxels(x, self.item_shape)
            x = x.to(self.dtype)
        enc = self.model.encode(x)
        with span("serve.classify"):
            if enc.mean_category is not None:
                z_cat, lv_cat = enc.mean_category, enc.log_var_category
                z_parts, lv_parts = [enc.mean_inst], [enc.log_var_inst]
            else:
                z_cat, lv_cat = enc.mean_inst, enc.log_var_inst
                z_parts, lv_parts = [], []
            out = {}
            prior_means = self.prior_means
            if prior_means is not None:
                if self.correction:  # the class over the observed dims; the missing ones take its mean
                    category = classify_by_prior(z_cat, prior_means, mask=mask)
                    z_cat = torch.where(mask > 0, z_cat, prior_means[category])
                else:
                    category = classify_by_prior(z_cat, prior_means)
                out["category"] = category
            elif self.correction:  # no anchors: the missing dims take N(0, I)'s mean, 0
                z_cat = torch.where(mask > 0, z_cat, torch.zeros_like(z_cat))
            # an AE model has no log-var: zeros
            lv_parts = [torch.zeros_like(z) if lv is None else lv
                        for z, lv in zip([z_cat, *z_parts], [lv_cat, *lv_parts])]
            z = torch.cat([z_cat, *z_parts], dim=-1)
            out["z_mean"] = z.float()
            out["z_log_var"] = torch.cat(lv_parts, dim=-1).float()
        pred = self.model.decode(z)
        with span("serve.pack"):
            pred = pred.float()
            if self.threshold is None:
                out["pred"] = pred
            else:
                out["pred_packed"] = pack_voxels_device(pred, self.threshold)
        return out


def _inference(program: nn.Module) -> Callable[..., Dict[str, torch.Tensor]]:
    def fn(*args: torch.Tensor) -> Dict[str, torch.Tensor]:
        with torch.inference_mode():
            return program(*args)

    return fn


def make_infer_fn(model: MultiModalVAE, correction: bool = True, prior_means=None) -> InferFn:
    """Build ``fn(x, mask) -> outputs`` on the model's device and dtype.

    ``x`` is a (B, D, H, W, 1) occupancy grid, or for an image model (B, H,
    W, 3) float images in [0, 1]; ``mask`` a (B, z_cat_dim) 0/1
    tensor of OBSERVED latent dims. The class anchors are ``prior_means``
    (K, z_cat_dim) where given, else the category prior's means. With
    anchors and ``correction``, the class is the nearest anchor over the
    observed dims and the missing dims take that anchor before decoding;
    without anchors there is no class and, with ``correction``, the missing
    dims take 0. Outputs: ``z_mean`` (B, z_dim) and ``z_log_var`` (float32;
    zeros for an AE model), ``category`` (B,) int64 where there are anchors,
    ``pred`` (B, D, H, W, 1) float32 occupancy probabilities.

    Switches the model to eval mode. The prior means are computed here, once.
    """
    return _inference(_ServingProgram(model, correction, prior_means=prior_means))


def make_packed_infer(model: MultiModalVAE, item_shape: Sequence[int], threshold: float = 0.5,
                      prior_means=None) -> InferFn:
    """The serving program with packed IO: ``fn(packed, mask)`` takes (B, N/8)
    uint8 occupancy bits (``np.packbits`` order) of (B, *item_shape) grids and
    returns ``pred_packed`` (B, N/8) uint8 of ``pred > threshold`` in place of
    ``pred``, beside ``z_mean``, ``z_log_var`` and (with anchors, as in
    :func:`make_infer_fn`) ``category``."""
    return _inference(_ServingProgram(model, item_shape=item_shape, threshold=threshold, prior_means=prior_means))


def export_infer(model: MultiModalVAE, input_shape: Sequence[int], correction: bool = True,
                 packed_input: bool = False, packed_output: bool = False, output_threshold: float = 0.5,
                 prior_means=None) -> bytes:
    """The serving program of ``model`` exported with ``torch.export`` and
    saved into bytes: weights and class anchors (``prior_means``, or the
    category prior's means, as in :func:`make_infer_fn`) baked in, on the
    model's device and in its dtype.

    ``input_shape`` includes the batch, e.g. ``(8, 64, 64, 64, 1)``, or ``(8,
    64, 64, 3)`` for an image model; the program takes ``x`` as float32 of
    that shape, or with ``packed_input`` (voxel models) as (B, N/8) uint8
    occupancy bits, and a (B, z_cat_dim) float32 ``mask``.
    ``packed_output`` replaces ``pred`` with ``pred_packed`` bits at
    ``output_threshold``. Load the bytes with :func:`load_infer`."""
    batch, item_shape = int(input_shape[0]), tuple(input_shape[1:])
    program = _ServingProgram(model, correction, item_shape if packed_input else None,
                              output_threshold if packed_output else None, prior_means)
    device = next(model.parameters()).device
    if packed_input:
        x = torch.zeros((batch, math.prod(item_shape) // 8), dtype=torch.uint8, device=device)
    else:
        x = torch.zeros((batch, *item_shape), dtype=torch.float32, device=device)
    z_cat_dim = model.config.z_category_dim or model.config.z_inst_dim
    mask = torch.ones((batch, z_cat_dim), dtype=torch.float32, device=device)
    with torch.no_grad():
        exported = torch.export.export(program, (x, mask), strict=False)
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    return buf.getvalue()


class _DetectorProgram(nn.Module):
    """One frame (1, H, W, 3) -> ``detect`` with the thresholds baked in, then
    (``reconstruct``) the posterior-mean decode of all K slots in one decoder
    call, as ``vox`` (K, D, H, W)."""

    def __init__(self, model, obj_thresh: float, iou_thresh: float, reconstruct: bool):
        super().__init__()
        model.eval()
        self.model = model
        self.obj_thresh, self.iou_thresh, self.reconstruct = obj_thresh, iou_thresh, reconstruct

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = dict(self.model.detect(images, self.obj_thresh, self.iou_thresh))
        if self.reconstruct:
            out["vox"] = self.model.reconstruct(out["z_mean"], out["z_log_var"], sample=False)
        return out


def make_detector_fn(model, obj_thresh: float = 0.5, iou_thresh: float = 0.5,
                     reconstruct: bool = True) -> Callable[[torch.Tensor], Dict[str, torch.Tensor]]:
    """The eager per-frame detector program, ``fn(images) -> outputs``, on the
    model's device and dtype: what :func:`export_detector` exports."""
    return _inference(_DetectorProgram(model, obj_thresh, iou_thresh, reconstruct))


def export_detector(model, image_shape: Sequence[int], obj_thresh: float = 0.5, iou_thresh: float = 0.5,
                    reconstruct: bool = True, input_dtype: torch.dtype = torch.float32) -> bytes:
    """The detector's serving program exported with ``torch.export`` and saved
    into bytes: one frame in, fixed-size padded detections (and shapes) out,
    the weights and thresholds baked in, on the model's device and in its dtype.

    The program is ``DetectorReconstructor.detect`` (grid decode, per-cell
    winner, a stable top-K and the fixed-size NMS, all on the device), then,
    with ``reconstruct``, the posterior-mean decode of all K slots in one
    decoder call. ``image_shape`` includes the batch and must be (1, H, W, 3):
    detection is per frame. Outputs: ``bbox2d`` (K, 5) [x0, y0, x1, y1,
    score] normalized, ``valid`` (K,) bool, per slot ``ori_sin``,
    ``ori_cos``, ``rad_log_var``, ``bbox3d``, ``z_mean``, ``z_log_var``, and
    ``vox`` (K, D, H, W) when reconstructing. :func:`load_infer` loads it as
    ``fn(images) -> outputs``."""
    if tuple(image_shape)[0] != 1:
        raise ValueError(f"detector serving is per-frame; got batch {image_shape[0]}")
    program = _DetectorProgram(model, obj_thresh, iou_thresh, reconstruct)
    device = next(model.parameters()).device
    images = torch.zeros(tuple(image_shape), dtype=input_dtype, device=device)
    with torch.no_grad():
        exported = torch.export.export(program, (images,), strict=False)
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    return buf.getvalue()


class LoadedInfer:
    """An exported serving program, loaded, run under ``inference_mode``: the
    voxel and image programs of :func:`export_infer` as ``fn(x, mask) ->
    outputs``, the detector's of :func:`export_detector` as ``fn(images) ->
    outputs``. ``input_shape`` and ``input_dtype`` are those of its first
    input (uint8 (B, N/8) for a packed-input program, float32 (B, D, H, W,
    1) grids or (B, H, W, 3) images otherwise), ``mask_shape`` that of its
    mask (None for a one-input program), ``device`` where the inputs go;
    ``module`` is the program as an ``fx.GraphModule``."""

    def __init__(self, exported: torch.export.ExportedProgram):
        names = set(exported.graph_signature.user_inputs)
        inputs = [n.meta["val"] for n in exported.graph.nodes if n.op == "placeholder" and n.name in names]
        if len(inputs) not in (1, 2):
            raise ValueError(f"a serving program takes (x, mask) or (images,); this one takes {len(inputs)} inputs")
        x = inputs[0]
        self.input_shape, self.input_dtype = tuple(x.shape), x.dtype
        self.mask_shape = tuple(inputs[1].shape) if len(inputs) == 2 else None
        self.device = x.device
        self.module = exported.module()
        self._run = _inference(self.module)

    def __call__(self, *args: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self._run(*args)


def load_infer(data: bytes) -> LoadedInfer:
    """Load an artifact of :func:`export_infer` (``fn(x, mask)``) or of
    :func:`export_detector` (``fn(images)``)."""
    return LoadedInfer(torch.export.load(io.BytesIO(data)))
