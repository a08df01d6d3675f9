"""Multi-object detector-reconstructor: a YOLO-style grid head over a Darknet
backbone, and the voxel decoder for each detected object's shape.

Counterpart of ``anytime3d_tpu/models/detector.py``. Per cell and predictor
the head's channels are

  [objness 1 | bbox2D 4 (h, w, x, y) | bbox3D 3 (w, h, l) | z_mean z |
   z_log_var z | ori_sin 3 | ori_cos 3 | rad_log_var 3]

activated sigmoid / (exp, sigmoid) / relu / none / none / tanh / tanh / none.
Detection is one vectorised grid decode, a per-cell winner, a fixed-size
top-K and the fixed-size NMS of ``ops/nms.py``: every step a tensor op on the
device, nothing read back by the host. Shapes decode all K detections (times
the samples) in one decoder call.

Submodules are named as the flax ``setup`` names them (``backbone``,
``head``, ``decoder``), so ``convert.params_from_flax`` maps a flax tree by
name alone.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from anytime3d_tpu_torch.nn.autoencoder3d import Decoder3D, Decoder3DConfig
from anytime3d_tpu_torch.nn.darknet import BACKBONES, Head2D
from anytime3d_tpu_torch.ops.metrics import top_k_stable
from anytime3d_tpu_torch.ops.nms import nms
from anytime3d_tpu_torch.ops.sampling import reparameterize

FIELDS = ("bbox3d", "z_mean", "z_log_var", "ori_sin", "ori_cos", "rad_log_var")  # carried per detection


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """Field for field the JAX package's."""

    predictor_num: int = 5
    bbox2d_dim: int = 4
    bbox3d_dim: int = 3
    orientation_dim: int = 3
    z_inst_dim: int = 16
    predict_log_var: bool = True
    backbone: str = "darknet19"
    head_filter_nums: Tuple[int, ...] = (1024, 1024, 1024, 1024)
    head_filter_sizes: Tuple[int, ...] = (3, 3, 3, 1)
    act: str = "elu"
    decoder: Decoder3DConfig = dataclasses.field(default_factory=lambda: Decoder3DConfig(input_dim=16))
    max_detections: int = 16  # K, the fixed size of a frame's detections
    shape_samples: int = 32  # latent samples averaged per shape

    @property
    def channels_per_predictor(self) -> int:
        z = self.z_inst_dim * (2 if self.predict_log_var else 1)
        return 1 + self.bbox2d_dim + self.bbox3d_dim + z + 3 * self.orientation_dim

    @property
    def head_output_dim(self) -> int:
        return self.predictor_num * self.channels_per_predictor


class DetectorReconstructor(nn.Module):
    """Images (B, H, W, 3) -> per-cell detection fields; per-frame detections;
    per-object occupancy grids. ``dtype`` is the compute dtype (parameters
    stay float32)."""

    def __init__(self, config: DetectorConfig, generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        cfg = config
        self.config = cfg
        self.dtype = dtype
        self.backbone = BACKBONES[cfg.backbone](act=cfg.act, generator=generator, dtype=dtype)
        self.head = Head2D(self.backbone.out_features, cfg.head_output_dim, cfg.head_filter_nums,
                           cfg.head_filter_sizes, last_pooling=None, act=cfg.act, generator=generator)
        self.decoder = Decoder3D(cfg.decoder, generator=generator, dtype=dtype)

    def encode_grid(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Images (B, H, W, 3) -> the activated fields, each (B, gh, gw, P, .)."""
        cfg = self.config
        feats = self.backbone(images)
        if isinstance(feats, tuple):
            feats = feats[-1]
        raw = self.head(feats)
        b, gh, gw, _ = raw.shape
        raw = raw.reshape(b, gh, gw, cfg.predictor_num, cfg.channels_per_predictor)
        z = cfg.z_inst_dim
        sizes = [1, cfg.bbox2d_dim, cfg.bbox3d_dim, z, z if cfg.predict_log_var else 0] + [cfg.orientation_dim] * 3
        objness, bbox2d, bbox3d, z_mean, z_log_var, ori_sin, ori_cos, rad_log_var = raw.split(sizes, dim=-1)
        if not cfg.predict_log_var:
            z_log_var = torch.zeros_like(z_mean)
        return {
            "objness": torch.sigmoid(objness),
            # (h, w) exp-decoded; (x, y) cell-relative, sigmoid
            "bbox2d": torch.cat([torch.exp(bbox2d[..., :2]), torch.sigmoid(bbox2d[..., 2:])], dim=-1),
            "bbox3d": torch.relu(bbox3d),
            "z_mean": z_mean,
            "z_log_var": z_log_var,
            "ori_sin": torch.tanh(ori_sin),
            "ori_cos": torch.tanh(ori_cos),
            "rad_log_var": rad_log_var,
        }

    def detect(self, images: torch.Tensor, obj_thresh: float = 0.5, iou_thresh: float = 0.5,
               top_1_per_cell: bool = True) -> Dict[str, torch.Tensor]:
        """One frame (1, H, W, 3) -> K = ``max_detections`` padded detections:
        ``bbox2d`` (K, 5) [x_min, y_min, x_max, y_max, score] normalized to the
        image, the ``FIELDS`` (K, .) of each and a bool ``valid`` (K,)."""
        cfg = self.config
        fields = self.encode_grid(images)
        objness = fields["objness"][0, ..., 0]  # (gh, gw, P)
        gh, gw, p = objness.shape
        dev = objness.device
        if top_1_per_cell:  # the cell's best predictor keeps its score, the others score 0
            winner = torch.arange(p, device=dev) == objness.argmax(dim=-1, keepdim=True)
            objness = torch.where(winner, objness, torch.zeros_like(objness))
        rows = torch.arange(gh, dtype=torch.float32, device=dev)[:, None, None].expand(gh, gw, p)
        cols = torch.arange(gw, dtype=torch.float32, device=dev)[None, :, None].expand(gh, gw, p)
        bh, bw, bx, by = fields["bbox2d"][0].unbind(-1)
        cy, cx = (rows + by) / gh, (cols + bx) / gw
        scores = objness.reshape(-1)
        top_idx = top_k_stable(scores, min(cfg.max_detections, scores.numel()))
        valid = scores[top_idx] > obj_thresh
        boxes = torch.stack([(cx - bw / 2.0).reshape(-1), (cy - bh / 2.0).reshape(-1), (cx + bw / 2.0).reshape(-1),
                             (cy + bh / 2.0).reshape(-1), scores.float()], dim=-1)[top_idx]
        out = {"bbox2d": boxes, "valid": valid & nms(boxes, iou_thresh, valid=valid)}
        for name in FIELDS:
            f = fields[name][0]
            out[name] = f.reshape(-1, f.shape[-1])[top_idx]
        return out

    def reconstruct(self, z_mean: torch.Tensor, z_log_var: torch.Tensor, sample: bool = True,
                    generator: Optional[torch.Generator] = None, eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(K, z) latents -> (K, D, H, W) occupancy. With ``sample`` each object
        is the mean of ``shape_samples`` decodes of posterior samples, all K*S
        in one decoder call; the latents are repeated object by object
        (``repeat_interleave``, as ``jnp.repeat(axis=0)``) and the draws come
        from ``generator``, or are ``eps`` (K*S, z). Without, the posterior
        mean's decode."""
        if not sample:
            return self.decoder(z_mean)[..., 0]
        k, s = z_mean.shape[0], self.config.shape_samples
        latents = reparameterize(z_mean.repeat_interleave(s, dim=0), z_log_var.repeat_interleave(s, dim=0),
                                 generator, eps)
        vox = self.decoder(latents)
        return vox.reshape(k, s, *vox.shape[1:-1]).mean(dim=1)

    def initialize(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Run every submodule once (the grid fields and a decode of zeros), as
        the JAX package's ``initialize`` traces them; returns the fields."""
        fields = self.encode_grid(images)
        self.decoder(torch.zeros(1, self.config.decoder.input_dim, device=images.device))
        return fields

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.encode_grid(images)
