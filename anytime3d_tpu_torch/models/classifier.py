"""Image classifier for backbone pretraining: a Darknet backbone and a
``Head2D`` with average pooling -> class logits.

Counterpart of ``anytime3d_tpu/models/classifier.py``. The children are named
``backbone`` and ``head``, as the image MultiModalVAE names its own, so that
``train/checkpoint.py::graft_submodule`` moves a pretrained ``backbone``
into an image model unchanged; ``convert.params_from_flax`` maps the flax
tree (``backbone/...``, ``head/...``) by name.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn

from anytime3d_tpu_torch.nn.darknet import BACKBONES, Head2D


@dataclasses.dataclass(frozen=True)
class ClassifierConfig:
    num_classes: int = 1000
    backbone: str = "darknet19"
    head_filter_nums: Tuple[int, ...] = ()
    head_filter_sizes: Tuple[int, ...] = ()
    act: str = "elu"


class Classifier(nn.Module):
    """Images (B, H, W, 3) -> logits (B, num_classes) in the compute
    ``dtype`` (parameters stay float32; None computes in the input's dtype).
    A multi-map backbone's last map feeds the head."""

    def __init__(self, config: ClassifierConfig, generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        cfg = config
        self.config = cfg
        self.backbone = BACKBONES[cfg.backbone](act=cfg.act, generator=generator, dtype=dtype)
        self.head = Head2D(self.backbone.out_features, cfg.num_classes, cfg.head_filter_nums, cfg.head_filter_sizes,
                           last_pooling="average", act=cfg.act, generator=generator)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        feats = self.backbone(images)
        if isinstance(feats, tuple):
            feats = feats[-1]
        return self.head(feats)
