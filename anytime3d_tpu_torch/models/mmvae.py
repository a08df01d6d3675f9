"""MultiModalVAE: a voxel or image encoder, the shared Gaussian latent (one
block, or a category block and an instance block), label priors and the
voxel decoder.

Counterpart of ``anytime3d_tpu/models/mmvae.py:33-254``. ``MMVAEConfig``
mirrors the JAX config field by field; the module ports what serving and
training need: ``encode`` (the image or voxel encoder, posterior split,
log-var clipped to +-log_var_clip), ``decode``, ``priors_category``,
``priors_inst`` and the blocked-IO predicates. Submodule names
(``backbone``, ``head``, ``encoder3d``, ``decoder``, ``prior_category``,
``prior_inst``) are the flax ones, so converted checkpoints load by name.
A deterministic model (``variational=False``, the AE variants) encodes to
means alone: every ``log_var`` is None.

Parameters are created on the CPU from ``generator``; move the module with
``.to(device)``. For bfloat16 compute, training passes
``dtype=torch.bfloat16`` (float32 parameters, cast at use, as flax does);
serving may instead cast the whole module with ``.to(torch.bfloat16)``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn

from anytime3d_tpu_torch.nn.autoencoder3d import (
    Decoder3D,
    Decoder3DConfig,
    Encoder3D,
    Encoder3DConfig,
    decoder_final_equiv_active,
    decoder_tail_blocked_active,
    encoder_head_blocked_active,
)
from anytime3d_tpu_torch.nn.darknet import BACKBONES, Head2D
from anytime3d_tpu_torch.nn.heads import Head2DConfig
from anytime3d_tpu_torch.nn.priornet import PriorNet, PriorNetConfig
from anytime3d_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class MMVAEConfig:
    # latent layout
    z_category_dim: int = 0  # 0 => no category/instance split
    z_inst_dim: int = 16
    # label spaces (0 => modality absent)
    category_dim: int = 0
    inst_dim: int = 0
    # encoder modality
    encoder: str = "voxel"  # 'image' | 'voxel'
    backbone: str = "darknet19"
    head: Optional[Head2DConfig] = None
    encoder3d: Optional[Encoder3DConfig] = None
    decoder: Decoder3DConfig = dataclasses.field(default_factory=Decoder3DConfig)
    # priors: None => standard-normal prior (VAE) / no prior (AE)
    prior_category: Optional[PriorNetConfig] = None
    prior_inst: Optional[PriorNetConfig] = None
    # behavior flags
    variational: bool = True
    latent_dropout: bool = False  # the `_dr` variants: dropout on z at a random rate each train step
    log_var_clip: float = 10.0

    @property
    def z_dim(self) -> int:
        return self.z_category_dim + self.z_inst_dim

    @property
    def enc_output_dim(self) -> int:
        return (2 if self.variational else 1) * self.z_dim


@dataclasses.dataclass
class EncoderOutput:
    """Posterior blocks, each (B, dim); the log-vars are None for AE models."""

    mean_category: Optional[torch.Tensor]
    log_var_category: Optional[torch.Tensor]
    mean_inst: torch.Tensor
    log_var_inst: Optional[torch.Tensor]

    @property
    def mean(self) -> torch.Tensor:
        if self.mean_category is None:
            return self.mean_inst
        return torch.cat([self.mean_category, self.mean_inst], dim=-1)

    @property
    def log_var(self) -> Optional[torch.Tensor]:
        if self.log_var_inst is None:
            return None
        if self.log_var_category is None:
            return self.log_var_inst
        return torch.cat([self.log_var_category, self.log_var_inst], dim=-1)


def decoder_blocked_block(cfg: MMVAEConfig) -> Optional[int]:
    """Block size (4) when the decoder can emit the coarse depth-to-space(4)
    layout (``blocked_output``), else None: the blocked tail, or the phase
    lowering of a final transposed conv (``final_mode='transpose_equiv'``,
    whose phase output relays to the same layout), on a grid of whole blocks."""
    dec = cfg.decoder
    if not (decoder_tail_blocked_active(dec) or decoder_final_equiv_active(dec)):
        return None
    if any(s % 4 for s in dec.output_shape[:-1]):
        return None
    return 4


def blocked_io_block(cfg: MMVAEConfig) -> Optional[int]:
    """Block size (4) when the voxel round trip of ``cfg`` can stay in the
    coarse layout end to end (blocked-head encoder and blocked-tail decoder
    on the same grid), else None."""
    if cfg.encoder != "voxel" or cfg.encoder3d is None or not encoder_head_blocked_active(cfg.encoder3d):
        return None
    return decoder_blocked_block(cfg)


class MultiModalVAE(nn.Module):
    def __init__(self, config: MMVAEConfig, generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        """``dtype``: the compute dtype. Parameters stay float32 and are cast
        at use; inputs are cast on entry. None computes in the inputs' dtype."""
        super().__init__()
        cfg = config
        self.dtype = dtype
        self.config = cfg
        if cfg.encoder == "image":
            head_cfg = cfg.head or Head2DConfig(output_dim=cfg.enc_output_dim)
            self.backbone = BACKBONES[cfg.backbone](act=head_cfg.act, generator=generator, dtype=dtype)
            self.head = Head2D(self.backbone.out_features, head_cfg.output_dim, head_cfg.filter_nums,
                               head_cfg.filter_sizes, head_cfg.last_pooling, head_cfg.act, generator)
        else:
            enc_cfg = cfg.encoder3d or Encoder3DConfig(output_dim=cfg.enc_output_dim)
            self.encoder3d = Encoder3D(enc_cfg, in_channels=cfg.decoder.output_shape[-1], generator=generator,
                                       dtype=dtype, grid=tuple(cfg.decoder.output_shape[:3]))
        self.decoder = Decoder3D(cfg.decoder, generator=generator, dtype=dtype)
        self.prior_category = (
            PriorNet(cfg.prior_category, generator=generator, dtype=dtype)
            if cfg.prior_category is not None else None
        )
        self.prior_inst = (
            PriorNet(cfg.prior_inst, generator=generator, dtype=dtype) if cfg.prior_inst is not None else None
        )

    @property
    def blocked_io_block(self) -> Optional[int]:
        return blocked_io_block(self.config)

    @property
    def decoder_block(self) -> Optional[int]:
        """Block size (4) when the decoder alone can emit the coarse layout:
        image -> shape steps then run the voxel loss blocked."""
        return decoder_blocked_block(self.config)

    def encode(self, x: torch.Tensor, blocked_input: bool = False) -> EncoderOutput:
        """Images (B, H, W, 3) or voxels (B, D, H, W, C) -> posterior blocks
        (``blocked_input`` concerns voxels only). The flat encoder output is
        [mean_cat | log_var_cat | mean_inst | log_var_inst] with a category
        split, [mean | log_var] without; an AE model's is the means alone,
        [z_cat | z_inst] or z. Span: ``model.encode``."""
        with span("model.encode"):
            return self._encode(x, blocked_input)

    def _encode(self, x: torch.Tensor, blocked_input: bool) -> EncoderOutput:
        cfg = self.config
        if cfg.encoder == "image":
            feats = self.backbone(x)
            if isinstance(feats, tuple):
                feats = feats[-1]  # the multi-map backbones: the last map
            out = self.head(feats)
        else:
            out = self.encoder3d(x, blocked_input=blocked_input)
        clip = cfg.log_var_clip
        if not cfg.variational:
            if cfg.z_category_dim > 0:
                return EncoderOutput(out[..., :cfg.z_category_dim], None, out[..., cfg.z_category_dim:], None)
            return EncoderOutput(None, None, out, None)
        if cfg.z_category_dim > 0:
            zc, zi = cfg.z_category_dim, cfg.z_inst_dim
            return EncoderOutput(
                out[..., :zc],
                out[..., zc : 2 * zc].clamp(-clip, clip),
                out[..., 2 * zc : 2 * zc + zi],
                out[..., 2 * zc + zi :].clamp(-clip, clip),
            )
        zi = cfg.z_inst_dim
        return EncoderOutput(None, None, out[..., :zi], out[..., zi:].clamp(-clip, clip))

    def decode(self, z: torch.Tensor, blocked_output: bool = False) -> torch.Tensor:
        """Latents (B, z_dim) -> the decoder's output. Span: ``model.decode``."""
        with span("model.decode"):
            return self.decoder(z, blocked_output=blocked_output)

    def priors_category(self, category_onehot: torch.Tensor,
                        generator: Optional[torch.Generator] = None) -> tuple[torch.Tensor, torch.Tensor]:
        """Class prior (mean, log_var); dropout is on in train mode and draws from ``generator``."""
        return self.prior_category(category_onehot, generator)

    def priors_inst(self, inst_onehot: torch.Tensor,
                    generator: Optional[torch.Generator] = None) -> tuple[torch.Tensor, torch.Tensor]:
        """Instance prior (mean, log_var). In the dual-latent model its input
        is concat(category_onehot, inst_onehot); the caller concatenates."""
        return self.prior_inst(inst_onehot, generator)
