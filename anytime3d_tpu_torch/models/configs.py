"""Named model configs, one per reference experiment, each with its
training-loss values.

Counterpart of ``anytime3d_tpu/models/configs.py``: the same factories build
the port's own dataclasses, with the same values, and ``REGISTRY`` holds the
same 16 names (a test holds every config and loss config equal field by
field). ``variant(name)`` is the entry point for training.
"""

from __future__ import annotations

import dataclasses

from anytime3d_tpu_torch.models.mmvae import MMVAEConfig
from anytime3d_tpu_torch.nn.autoencoder3d import Decoder3DConfig, Encoder3DConfig
from anytime3d_tpu_torch.nn.heads import Head2DConfig
from anytime3d_tpu_torch.nn.priornet import PriorNetConfig


def _decoder64(input_dim: int) -> Decoder3DConfig:
    """The shared 64^3 voxel decoder, blocked tail."""
    return Decoder3DConfig(
        input_dim=input_dim,
        output_shape=(64, 64, 64, 1),
        filter_nums=(512, 256, 128, 64, 1),
        filter_sizes=(4, 4, 4, 4, 4),
        strides=(1, 2, 2, 2, 2),
        act="elu",
        final_act="sigmoid",
        tail_blocked=True,
    )


def _encoder3d(output_dim: int) -> Encoder3DConfig:
    """The shared 64^3 voxel encoder, blocked head."""
    return Encoder3DConfig(
        output_dim=output_dim,
        filter_nums=(64, 128, 256, 512),
        filter_sizes=(4, 4, 4, 4, 4),
        strides=(2, 2, 2, 2, 1),
        final_pool="average",
        act="elu",
        final_act="none",
        stem_space_to_depth=2,  # inert: the blocked head overrides it, as in the JAX model
        head_blocked=True,
    )


def modelnet_nolbo(z_dim: int = 64, category_dim: int = 40, latent_dropout: bool = False) -> MMVAEConfig:
    """NOLBO with a class prior on ModelNet: 64^3 voxels in and out, z=64, 40 classes."""
    return MMVAEConfig(
        z_category_dim=z_dim,
        z_inst_dim=0,
        category_dim=category_dim,
        encoder="voxel",
        encoder3d=_encoder3d(2 * z_dim),
        decoder=_decoder64(z_dim),
        prior_category=PriorNetConfig(input_dim=category_dim, unit_nums=(32, z_dim), const_log_var=0.0),
        variational=True,
        latent_dropout=latent_dropout,
    )


def modelnet_vae(z_dim: int = 64, latent_dropout: bool = False) -> MMVAEConfig:
    """A VAE with a standard-normal prior on ModelNet, 64^3 in and out."""
    return MMVAEConfig(
        z_category_dim=z_dim,
        z_inst_dim=0,
        encoder="voxel",
        encoder3d=_encoder3d(2 * z_dim),
        decoder=_decoder64(z_dim),
        variational=True,
        latent_dropout=latent_dropout,
    )


def modelnet_ae(z_dim: int = 64, latent_dropout: bool = False) -> MMVAEConfig:
    """A deterministic voxel autoencoder on ModelNet, 64^3 in and out."""
    return MMVAEConfig(
        z_category_dim=z_dim,
        z_inst_dim=0,
        encoder="voxel",
        encoder3d=_encoder3d(z_dim),
        decoder=_decoder64(z_dim),
        variational=False,
        latent_dropout=latent_dropout,
    )


def ae3d(z_dim: int = 16) -> MMVAEConfig:
    """The distributed voxel AE: ``modelnet_ae`` at z=16 (its input remap is
    in the loss config)."""
    return modelnet_ae(z_dim=z_dim)


def _pascal_head(output_dim: int) -> Head2DConfig:
    """The Pascal heads: a bare 1x1 projection and a global max-pool."""
    return Head2DConfig(output_dim=output_dim, filter_nums=(), filter_sizes=(), last_pooling="max")


def pascal_nolbo(z_dim: int = 16, category_dim: int = 12, inst_dim: int = 10,
                 backbone: str = "darknet19") -> MMVAEConfig:
    """Dual-latent NOLBO, image -> 64^3 shape: z = z_category (z_dim/2) +
    z_inst, a class prior on the category one-hot and an instance prior on
    the (category, instance) one-hots concatenated."""
    zc = z_dim // 2
    return MMVAEConfig(
        z_category_dim=zc,
        z_inst_dim=z_dim - zc,
        category_dim=category_dim,
        inst_dim=inst_dim,
        encoder="image",
        backbone=backbone,
        head=_pascal_head(2 * z_dim),
        decoder=_decoder64(z_dim),
        prior_category=PriorNetConfig(input_dim=category_dim, unit_nums=(32, zc), const_log_var=0.0),
        prior_inst=PriorNetConfig(input_dim=category_dim + inst_dim, unit_nums=(32, z_dim - zc),
                                  const_log_var=0.0),
        variational=True,
    )


def pascal_category(z_dim: int = 16, category_dim: int = 12, backbone: str = "darknet19") -> MMVAEConfig:
    """One category latent with a class prior, image -> 64^3 shape."""
    return MMVAEConfig(
        z_category_dim=z_dim,
        z_inst_dim=0,
        category_dim=category_dim,
        encoder="image",
        backbone=backbone,
        head=_pascal_head(2 * z_dim),
        decoder=_decoder64(z_dim),
        prior_category=PriorNetConfig(input_dim=category_dim, unit_nums=(32, z_dim), const_log_var=0.0),
        variational=True,
    )


def pascal_vae(z_dim: int = 16, backbone: str = "darknet19", latent_dropout: bool = False) -> MMVAEConfig:
    """An image VAE with a standard-normal prior, image -> 64^3 shape."""
    return MMVAEConfig(
        z_category_dim=z_dim,
        z_inst_dim=0,
        encoder="image",
        backbone=backbone,
        head=_pascal_head(2 * z_dim),
        decoder=_decoder64(z_dim),
        variational=True,
        latent_dropout=latent_dropout,
    )


def pascal_ae(z_dim: int = 16, backbone: str = "darknet19", latent_dropout: bool = False) -> MMVAEConfig:
    """A deterministic image autoencoder, image -> 64^3 shape."""
    return MMVAEConfig(
        z_category_dim=z_dim,
        z_inst_dim=0,
        encoder="image",
        backbone=backbone,
        head=_pascal_head(z_dim),
        decoder=_decoder64(z_dim),
        variational=False,
        latent_dropout=latent_dropout,
    )


def kitti_inst_only(z_dim: int = 16, inst_dim: int = 10, backbone: str = "darknet19") -> MMVAEConfig:
    """One instance latent with an instance prior (a single class), image ->
    64^3 shape."""
    return MMVAEConfig(
        z_category_dim=0,
        z_inst_dim=z_dim,
        inst_dim=inst_dim,
        encoder="image",
        backbone=backbone,
        head=_pascal_head(2 * z_dim),
        decoder=_decoder64(z_dim),
        prior_inst=PriorNetConfig(input_dim=inst_dim, unit_nums=(32, z_dim), const_log_var=0.0),
        variational=True,
    )


def _transpose_equiv(cfg: MMVAEConfig) -> MMVAEConfig:
    """``cfg`` with the shared decoder in its classic parameterization (k=4
    transposed convs to the end) under the phase lowering of its last stage."""
    return dataclasses.replace(
        cfg, decoder=dataclasses.replace(cfg.decoder, final_mode="transpose_equiv", tail_blocked=False))


def modelnet_nolbo_acc(z_dim: int = 64, category_dim: int = 40) -> MMVAEConfig:
    """``modelnet_nolbo`` with the classic decoder (``transpose_equiv``): the
    blocked encoder head, and the classic decoder's parameters, init and
    function, which keep the category accuracy the blocked tail costs."""
    return _transpose_equiv(modelnet_nolbo(z_dim=z_dim, category_dim=category_dim))


def pascal_nolbo_acc(**kw) -> MMVAEConfig:
    """``pascal_nolbo`` with the classic decoder (``transpose_equiv``)."""
    return _transpose_equiv(pascal_nolbo(**kw))


REGISTRY = {
    "modelnet_nolbo": modelnet_nolbo,
    "modelnet_nolbo_acc": modelnet_nolbo_acc,
    "modelnet_nolbo_dr": lambda: modelnet_nolbo(latent_dropout=True),
    "modelnet_vae": modelnet_vae,
    "modelnet_vae_dr": lambda: modelnet_vae(latent_dropout=True),
    "modelnet_ae": modelnet_ae,
    "modelnet_ae_dr": lambda: modelnet_ae(latent_dropout=True),
    "ae3d": ae3d,
    "pascal_nolbo": pascal_nolbo,
    "pascal_nolbo_acc": pascal_nolbo_acc,
    "pascal_category": pascal_category,
    "pascal_vae": pascal_vae,
    "pascal_vae_dr": lambda: pascal_vae(latent_dropout=True),
    "pascal_ae": pascal_ae,
    "pascal_ae_dr": lambda: pascal_ae(latent_dropout=True),
    "kitti_inst_only": kitti_inst_only,
}


def _loss_table():
    """Per-name ``LossConfig``, the values of the JAX package's table.

    - ``modelnet_nolbo``: one coin (p 0.5) then an elementwise prior mix at
      p 0.3; repulsion margin 2.0 * z; total = kl + shape + 0.01 * reg, no
      kernel L2.
    - ``pascal_nolbo``: coin then an elementwise mix at p 0.5; margins
      3.0 * z_cat and 3.0 * z_inst (the instance one gated to same-class
      pairs); total = kl + shape + reg + 5e-4 * kernel L2.
    - ``pascal_category``: coin then p 0.3; margin 3.0 * z; total = kl +
      shape + 0.01 * reg, no kernel L2.
    - ``kitti_inst_only``: the coin swaps the whole latent for the prior
      sample (element probability 1.0); margin 10.0 * z_inst; kernel L2
      5e-4.
    - the Pascal VAE and AE (and ``_dr``): shape (+ KL to N(0, I)) + 5e-4 *
      kernel L2; no priors, no mix. The ModelNet ones: the same with no L2.
    - ``ae3d``: shape alone, the encoder input remapped to 2x - 1."""
    from anytime3d_tpu_torch.train.step import LossConfig

    prior_img = LossConfig(
        reg_weight=1.0,
        reg_margin_scale_category=3.0,
        reg_margin_scale_inst=3.0,
        l2_weight=5e-4,
        mix_coin_prob=0.5,
        mix_element_prob=0.5,
    )
    pascal_cat = LossConfig(
        reg_weight=0.01,
        reg_margin_scale_category=3.0,
        l2_weight=0.0,
        mix_coin_prob=0.5,
        mix_element_prob=0.3,
    )

    modelnet_cat = LossConfig(
        reg_weight=0.01,
        reg_margin_scale_category=2.0,
        l2_weight=0.0,
        mix_coin_prob=0.5,
        mix_element_prob=0.3,
    )
    kitti = LossConfig(
        reg_weight=1.0,
        reg_margin_scale_inst=10.0,
        l2_weight=5e-4,
        mix_coin_prob=0.5,
        mix_element_prob=1.0,  # the whole vector
    )
    img_plain = LossConfig(l2_weight=5e-4)
    vox_plain = LossConfig(l2_weight=0.0)
    ae3d_loss = LossConfig(l2_weight=0.0, input_remap=True)
    return {
        "modelnet_nolbo": modelnet_cat,
        "modelnet_nolbo_acc": modelnet_cat,
        "modelnet_nolbo_dr": modelnet_cat,
        "modelnet_vae": vox_plain,
        "modelnet_vae_dr": vox_plain,
        "modelnet_ae": vox_plain,
        "modelnet_ae_dr": vox_plain,
        "ae3d": ae3d_loss,
        "pascal_nolbo": prior_img,
        "pascal_nolbo_acc": prior_img,
        "pascal_category": pascal_cat,
        "pascal_vae": img_plain,
        "pascal_vae_dr": img_plain,
        "pascal_ae": img_plain,
        "pascal_ae_dr": img_plain,
        "kitti_inst_only": kitti,
    }


def loss_config(name: str):
    """The ``LossConfig`` of a REGISTRY name."""
    return _loss_table()[name]


def variant(name: str, **overrides):
    """Everything needed to train ``name``: ``(MMVAEConfig, LossConfig)``.
    ``overrides`` go to the config factory: ``category_dim`` resizes the
    one-hots and the prior nets to a dataset's class count. A name whose
    factory takes no arguments (the ``_dr`` names) raises ``TypeError`` on
    any override."""
    cfg = REGISTRY[name](**overrides) if overrides else REGISTRY[name]()
    return cfg, loss_config(name)
